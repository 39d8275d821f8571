// Host build of the column-physics bodies (column_moist.cuh,
// column_longwave.cuh): the same per-column code the CUDA kernels K9 and
// K10 run, looped over the columns on the CPU.  It is not part of the
// kernel library; the CPU tests compile it with a host C++ compiler
//   g++ -O2 -ffp-contract=off -shared -fPIC column_host.cpp -o lib.so
// and hold it against the plain PyTorch versions, so that a logic error
// in a column body shows without a card.  The entry points take the
// arguments of the CUDA launchers less the device and the stream, and
// return 0, or 1 for a K that is not compiled.

#include "column_longwave.cuh"
#include "column_moist.cuh"

#define HOST_DISPATCH(CALL)                   \
  switch (K) {                                \
    case 5:                                   \
      if (is_double) CALL(double, 5)          \
      else CALL(float, 5)                     \
      break;                                  \
    case 7:                                   \
      if (is_double) CALL(double, 7)          \
      else CALL(float, 7)                     \
      break;                                  \
    case 8:                                   \
      if (is_double) CALL(double, 8)          \
      else CALL(float, 8)                     \
      break;                                  \
    default:                                  \
      return 1;                               \
  }

extern "C" int column_moist_host(int K, int is_double, const void* tg,
                                 const void* qg, const void* phig,
                                 const void* pslg, const void* blob, int G,
                                 void* out_f, void* out_i) {
#define CALL(T, KK)                                                        \
  {                                                                        \
    for (int c = 0; c < G; ++c)                                            \
      column_moist_at<T, KK>(c, G, (const T*)tg, (const T*)qg,             \
                             (const T*)phig, (const T*)pslg,               \
                             (const T*)blob, (T*)out_f, (long long*)out_i); \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

extern "C" int radlw_down_host(int K, int is_double, const void* ta,
                               const void* tau2, const void* blob, int G,
                               void* out) {
#define CALL(T, KK)                                                     \
  {                                                                     \
    for (int c = 0; c < G; ++c)                                         \
      radlw_down_at<T, KK>(c, G, (const T*)ta, (const T*)tau2,          \
                           (const T*)blob, (T*)out);                    \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

extern "C" int radlw_up_host(int K, int is_double, const void* ta,
                             const void* ts, const void* slrd,
                             const void* slru_sfc, const void* dfabs,
                             const void* flux_bands, const void* st4a_mean,
                             const void* st4a_grad, const void* tau2,
                             const void* stratc, const void* blob, int G,
                             void* out) {
#define CALL(T, KK)                                                        \
  {                                                                        \
    for (int c = 0; c < G; ++c)                                            \
      radlw_up_at<T, KK>(c, G, (const T*)ta, (const T*)ts, (const T*)slrd, \
                         (const T*)slru_sfc, (const T*)dfabs,              \
                         (const T*)flux_bands, (const T*)st4a_mean,        \
                         (const T*)st4a_grad, (const T*)tau2,              \
                         (const T*)stratc, (const T*)blob, (T*)out);       \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

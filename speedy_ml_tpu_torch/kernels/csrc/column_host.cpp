// Host build of the column-physics bodies (column_moist.cuh,
// column_longwave.cuh, column_surface.cuh, column_pbl.cuh,
// column_shortwave.cuh): the same per-column code the CUDA kernels K9,
// K10a_down_surface, K10b, K12 and K13 run, looped over the columns on
// the CPU, and K9's, K10a_down_surface's, K10b's and K12's blocks with
// their threads written out as loops.  It is not part of the
// kernel library; the CPU tests compile it with a host C++ compiler
//   g++ -O2 -ffp-contract=off -shared -fPIC column_host.cpp -o lib.so
// and hold it against the plain PyTorch versions, so that a logic error
// in a column body shows without a card.  The entry points take the
// arguments of the CUDA launchers less the device and the stream, and
// return 0, or 1 for a K that is not compiled.

#include <string.h>

#include <memory>

#include "column_longwave.cuh"
#include "column_moist.cuh"
#include "column_pbl.cuh"
#include "column_shortwave.cuh"
#include "column_surface.cuh"

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

// K9's block (the moist_block_* phases) with its threads written out as
// loops and its shared memory as an array whose every byte starts as
// 0xff (NaN), so that a phase reading what no earlier phase wrote shows;
// C = 32 columns a block, as the kernel's.
extern "C" int column_moist_block_host(int K, int is_double, const void* tg,
                                       const void* qg, const void* phig,
                                       const void* pslg, const void* blob,
                                       int G, void* out_f, void* out_i) {
  constexpr int C = 32;
#define CALL(T, KK)                                                         \
  {                                                                         \
    const MoistTab<T, KK> tb((const T*)blob);                               \
    const MoistIO<T> io = {(const T*)tg, (const T*)qg, (const T*)phig,      \
                           (const T*)pslg, G, (T*)out_f,                    \
                           (long long*)out_i};                              \
    std::unique_ptr<MoistShared<T, KK, C>> sh(new MoistShared<T, KK, C>);   \
    for (int b = 0; b * C < G; ++b) {                                       \
      memset(sh.get(), 0xff, sizeof *sh);                                   \
      for (int k = 0; k < KK; ++k)                                          \
        for (int x = 0; x < C; ++x)                                         \
          moist_block_levels(tb, io, *sh, b * C + x, x, k);                 \
      for (int x = 0; x < C; ++x)                                           \
        moist_block_convmf(tb, io, *sh, b * C + x, x);                      \
      for (int k = 0; k < KK; ++k)                                          \
        for (int x = 0; x < C; ++x)                                         \
          moist_block_lscond(tb, io, *sh, b * C + x, x, k);                 \
      for (int x = 0; x < C; ++x)                                           \
        moist_block_close(tb, io, *sh, b * C + x, x);                       \
    }                                                                       \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

// K10a_down_surface, K12 and K13 take their operands as an array of n_in
// pointers, in the order of the kernels' In structs; a wrong count
// returns 1 too.  down_surface_host runs the block's phases for one
// column at a time (down_surface_at, C = 1).
extern "C" int down_surface_host(int K, int is_double, const void* const* in,
                                 int n_in, const void* lw_blob,
                                 const void* sfc_blob, int G, int nlon,
                                 void* out) {
  if (n_in != DOWN_SURFACE_N_IN || nlon <= 0 || G % nlon != 0) return 1;
#define CALL(T, KK)                                                      \
  {                                                                      \
    const DownSurfaceIn<T> args = down_surface_in<T>(in);                \
    for (int c = 0; c < G; ++c)                                          \
      down_surface_at<T, KK>(c, G, nlon, args, (const T*)lw_blob,        \
                             (const T*)sfc_blob, (T*)out);               \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

// K10a_down_surface's block (the dnsfc_block_* phases) with its threads
// written out as loops and its shared memory and the surface warp's
// registers starting as NaN, as K9's above; C = 32 columns a block, as
// the kernel's, K level warps and the surface warp.
extern "C" int down_surface_block_host(int K, int is_double,
                                       const void* const* in, int n_in,
                                       const void* lw_blob,
                                       const void* sfc_blob, int G, int nlon,
                                       void* out) {
  if (n_in != DOWN_SURFACE_N_IN || nlon <= 0 || G % nlon != 0) return 1;
  constexpr int C = 32;
#define CALL(T, KK)                                                         \
  {                                                                         \
    const DownSurfaceIn<T> args = down_surface_in<T>(in);                   \
    const LongwaveTab<T, KK> tb((const T*)lw_blob);                         \
    const SurfaceTab<T> ts((const T*)sfc_blob);                             \
    std::unique_ptr<LwDownShared<T, KK, C>> sh(new LwDownShared<T, KK, C>); \
    std::unique_ptr<SfcReg<T>[]> r(new SfcReg<T>[C]);                       \
    for (int b = 0; b * C < G; ++b) {                                       \
      memset(sh.get(), 0xff, sizeof *sh);                                   \
      memset(r.get(), 0xff, sizeof(SfcReg<T>) * C);                         \
      for (int k = 0; k <= KK; ++k)                                         \
        for (int x = 0; x < C; ++x)                                         \
          dnsfc_block_load(tb, ts, G, nlon, args, (T*)out, *sh, r[x],       \
                           b * C + x, x, k);                                \
      for (int jb = 0; jb < 4; ++jb)                                        \
        for (int x = 0; x < C; ++x)                                         \
          dnsfc_block_band(G, (T*)out, *sh, b * C + x, x, jb);              \
      for (int k = 0; k <= KK; ++k)                                         \
        for (int x = 0; x < C; ++x)                                         \
          dnsfc_block_sums(tb, ts, G, (T*)out, *sh, r[x], b * C + x, x, k); \
    }                                                                       \
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

// K10b's block (the lwup_block_* phases) with its threads written out as
// loops and its shared memory starting as NaN, as K9's above; C = 32
// columns a block, as the kernel's.
extern "C" int radlw_up_block_host(int K, int is_double, const void* ta,
                                   const void* ts, const void* slrd,
                                   const void* slru_sfc, const void* dfabs,
                                   const void* flux_bands,
                                   const void* st4a_mean,
                                   const void* st4a_grad, const void* tau2,
                                   const void* stratc, const void* blob,
                                   int G, void* out) {
  constexpr int C = 32;
#define CALL(T, KK)                                                         \
  {                                                                         \
    const LongwaveTab<T, KK> tb((const T*)blob);                            \
    std::unique_ptr<LwUpShared<T, KK, C>> sh(new LwUpShared<T, KK, C>);     \
    std::unique_ptr<LwUpReg<T>[]> r(new LwUpReg<T>[KK * C]);                \
    for (int b = 0; b * C < G; ++b) {                                       \
      memset(sh.get(), 0xff, sizeof *sh);                                   \
      memset(r.get(), 0xff, sizeof(LwUpReg<T>) * KK * C);                   \
      for (int k = 0; k < KK; ++k)                                          \
        for (int x = 0; x < C; ++x)                                         \
          lwup_block_load(tb, G, (const T*)ta, (const T*)ts,                \
                          (const T*)slrd, (const T*)slru_sfc,               \
                          (const T*)dfabs, (const T*)flux_bands,            \
                          (const T*)st4a_mean, (const T*)st4a_grad,         \
                          (const T*)tau2, (const T*)stratc, *sh,            \
                          r[k * C + x], b * C + x, x, k);                   \
      for (int jb = 0; jb < 4; ++jb)                                        \
        for (int x = 0; x < C; ++x)                                         \
          lwup_block_band(G, *sh, b * C + x, x, jb);                        \
      for (int k = 0; k < KK; ++k)                                          \
        for (int x = 0; x < C; ++x)                                         \
          lwup_block_sums(tb, G, (T*)out, *sh, r[k * C + x], b * C + x, x,  \
                          k);                                               \
    }                                                                       \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

extern "C" int column_pbl_host(int K, int is_double, const void* const* in,
                               int n_in, const void* blob, int G,
                               void* out) {
  if (n_in != PBL_N_IN) return 1;
#define CALL(T, KK)                                                        \
  {                                                                        \
    const PblIn<T> args = pbl_in<T>(in);                                   \
    for (int c = 0; c < G; ++c)                                            \
      column_pbl_at<T, KK>(c, G, args, (const T*)blob, (T*)out);           \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

// K12's block (the pbl_block_* phases) with its threads written out as
// loops and its shared memory starting as NaN, as K9's above.
extern "C" int column_pbl_block_host(int K, int is_double,
                                     const void* const* in, int n_in,
                                     const void* blob, int G, void* out) {
  if (n_in != PBL_N_IN) return 1;
  constexpr int C = 32;
#define CALL(T, KK)                                                         \
  {                                                                         \
    const PblIn<T> args = pbl_in<T>(in);                                    \
    const PblTab<T, KK> tb((const T*)blob);                                 \
    std::unique_ptr<PblShared<T, KK, C>> sh(new PblShared<T, KK, C>);       \
    std::unique_ptr<PblReg<T>[]> r(new PblReg<T>[KK * C]);                  \
    for (int b = 0; b * C < G; ++b) {                                       \
      memset(sh.get(), 0xff, sizeof *sh);                                   \
      for (int k = 0; k < KK; ++k)                                          \
        for (int x = 0; x < C; ++x)                                         \
          pbl_block_load(tb, args, G, (T*)out, *sh, r[k * C + x], b * C + x, \
                         x, k);                                             \
      for (int x = 0; x < C; ++x)                                           \
        pbl_block_vdifsc(tb, G, *sh, r[x], b * C + x, x);                   \
      for (int k = 0; k < KK; ++k)                                          \
        for (int x = 0; x < C; ++x)                                         \
          pbl_block_sums(tb, G, (T*)out, *sh, r[k * C + x], b * C + x, x,   \
                         k);                                                \
    }                                                                       \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

extern "C" int column_shortwave_host(int K, int is_double,
                                     const void* const* in, int n_in,
                                     const void* blob, int G, void* out) {
  if (n_in != SHORTWAVE_N_IN) return 1;
#define CALL(T, KK)                                                        \
  {                                                                        \
    const ShortwaveIn<T> args = shortwave_in<T>(in);                       \
    for (int c = 0; c < G; ++c)                                            \
      column_shortwave_at<T, KK>(c, G, args, (const T*)blob, (T*)out);     \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

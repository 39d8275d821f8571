// K9: humidity, convection and large-scale condensation of one physics
// step, one thread per grid column (the body: column_moist.cuh).
//
// Replaces (JAX package) speedy_ml_tpu/physics/driver.py:192-216 with
// physics/humidity.py:12 qsat_from_t, physics/convection.py:19 convmf
// and physics/condensation.py:14 lscond.  In: tg, qg, phig (K, lat, lon),
// pslg (lat, lon).  Out: the clamped q, se, qsat, rh, ttend, qtend
// (K, lat, lon each), psg, rps, cbmf, precnv, precls (lat, lon each) in
// one buffer; itop, icnv (int64) in another.
//
// Bound on an H100 SXM: memory, and latency-sized.  At T30L8 a call
// reads 25 and writes 53 + 4 planes of 4,608 columns (~1.5 MB, 0.45 us
// at 3.35 TB/s) for some 0.5 MFLOP: one launch's latency is several
// times that.  Design: 4,608 threads in blocks of 32, so that the
// columns spread over all 132 SMs; each thread reads its column
// (coalesced across neighbouring columns), keeps the K levels in
// registers and writes its outputs once.  This source is compiled with
// -fmad=false: every operation is rounded apart, in the plain version's
// order, so that the convection's decisions fall as they do there.

#include "column_moist.cuh"
#include "common.cuh"

template <typename T, int K>
__global__ void column_moist_kernel(const T* __restrict__ tg,
                                    const T* __restrict__ qg,
                                    const T* __restrict__ phig,
                                    const T* __restrict__ pslg,
                                    const T* __restrict__ blob, int G,
                                    T* __restrict__ out_f,
                                    long long* __restrict__ out_i) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= G) return;
  column_moist_at<T, K>(c, G, tg, qg, phig, pslg, blob, out_f, out_i);
}

template <typename T, int K>
static void launch(const void* tg, const void* qg, const void* phig,
                   const void* pslg, const void* blob, int G, void* out_f,
                   void* out_i, cudaStream_t s) {
  const int block = 32;
  const unsigned grid = (unsigned)((G + block - 1) / block);
  column_moist_kernel<T, K><<<grid, block, 0, s>>>(
      (const T*)tg, (const T*)qg, (const T*)phig, (const T*)pslg,
      (const T*)blob, G, (T*)out_f, (long long*)out_i);
}

// K levels (5, 7 or 8); is_double selects the element type of every
// float operand (0: float, 1: double).  blob: MoistTables.blob.  out_f
// (6K + 5, G); out_i (2, G) int64.
SPEEDY_API int column_moist_launch(int device, int K, int is_double,
                                   const void* tg, const void* qg,
                                   const void* phig, const void* pslg,
                                   const void* blob, int G, void* out_f,
                                   void* out_i, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define MOIST_CASE(KK)                                                      \
  case KK:                                                                  \
    if (is_double)                                                          \
      launch<double, KK>(tg, qg, phig, pslg, blob, G, out_f, out_i, s);     \
    else                                                                    \
      launch<float, KK>(tg, qg, phig, pslg, blob, G, out_f, out_i, s);      \
    break;
  switch (K) {
    MOIST_CASE(5)
    MOIST_CASE(7)
    MOIST_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MOIST_CASE
  return (int)cudaGetLastError();
}

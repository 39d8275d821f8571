// K13: the clouds and the shortwave step, one thread per grid column
// (the body: column_shortwave.cuh).  It runs on the shortwave steps only
// (every third step); its outputs are the radiation carry of the steps
// in between.
//
// Replaces (JAX package) speedy_ml_tpu/physics/radiation.py:165 cloud,
// :201 radsw and the do_sw branch of physics/driver.py:221-238.  In: K9's
// q, rh, se, precnv, precls, itop, psg, rps; phig; the land fraction; the
// daily solar fields and the surface albedo.  Out: tau2 (K, 4, lat, lon),
// stratc (2, lat, lon), tt_rsw (K, lat, lon), ssrd, ssr, tsr (lat, lon)
// in one buffer.
//
// Bound on an H100 SXM: memory, and latency-sized.  At T30L8 a call
// reads 33 planes (q and rh at every level, se and phig at the lowest
// two, the 2-D fields, itop as two) and writes 45 planes of 4,608
// columns (~1.4 MB in float32, 0.43 us at 3.35 TB/s) for some 0.5 MFLOP
// and 45 exponentials a column: one launch's latency is several times
// that.  Design: 4,608 threads in blocks of 32, so that the columns
// spread over all 132 SMs; each thread keeps its column's levels, the
// transmissivities and the absorbed fluxes in registers, selects the
// levels at the cloud top inside unrolled loops (no indexed register
// array, so no stack frame) and writes tau2 straight into its
// (K, 4, lat, lon) layout.  This source is compiled with -fmad=false:
// every operation is rounded apart, in the plain version's order.

#include "column_shortwave.cuh"
#include "common.cuh"

template <typename T, int K>
__global__ void column_shortwave_kernel(ShortwaveIn<T> in,
                                        const T* __restrict__ blob, int G,
                                        T* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= G) return;
  column_shortwave_at<T, K>(c, G, in, blob, out);
}

template <typename T, int K>
static void launch(const void* const* in, const void* blob, int G, void* out,
                   cudaStream_t s) {
  const int block = 32;
  const unsigned grid = (unsigned)((G + block - 1) / block);
  column_shortwave_kernel<T, K><<<grid, block, 0, s>>>(
      shortwave_in<T>(in), (const T*)blob, G, (T*)out);
}

// K levels (5, 7 or 8); is_double selects the element type of every float
// operand (0: float, 1: double).  in: n_in device pointers in the order of
// ShortwaveIn; blob: ShortwaveTables.blob; out (5K + 5, G).
SPEEDY_API int column_shortwave_launch(int device, int K, int is_double,
                                       const void* const* in, int n_in,
                                       const void* blob, int G, void* out,
                                       void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || n_in != SHORTWAVE_N_IN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SHORTWAVE_CASE(KK)                        \
  case KK:                                        \
    if (is_double)                                \
      launch<double, KK>(in, blob, G, out, s);    \
    else                                          \
      launch<float, KK>(in, blob, G, out, s);     \
    break;
  switch (K) {
    SHORTWAVE_CASE(5)
    SHORTWAVE_CASE(7)
    SHORTWAVE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SHORTWAVE_CASE
  return (int)cudaGetLastError();
}

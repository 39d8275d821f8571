// K11: the surface fluxes of one physics step, one thread per grid
// column (the body: column_surface.cuh).
//
// Replaces (JAX package) speedy_ml_tpu/physics/surface.py:40 suflux.
// In: psg, the two lowest levels of ua, va, ta, qa (clamped, from K9),
// phi, the boundary, surface-state, radiation and albedo planes, and the
// cos(latitude) row.  Out: the 23 planes of SurfaceFluxes in one buffer.
//
// Bound on an H100 SXM: memory, and latency-sized.  At T30L8 a call
// reads 18 planes (6 of them levels of the level fields) and writes 23 of
// 4,608 columns (~0.76 MB in float32, 0.23 us at 3.35 TB/s) for some 0.5
// MFLOP: one launch's latency is ten times that.  Design: 4,608 threads
// in blocks of 32, so that the columns spread over all 132 SMs; each
// thread reads its column's values (coalesced across neighbouring
// columns), keeps everything in registers and writes its outputs once.  This source is compiled with -fmad=false:
// every operation is rounded apart, in the plain version's order, so that
// the stability and evaporation decisions fall as they do there.

#include "column_surface.cuh"
#include "common.cuh"

template <typename T, int K>
__global__ void surface_fluxes_kernel(SurfaceIn<T> in,
                                      const T* __restrict__ blob, int G,
                                      int nlon, T* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= G) return;
  surface_fluxes_at<T, K>(c, G, nlon, in, blob, out);
}

template <typename T, int K>
static void launch(const void* const* in, const void* blob, int G, int nlon,
                   void* out, cudaStream_t s) {
  const int block = 32;
  const unsigned grid = (unsigned)((G + block - 1) / block);
  surface_fluxes_kernel<T, K><<<grid, block, 0, s>>>(
      surface_in<T>(in), (const T*)blob, G, nlon, (T*)out);
}

// K levels (5, 7 or 8); is_double selects the element type of every
// operand (0: float, 1: double).  in: n_in device pointers in the order of
// SurfaceIn; blob: SurfaceTables.blob; out (23, G); G = nlat * nlon.
SPEEDY_API int surface_fluxes_launch(int device, int K, int is_double,
                                     const void* const* in, int n_in,
                                     const void* blob, int G, int nlon,
                                     void* out, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || nlon <= 0 || G % nlon != 0 || n_in != SURFACE_N_IN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SURFACE_CASE(KK)                                  \
  case KK:                                                \
    if (is_double)                                        \
      launch<double, KK>(in, blob, G, nlon, out, s);      \
    else                                                  \
      launch<float, KK>(in, blob, G, nlon, out, s);       \
    break;
  switch (K) {
    SURFACE_CASE(5)
    SURFACE_CASE(7)
    SURFACE_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SURFACE_CASE
  return (int)cudaGetLastError();
}

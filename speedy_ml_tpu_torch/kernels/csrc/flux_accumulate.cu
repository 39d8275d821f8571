// K16: the window's flux sums of one leapfrog step, one thread per grid
// point (the arithmetic: flux_accumulate.cuh).
//
// Replaces (JAX package) speedy_ml_tpu/gcm.py:273-280, the
// FluxAccumulator update of GCM.leapfrog.  In: the four running sums and
// five physics diagnostics of (lat, lon); out: four new sums.
//
// Bound on an H100 SXM: memory, and latency-sized: 13 fields of 4,608
// floats at T30 (0.24 MB, 0.07 us at 3.35 TB/s) for 11 FLOP a point.
// Design: blocks of 256 threads, every load coalesced, each operation
// rounded apart in the plain version's order (bit-identical to it).

#include "common.cuh"
#include "flux_accumulate.cuh"

constexpr int kFluxBlock = 256;

__global__ void __launch_bounds__(kFluxBlock)
    flux_accumulate_kernel(const FluxIO<float> io, long long G) {
  const long long i = (long long)blockIdx.x * kFluxBlock + threadIdx.x;
  if (i < G) flux_accumulate_at(io, i);
}

// acc: hflux_l, hflux_s, hflux_i, precip; diag: hflux_l, hflux_s,
// hflux_i, precnv, precls; out: the new hflux_l, hflux_s, hflux_i,
// precip; G float32 points each.
SPEEDY_API int flux_accumulate_launch(int device, long long G,
                                      const void* const* acc,
                                      const void* const* diag,
                                      void* const* out, float rsteps,
                                      float delt2, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0) return (int)cudaErrorInvalidValue;
  FluxIO<float> io;
  for (int f = 0; f < 4; ++f) {
    io.acc[f] = (const float*)acc[f];
    io.out[f] = (float*)out[f];
  }
  for (int f = 0; f < 5; ++f) io.diag[f] = (const float*)diag[f];
  io.rsteps = rsteps;
  io.delt2 = delt2;
  const unsigned grid = (unsigned)((G + kFluxBlock - 1) / kFluxBlock);
  flux_accumulate_kernel<<<grid, kFluxBlock, 0, (cudaStream_t)stream>>>(
      io, G);
  return (int)cudaGetLastError();
}

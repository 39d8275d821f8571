// K15: the spectral stacks that feed K6 (the dynamics stack of a step and
// the physics stack), one launch a step; a block per zonal wavenumber m,
// thread (n, k) on coefficient n of level k (the arithmetic and the
// block's phases: spectral_stack.cuh, which says what is computed).
//
// Replaces (JAX package) speedy_ml_tpu/core/spectral.py:340-364 uvspec
// and grad, speedy_ml_tpu/dycore/model.py:233 geopotential and the
// stacks of grid_tendencies (:258-280) and GCM._physics_fn
// (speedy_ml_tpu/gcm.py:222-234).  In: the state at two levels (33 field
// levels each at T30L8), phis.  Out: 50 + 41 fields of (31, 32) complex.
//
// Bound on an H100 SXM: memory, and latency-sized: ~0.53 MB read and
// ~0.72 MB written, 0.37 us at 3.35 TB/s, for ~0.1 MFLOP.  Design (a
// first one): 31 blocks of 32 x 8 threads; the threads of level k load
// level k of the row m (coalesced along n), store the copied fields at
// once and keep vor, div and t in shared memory, so that the n +- 1
// shifts of uvspec and the bottom-up sum of phi read shared memory; after
// one barrier each thread forms its outputs.  Every operation is rounded
// apart (no FMA contraction), in the plain version's order, so the kernel
// gives the plain version's values.

#include "common.cuh"
#include "spectral_stack.cuh"

template <int K>
__global__ void __launch_bounds__(STACK_MAX_N * 8)
    spectral_stack_kernel(const StackIO<float> io,
                          const float* __restrict__ blob) {
  __shared__ StackShared<float, K> sh;
  const StackTab<float, K> tb(blob, io.mx, io.nx);
  const int n = threadIdx.x, k = threadIdx.y, m = blockIdx.x;
  stack_block_load(io, sh, m, n, k);
  __syncthreads();
  stack_block_out(tb, io, sh, m, n, k);
}

// K levels (5, 7 or 8), one tracer, nx <= STACK_MAX_N.  vor, div, t (2, K,
// mx, nx), ps (2, mx, nx), tr (2, 1, K, mx, nx), phis (mx, nx) complex64;
// blob: 5 mx nx + mx + nx + 3K floats (stack_blob); dyn (6K + 2, mx, nx)
// at level jd and phy (5K + 1, mx, nx) at level jp, either null (then
// its level is not read); phis may be null without phy.
SPEEDY_API int spectral_stack_launch(int device, int K, int mx, int nx,
                                     const void* vor, const void* div,
                                     const void* tem, const void* ps,
                                     const void* tr, const void* phis,
                                     const void* blob, int jd, int jp,
                                     void* dyn, void* phy, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (mx <= 0 || nx <= 0 || nx > STACK_MAX_N || (!dyn && !phy) ||
      (dyn && jd != 0 && jd != 1) || (phy && (jp != 0 && jp != 1)) ||
      (phy && !phis))
    return (int)cudaErrorInvalidValue;
  StackIO<float> io;
  io.vor = (const stack_c<float>*)vor;
  io.div = (const stack_c<float>*)div;
  io.t = (const stack_c<float>*)tem;
  io.ps = (const stack_c<float>*)ps;
  io.tr = (const stack_c<float>*)tr;
  io.phis = (const stack_c<float>*)phis;
  io.dyn = (stack_c<float>*)dyn;
  io.phy = (stack_c<float>*)phy;
  io.jd = jd;
  io.jp = jp;
  io.mx = mx;
  io.nx = nx;
  cudaStream_t s = (cudaStream_t)stream;
  const float* b = (const float*)blob;
  switch (K) {
    case 5:
      spectral_stack_kernel<5><<<mx, dim3(nx, 5), 0, s>>>(io, b);
      break;
    case 7:
      spectral_stack_kernel<7><<<mx, dim3(nx, 7), 0, s>>>(io, b);
      break;
    case 8:
      spectral_stack_kernel<8><<<mx, dim3(nx, 8), 0, s>>>(io, b);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

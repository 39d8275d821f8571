// K15: the spectral stacks that feed K6 (the dynamics stack of a step and
// the physics stack), one launch a step; a warp per row (m, level k), lane
// n on coefficient n (the arithmetic and the lanes' phases:
// spectral_stack.cuh, which says what is computed).
//
// Replaces (JAX package) speedy_ml_tpu/core/spectral.py:340-364 uvspec
// and grad, speedy_ml_tpu/dycore/model.py:233 geopotential and the
// stacks of grid_tendencies (:258-280) and GCM._physics_fn
// (speedy_ml_tpu/gcm.py:222-234).  In: the state at two levels (33 field
// levels each at T30L8), phis.  Out: 50 + 41 fields of (31, 32) complex.
//
// Bound on an H100 SXM: memory, and latency-sized: ~0.53 MB read and
// ~0.72 MB written, 0.37 us at 3.35 TB/s, for ~0.1 MFLOP.  Design: 248
// warps at T30L8 (31 rows m x 8 levels), kStackWarps to a block, with no
// shared memory and no barrier (of 1, 2, 4 and 8 warps a block, 2 and 4
// ran fastest inside the window on an H100, within 1% of each other; a
// block per m sharing the t values through shared memory behind one
// barrier ran slower: PERF.md).  Each lane
// issues every load it needs before its first operation (the state, the
// tables at (m, n), phis and the t values of the levels below it that
// its phi sum reads, re-read from L2 by each level's warp), so their
// latencies overlap; the n +- 1 neighbours of uvspec and grad come
// through __shfl_up_sync and __shfl_down_sync.  Every operation is
// rounded apart (no FMA contraction), in the plain version's order, so
// the kernel gives the plain version's values.

#include "common.cuh"
#include "spectral_stack.cuh"

// warps a block
constexpr int kStackWarps = 4;

template <int K>
__global__ void __launch_bounds__(32 * kStackWarps)
    spectral_stack_kernel(const StackIO<float> io,
                          const float* __restrict__ blob) {
  const int w = blockIdx.x * kStackWarps + threadIdx.y;
  const int m = w / K, k = w - m * K, n = threadIdx.x;
  // a warp leaves whole; the exchanges name all of its lanes
  if (m >= io.mx) return;
  const StackTab<float, K> tb(blob, io.mx, io.nx);
  StackLane<float, K> L;
  stack_lane_load(L, io, tb, m, n, k);
  StackNb<float> nb;
  auto xch = [&](stack_c<float> StackLane<float, K>::*f, int d) {
    const stack_c<float> v = L.*f;
    stack_c<float> r;
    if (d < 0) {
      r.x = __shfl_up_sync(0xffffffffu, v.x, 1);
      r.y = __shfl_up_sync(0xffffffffu, v.y, 1);
    } else {
      r.x = __shfl_down_sync(0xffffffffu, v.x, 1);
      r.y = __shfl_down_sync(0xffffffffu, v.y, 1);
    }
    return r;
  };
  stack_exchange(L, io, xch, nb);
  stack_lane_out(L, nb, io);
}

// K levels (5, 7 or 8), one tracer, nx <= STACK_MAX_N.  vor, div, t (2, K,
// mx, nx), ps (2, mx, nx), tr (2, 1, K, mx, nx), phis (mx, nx) complex64;
// blob: 5 mx nx + mx + nx + 3K floats (stack_blob); dyn (6K + 2, mx, nx)
// at level jd and phy (5K + 1, mx, nx) at level jp, either null (then
// its level is not read); phis may be null without phy.  m0: the
// wavenumber of row 0 (0, or a shard's first; the blob is its range's).
SPEEDY_API int spectral_stack_launch(int device, int K, int mx, int nx,
                                     const void* vor, const void* div,
                                     const void* tem, const void* ps,
                                     const void* tr, const void* phis,
                                     const void* blob, int jd, int jp,
                                     void* dyn, void* phy, int m0,
                                     void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (mx <= 0 || nx <= 0 || nx > STACK_MAX_N || (!dyn && !phy) ||
      (dyn && jd != 0 && jd != 1) || (phy && (jp != 0 && jp != 1)) ||
      (phy && !phis) || m0 < 0)
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
  io.m0 = m0;
  cudaStream_t s = (cudaStream_t)stream;
  const float* b = (const float*)blob;
  const dim3 block(32, kStackWarps);
  const unsigned grid =
      (unsigned)((mx * K + kStackWarps - 1) / kStackWarps);
  switch (K) {
    case 5:
      spectral_stack_kernel<5><<<grid, block, 0, s>>>(io, b);
      break;
    case 7:
      spectral_stack_kernel<7><<<grid, block, 0, s>>>(io, b);
      break;
    case 8:
      spectral_stack_kernel<8><<<grid, block, 0, s>>>(io, b);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K8: the spectral tail of one dycore step, a group of 8 lanes per
// spectral coefficient (m, n), lane k on level k (the arithmetic:
// spectral_tail.cuh).
//
// Replaces (JAX package) speedy_ml_tpu/dycore/model.py: the vds/lap sums
// of to_spectral_tendencies (:371-383), :386 sptend (with :233
// geopotential), :419 implicit_correction, :443 _hordif with the
// orographic corrections, the drag and the top-level del^2 (:517-550),
// and :446 _timint (trunct, leapfrog, Robert-Asselin-Williams filter),
// in the order of step (:505-562).  Input A (1 + 9K, mx, nx) complex:
//   [psdt; ke (K), ttend (K), qtend (K);
//    utend, -u(T-tref), -u q (K each); vtend, -v(T-tref), -v q (K each)]
// the K5 analysis of K7's stack (u/v stacks already times 1/cos).
// Output: the new vor, div, t, ps, tr, both leapfrog levels.
//
// Bound on an H100 SXM: memory, latency-sized.  At T30L8 a call reads
// ~0.45 MB (A, the state, the tables) and writes 0.25 MB (0.2 us at 3.35
// TB/s) for ~0.5 MFLOP: one launch's latency is several times that.
// Design: 7,936 threads (992 coefficients x 8 lanes) in blocks of
// kTailBlock, so that the work spreads over the SMs; a lane keeps only its
// level's values, reads its operands, its state and its xj row before the
// first exchange (their latency overlaps one another; the tables are read
// through L1 where they are used), and the three level mixes and two
// vertical scans read the group's values through __shfl_sync (five
// exchanges, one value a level each).  Loads and stores of a warp cover 4 neighbouring
// coefficients of 8 levels: 8 full 32-byte sectors.  The semi-implicit
// inverse is read once per total wavenumber (a lane reads its 32-byte row
// as two 16-byte loads) instead of one 8x8 copy per coefficient.

#include "common.cuh"
#include "spectral_tail.cuh"

// threads a block (a multiple of 32): 8 coefficients, 124 blocks at T30
// (the fastest of 32, 64, 128 and 256 on an H100)
constexpr int kTailBlock = 64;

template <int K>
__device__ __forceinline__ void tail_gather(tail_c<float> v,
                                            tail_c<float> (&g)[K],
                                            unsigned mask) {
#pragma unroll
  for (int l = 0; l < K; ++l) {
    g[l].x = __shfl_sync(mask, v.x, l, TAIL_GROUP);
    g[l].y = __shfl_sync(mask, v.y, l, TAIL_GROUP);
  }
}

template <int K, bool CG>
__global__ void __launch_bounds__(kTailBlock)
    spectral_tail_kernel(const TailIO<float> io,
                         const float* __restrict__ blob) {
  const int t = blockIdx.x * kTailBlock + threadIdx.x;
  const int idx = t / TAIL_GROUP, lane = t % TAIL_GROUP;
  // a group's 8 lanes leave together; the exchanges name only them
  if (idx >= io.mx * io.nx) return;
  const unsigned mask = 0xffu << (threadIdx.x & 24);
  const TailTab<float, K> tb(blob, io.mx, io.nx, io.m0);
  TailLane<float, K> L;
  tail_load(L, io, tb, idx, lane);
  tail_c<float> g[K], h[K];
  tail_gather(L.dv, g, mask);
  tail_gather(L.ts, h, mask);
  tail_vertical(L, io, tb, g, h);
  if (io.implicit) {
    tail_gather(L.tdt, g, mask);
    tail_ye(L, tb, g);
    tail_gather(L.yf, g, mask);
    tail_xj(L, g);
    tail_gather(L.divdt, g, mask);
  }
  tail_finish<float, K, CG>(L, io, tb, g);
}

// K levels (5, 7 or 8), one tracer.  A (1 + 9K, mx, nx), vor/div/t
// (2, K, mx, nx), ps (2, mx, nx), tr (2, 1, K, mx, nx), phis/tcorh/qcorh
// (mx, nx), all complex64 (tcorh/qcorh may be null); blob: the f32 tables
// (tail_blob, 16-byte aligned); outputs shaped as the state.  cg: the
// tendency form (cgrate_on): vor's and div's diffused tendencies go to
// level 0 of o_vor and o_div, whose leapfrog K26 runs.  m0: the
// wavenumber of row 0 (0, or a shard's first; the blob is its range's).
SPEEDY_API int spectral_tail_launch(
    int device, int K, int mx, int nx, const void* A, const void* vor,
    const void* div, const void* tem, const void* ps, const void* tr,
    const void* phis, const void* tcorh, const void* qcorh, const void* blob,
    int j1, int j4, int implicit, int trunc, float dt, float ew1, float ew2,
    float sdrag, float rgas, void* o_vor, void* o_div, void* o_t, void* o_ps,
    void* o_tr, int cg, int m0, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (mx <= 0 || nx <= 0 || (j1 != 1 && j1 != 2) || (j4 != 0 && j4 != 1) ||
      ((size_t)blob & 15) != 0 || m0 < 0)
    return (int)cudaErrorInvalidValue;
  TailIO<float> io =
      tail_io<float>(mx, nx, A, vor, div, tem, ps, tr, phis, tcorh, qcorh, j1,
                     j4, implicit, trunc, dt, ew1, ew2, sdrag, rgas, o_vor,
                     o_div, o_t, o_ps, o_tr);
  io.m0 = m0;
  const long long threads = (long long)mx * nx * TAIL_GROUP;
  const unsigned grid = (unsigned)((threads + kTailBlock - 1) / kTailBlock);
  cudaStream_t s = (cudaStream_t)stream;
  const float* b = (const float*)blob;
#define TAIL_LAUNCH(KK)                                                \
  if (cg)                                                              \
    spectral_tail_kernel<KK, true><<<grid, kTailBlock, 0, s>>>(io, b); \
  else                                                                 \
    spectral_tail_kernel<KK, false><<<grid, kTailBlock, 0, s>>>(io, b);
  switch (K) {
    case 5:
      TAIL_LAUNCH(5)
      break;
    case 7:
      TAIL_LAUNCH(7)
      break;
    case 8:
      TAIL_LAUNCH(8)
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TAIL_LAUNCH
  return (int)cudaGetLastError();
}

// K7: grid-point dynamics of one step; a block of kGridCols neighbouring
// columns x K levels, thread (x, k) on level k of column x (the
// arithmetic and the block's phases: grid_dynamics.cuh, which says what
// is computed).
//
// Replaces (JAX package) speedy_ml_tpu/dycore/model.py:258
// grid_tendencies after its inverse transform (:290-350), the physics
// sum of step (:500-503) and the products of to_spectral_tendencies
// (:365-379).  In: gall (6K + 2, lat, lon), the physics tendencies
// (K, lat, lon each, optional).  Out: (1 + 9K, lat, lon), the stack K5
// transforms.
//
// Bound on an H100 SXM: memory, and latency-sized: at T30L8 a call reads
// 50 + 32 fields and writes 73 of 4,608 columns (~2.9 MB, 0.9 us at
// 3.35 TB/s) for ~0.6 MFLOP.  Design: 288 blocks of 16 columns x 8
// levels, so that every SM has work.  The threads of level k load level k
// of the six fields and of the physics tendencies (coalesced across the
// 16 columns, all loads issued at once), those of level 0 form the
// column sums from shared memory, then the threads of level k form the
// fluxes on the half levels above and below it and store its nine
// outputs.  Of 8, 16, 32 and 64 columns a block, 16 ran fastest on an
// H100 (K12, of 8, 16 and 32, at 32).  Every operation is rounded apart
// (no FMA contraction), in the order of the plain version, so the two
// agree to a few ulps; the first design (one thread per column) gave the
// same bits.

#include "common.cuh"
#include "grid_dynamics.cuh"

// columns a block (half a warp: a warp holds two levels)
constexpr int kGridCols = 16;

template <int K>
__global__ void __launch_bounds__(kGridCols * 8)
    grid_dynamics_kernel(const GridIO<float> io, const float* __restrict__ blob,
                         float rgas, float akap, int nlat) {
  __shared__ GridShared<float, K, kGridCols> sh;
  const GridTab<float, K> tb(blob, nlat, rgas, akap);
  const int x = threadIdx.x, k = threadIdx.y;
  const int c = blockIdx.x * kGridCols + x;
  GridReg<float> r;
  grid_block_load(io, sh, r, c, x, k);
  __syncthreads();
  if (k == 0) grid_block_sums(tb, io, sh, c, x);
  __syncthreads();
  grid_block_level(tb, io, sh, r, c, x, k);
}

// K levels (5, 7 or 8), one tracer.  gall (6K + 2, lat, lon); pu/pv/pt/pq
// (K, lat, lon) each, all null for the dry core; blob: coriol (lat),
// dhs, dhsr, fsgr, tref, tref3 (K each); out (1 + 9K, lat, lon).
SPEEDY_API int grid_dynamics_launch(int device, int K, const void* gall,
                                    const void* pu, const void* pv,
                                    const void* pt, const void* pq,
                                    const void* blob, float rgas, float akap,
                                    int nlat, int nlon, void* out,
                                    void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  const bool some = pu || pv || pt || pq;
  const bool all = pu && pv && pt && pq;
  if (nlat <= 0 || nlon <= 0 || (some && !all))
    return (int)cudaErrorInvalidValue;
  GridIO<float> io;
  io.gall = (const float*)gall;
  io.pu = (const float*)pu;
  io.pv = (const float*)pv;
  io.pt = (const float*)pt;
  io.pq = (const float*)pq;
  io.nlon = nlon;
  io.G = nlat * nlon;
  io.out = (float*)out;
  const unsigned grid = (unsigned)((io.G + kGridCols - 1) / kGridCols);
  cudaStream_t s = (cudaStream_t)stream;
  const float* b = (const float*)blob;
  switch (K) {
    case 5:
      grid_dynamics_kernel<5><<<grid, dim3(kGridCols, 5), 0, s>>>(
          io, b, rgas, akap, nlat);
      break;
    case 7:
      grid_dynamics_kernel<7><<<grid, dim3(kGridCols, 7), 0, s>>>(
          io, b, rgas, akap, nlat);
      break;
    case 8:
      grid_dynamics_kernel<8><<<grid, dim3(kGridCols, 8), 0, s>>>(
          io, b, rgas, akap, nlat);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

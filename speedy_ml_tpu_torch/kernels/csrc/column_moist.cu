// K9: humidity, convection and large-scale condensation of one physics
// step; a block of kMoistCols neighbouring columns x K warps, warp k on
// level k (the arithmetic and the block's phases: column_moist.cuh).
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
// times that.  Design: 144 blocks of 32 columns x 8 levels.  The work of
// a level (the loads, expf and the divisions of qsat, lscond, the
// stores) runs on its own warp, coalesced across the 32 columns; only
// convmf's climb up the column runs on one warp, from shared memory.
// This source is compiled with -fmad=false: every operation is rounded
// apart, in the plain version's order, so that the convection's
// decisions fall as they do there.

#include "column_moist.cuh"
#include "common.cuh"

// columns a block (one warp wide)
constexpr int kMoistCols = 32;

template <typename T, int K>
__global__ void __launch_bounds__(kMoistCols * 8)
    column_moist_kernel(const MoistIO<T> io, const T* __restrict__ blob) {
  __shared__ MoistShared<T, K, kMoistCols> sh;
  const MoistTab<T, K> tb(blob);
  const int x = threadIdx.x, k = threadIdx.y;
  const int c = blockIdx.x * kMoistCols + x;
  moist_block_levels(tb, io, sh, c, x, k);
  __syncthreads();
  if (k == 0) moist_block_convmf(tb, io, sh, c, x);
  __syncthreads();
  moist_block_lscond(tb, io, sh, c, x, k);
  __syncthreads();
  if (k == 0) moist_block_close(tb, io, sh, c, x);
}

template <typename T, int K>
static void launch(const void* tg, const void* qg, const void* phig,
                   const void* pslg, const void* blob, int G, void* out_f,
                   void* out_i, cudaStream_t s) {
  MoistIO<T> io;
  io.tg = (const T*)tg;
  io.qg = (const T*)qg;
  io.phig = (const T*)phig;
  io.pslg = (const T*)pslg;
  io.G = G;
  io.out_f = (T*)out_f;
  io.out_i = (long long*)out_i;
  const unsigned grid = (unsigned)((G + kMoistCols - 1) / kMoistCols);
  column_moist_kernel<T, K><<<grid, dim3(kMoistCols, K), 0, s>>>(
      io, (const T*)blob);
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

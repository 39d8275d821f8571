// K9 and K9_moist_shortwave: humidity, convection and large-scale
// condensation of one physics step, and on the shortwave steps (every
// third) the clouds and the shortwave in the same launch; a block of
// kMoistCols neighbouring columns x K warps, warp k on level k (the
// arithmetic and the block's phases: column_moist.cuh, and
// column_shortwave.cuh for the shortwave's).
//
// Replaces (JAX package) speedy_ml_tpu/physics/driver.py:192-216 with
// physics/humidity.py:12 qsat_from_t, physics/convection.py:19 convmf
// and physics/condensation.py:14 lscond; K9_moist_shortwave also
// physics/radiation.py:165 cloud, :201 radsw and the do_sw branch of
// physics/driver.py:221-238.  In: tg, qg, phig (K, lat, lon), pslg
// (lat, lon); for the shortwave the land fraction, the daily solar
// fields and the surface albedo (lat, lon each).  Out: the clamped q, se,
// qsat, rh, ttend, qtend (K, lat, lon each), psg, rps, cbmf, precnv,
// precls (lat, lon each) in one buffer; itop, icnv (int64) in another;
// the shortwave's tau2 (K, 4, lat, lon), stratc (2, lat, lon), tt_rsw
// (K, lat, lon), ssrd, ssr, tsr (lat, lon) in a third.
//
// Bound on an H100 SXM: memory, and latency-sized.  At T30L8 K9 reads 25
// and writes 53 + 4 planes of 4,608 columns (~1.5 MB, 0.45 us at 3.35
// TB/s) for some 0.5 MFLOP; K9_moist_shortwave reads 7 planes more and
// writes 5K + 5 = 45 more (134 planes, ~2.5 MB, 0.74 us) for 45
// exponentials a column more: one launch's latency is several times
// that.  Design: 144 blocks of 32 columns x 8 levels.  The work of a
// level (the loads, expf and the divisions of qsat, lscond, the stores;
// the shortwave's transmissivities, its exponentials and the stores of
// tau2) runs on its own warp, coalesced across the 32 columns; only
// convmf's climb up the column, the clouds and the shortwave fluxes down
// and up run on one warp, from shared memory.  The first design of the
// shortwave (K13, a thread per column, a launch of its own) ran its 45
// exponentials and both recursions one after another.  This source is
// compiled with -fmad=false: every operation is rounded apart, in the
// plain version's order, so that the convection's decisions fall as they
// do there.

#include "column_moist.cuh"
#include "column_shortwave.cuh"
#include "common.cuh"

// columns a block (one warp wide)
constexpr int kMoistCols = 32;

// The block's phases.  kShortwave = false: K9's four phases alone (sw,
// sw_blob and sws unused).  kShortwave = true: the plane loads first,
// rh and phig's lowest levels kept in phase 1, then after K9's close on
// warp 0 the clouds (phase 5), every level's transmissivities and tau2
// (phase 6), the fluxes on warp 0 (phase 7).
template <typename T, int K, bool kShortwave>
__device__ __forceinline__ void moist_block(
    const MoistIO<T>& io, const T* __restrict__ blob, const SwIO<T>& sw,
    const T* __restrict__ sw_blob, MoistShared<T, K, kMoistCols>& sh,
    SwShared<T, K, kMoistCols>* sws) {
  const MoistTab<T, K> tb(blob);
  const int x = threadIdx.x, k = threadIdx.y;
  const int c = blockIdx.x * kMoistCols + x;
  SwReg<T> r;
  if constexpr (kShortwave) sw_block_start(io, sw, r, c, k);
  const T rh = moist_block_levels(tb, io, sh, c, x, k);
  if constexpr (kShortwave) sw_block_keep(io, *sws, rh, c, x, k);
  __syncthreads();
  if (k == 0) moist_block_convmf(tb, io, sh, c, x);
  __syncthreads();
  moist_block_lscond(tb, io, sh, c, x, k);
  __syncthreads();
  if (k == 0) moist_block_close(tb, io, sh, c, x, r.itop, r.precls);
  if constexpr (kShortwave) {
    const ShortwaveTab<T, K> ts(sw_blob);
    if (k == 0) sw_block_cloud(ts, io, sh, *sws, r, c, x);
    __syncthreads();
    sw_block_level(ts, io, sw, sh, *sws, r, c, x, k);
    __syncthreads();
    if (k == 0) sw_block_fluxes(ts, io, sw, *sws, r, c, x);
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kMoistCols * 8)
    column_moist_kernel(const MoistIO<T> io, const T* __restrict__ blob) {
  __shared__ MoistShared<T, K, kMoistCols> sh;
  moist_block<T, K, false>(io, blob, SwIO<T>(), nullptr, sh, nullptr);
}

template <typename T, int K>
__global__ void __launch_bounds__(kMoistCols * 8)
    moist_shortwave_kernel(const MoistIO<T> io, const T* __restrict__ blob,
                           const SwIO<T> sw, const T* __restrict__ sw_blob) {
  __shared__ MoistShared<T, K, kMoistCols> sh;
  __shared__ SwShared<T, K, kMoistCols> sws;
  moist_block<T, K, true>(io, blob, sw, sw_blob, sh, &sws);
}

template <typename T, int K>
static void launch(const void* tg, const void* qg, const void* phig,
                   const void* pslg, const void* blob, int G, void* out_f,
                   void* out_i, const void* const* sw_in, const void* sw_blob,
                   void* sw_out, cudaStream_t s) {
  MoistIO<T> io;
  io.tg = (const T*)tg;
  io.qg = (const T*)qg;
  io.phig = (const T*)phig;
  io.pslg = (const T*)pslg;
  io.G = G;
  io.out_f = (T*)out_f;
  io.out_i = (long long*)out_i;
  const unsigned grid = (unsigned)((G + kMoistCols - 1) / kMoistCols);
  const dim3 block(kMoistCols, K);
  if (sw_in == nullptr)
    column_moist_kernel<T, K><<<grid, block, 0, s>>>(io, (const T*)blob);
  else
    moist_shortwave_kernel<T, K><<<grid, block, 0, s>>>(
        io, (const T*)blob, sw_io<T>(sw_in, sw_out), (const T*)sw_blob);
}

// K levels (5, 7 or 8); is_double selects the element type of every
// float operand (0: float, 1: double).  blob: MoistTables.blob.  out_f
// (6K + 5, G); out_i (2, G) int64.  shortwave 0: K9 (sw_in, n_sw,
// sw_blob, sw_out unused); 1: K9_moist_shortwave, sw_in the n_sw =
// SW_N_PLANES device pointers in the order of SwIO, sw_blob
// ShortwaveTables.blob, sw_out (5K + 5, G).
SPEEDY_API int column_moist_launch(int device, int K, int is_double,
                                   const void* tg, const void* qg,
                                   const void* phig, const void* pslg,
                                   const void* blob, int G, void* out_f,
                                   void* out_i, int shortwave,
                                   const void* const* sw_in, int n_sw,
                                   const void* sw_blob, void* sw_out,
                                   void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0) return (int)cudaErrorInvalidValue;
  if (shortwave && (n_sw != SW_N_PLANES || sw_in == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!shortwave) sw_in = nullptr;
  cudaStream_t s = (cudaStream_t)stream;
#define MOIST_CASE(KK)                                                  \
  case KK:                                                              \
    if (is_double)                                                      \
      launch<double, KK>(tg, qg, phig, pslg, blob, G, out_f, out_i,     \
                         sw_in, sw_blob, sw_out, s);                    \
    else                                                                \
      launch<float, KK>(tg, qg, phig, pslg, blob, G, out_f, out_i,      \
                        sw_in, sw_blob, sw_out, s);                     \
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

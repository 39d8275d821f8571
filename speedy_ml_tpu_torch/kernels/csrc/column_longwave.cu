// K10: the 4-band longwave radiation of one step, as two kernels (the
// bodies: column_longwave.cuh): the downward pass fused with K11's
// surface fluxes (K10a_down_surface, column_surface.cuh), and the upward
// pass after them (K10b).
//
// Replaces (JAX package) speedy_ml_tpu/physics/radiation.py:318
// radlw_down, :381 radlw_up and :38 _fband_lookup, and
// physics/surface.py:40 suflux.
// Down + surface.  In: the 18 operands of DownSurfaceIn (ta, tau2 and the
//   surface fluxes' level fields, planes and cos(latitude) row).  Out, one
//   buffer: slrd, dfabs (K), flux_bands (4), st4a_mean (K), st4a_grad
//   (K), then the 23 planes of SurfaceFluxes.
// Up.  In: ta, ts, slrd, slru_sfc, dfabs, flux_bands, st4a_mean,
//   st4a_grad, tau2, stratc (2, lat, lon).  Out, one buffer: slr, olr,
//   dfabs (K).
//
// Bound on an H100 SXM: memory, and latency-sized.  At T30L8 the
// downward pass with the surface fluxes reads 53 planes (tau2 of level 0
// in bands 0 and 1 only) and writes 52 of 4,608 columns (~1.9 MB, 0.58
// us at 3.35 TB/s), the upward pass reads 73 and writes 10 (~1.5 MB):
// one launch's latency is several times either.  Both are K12's shape,
// 144 blocks of kLwCols columns x K warps (the downward pass one warp
// more; of 8, 16 and 32 columns a block, 32 ran K10b fastest inside the
// window on an H100: PERF.md).  Down: warp k reads level k of ta (and its
// neighbours) and tau2, forms the Planck terms and the four band terms
// of level k into shared memory; after a barrier of the level warps
// alone, warps 0-3 run the four band recursions down the column, one
// band each.  An extra warp runs the surface fluxes from the start: their
// loads and every step that does not need slrd (the longest chain of
// dependent operations in the kernel: three saturation humidities, a
// power, two square roots and a division) overlap the whole longwave
// pass, and after the block's barrier the surface warp forms slrd and
// finishes with the Newton step of the skin temperature while warp k
// forms and stores dfabs of level k.  One launch a physics step where
// the first designs (a thread a column, blocks of one warp) took two.
// Up: warp k loads level k of its eight level planes (coalesced across
// the columns, every load issued at once) into shared memory and
// evaluates the band fractions at ta[k], warp 0 the surface planes;
// warps 0-3 then run the four band recursions up the column from shared
// memory, one band each; warp k forms and stores dfabs of level k.  This
// source is compiled with -fmad=false: every operation is rounded apart,
// in the plain version's order, so that the surface fluxes' stability
// and evaporation decisions fall as they do there.

#include "column_longwave.cuh"
#include "common.cuh"

// columns a K10a_down_surface or K10b block (one warp wide)
constexpr int kLwCols = 32;

// The barrier of K10a_down_surface's level warps alone (named barrier 1,
// K warps): the surface warp does not wait on it.
template <int K>
__device__ __forceinline__ void level_warps_sync() {
  asm volatile("bar.sync 1, %0;" : : "r"(K * kLwCols) : "memory");
}

// K level warps and the surface warp (threadIdx.y = K)
template <typename T, int K>
__global__ void __launch_bounds__(kLwCols * 9) down_surface_kernel(
    DownSurfaceIn<T> in, const T* __restrict__ lw_blob,
    const T* __restrict__ sfc_blob, int G, int nlon, T* __restrict__ out) {
  __shared__ LwDownShared<T, K, kLwCols> sh;
  const LongwaveTab<T, K> tb(lw_blob);
  const SurfaceTab<T> ts(sfc_blob);
  const int x = threadIdx.x, k = threadIdx.y;
  const int c = blockIdx.x * kLwCols + x;
  SfcReg<T> sr;
  dnsfc_block_load(tb, ts, G, nlon, in, out, sh, sr, c, x, k);
  if (k < K) {
    level_warps_sync<K>();
    if (k < 4) dnsfc_block_band(G, out, sh, c, x, k);
  }
  __syncthreads();
  dnsfc_block_sums(tb, ts, G, out, sh, sr, c, x, k);
}

template <typename T, int K>
__global__ void __launch_bounds__(kLwCols * 8) radlw_up_kernel(
    const T* __restrict__ ta, const T* __restrict__ ts,
    const T* __restrict__ slrd, const T* __restrict__ slru_sfc,
    const T* __restrict__ dfabs, const T* __restrict__ flux_bands,
    const T* __restrict__ st4a_mean, const T* __restrict__ st4a_grad,
    const T* __restrict__ tau2, const T* __restrict__ stratc,
    const T* __restrict__ blob, int G, T* __restrict__ out) {
  __shared__ LwUpShared<T, K, kLwCols> sh;
  const LongwaveTab<T, K> tb(blob);
  const int x = threadIdx.x, k = threadIdx.y;
  const int c = blockIdx.x * kLwCols + x;
  LwUpReg<T> r;
  lwup_block_load(tb, G, ta, ts, slrd, slru_sfc, dfabs, flux_bands,
                  st4a_mean, st4a_grad, tau2, stratc, sh, r, c, x, k);
  __syncthreads();
  if (k < 4) lwup_block_band(G, sh, c, x, k);
  __syncthreads();
  lwup_block_sums(tb, G, out, sh, r, c, x, k);
}

template <typename T, int K>
static void launch_down_surface(const void* const* in, const void* lw_blob,
                                const void* sfc_blob, int G, int nlon,
                                void* out, cudaStream_t s) {
  const unsigned grid = (unsigned)((G + kLwCols - 1) / kLwCols);
  down_surface_kernel<T, K><<<grid, dim3(kLwCols, K + 1), 0, s>>>(
      down_surface_in<T>(in), (const T*)lw_blob, (const T*)sfc_blob, G, nlon,
      (T*)out);
}

template <typename T, int K>
static void launch_up(const void* ta, const void* ts, const void* slrd,
                      const void* slru_sfc, const void* dfabs,
                      const void* flux_bands, const void* st4a_mean,
                      const void* st4a_grad, const void* tau2,
                      const void* stratc, const void* blob, int G, void* out,
                      cudaStream_t s) {
  const unsigned grid = (unsigned)((G + kLwCols - 1) / kLwCols);
  radlw_up_kernel<T, K><<<grid, dim3(kLwCols, K), 0, s>>>(
      (const T*)ta, (const T*)ts, (const T*)slrd, (const T*)slru_sfc,
      (const T*)dfabs, (const T*)flux_bands, (const T*)st4a_mean,
      (const T*)st4a_grad, (const T*)tau2, (const T*)stratc, (const T*)blob,
      G, (T*)out);
}

#define LW_DISPATCH(FN, ...)                          \
  switch (K) {                                        \
    case 5:                                           \
      if (is_double) FN<double, 5>(__VA_ARGS__);      \
      else FN<float, 5>(__VA_ARGS__);                 \
      break;                                          \
    case 7:                                           \
      if (is_double) FN<double, 7>(__VA_ARGS__);      \
      else FN<float, 7>(__VA_ARGS__);                 \
      break;                                          \
    case 8:                                           \
      if (is_double) FN<double, 8>(__VA_ARGS__);      \
      else FN<float, 8>(__VA_ARGS__);                 \
      break;                                          \
    default:                                          \
      return (int)cudaErrorInvalidValue;              \
  }

// K levels (5, 7 or 8); is_double selects the element type of every
// operand (0: float, 1: double).  in: n_in device pointers in the order
// of DownSurfaceIn; lw_blob: LongwaveTables.blob; sfc_blob:
// SurfaceTables.blob; out (3K + 28, G); G = nlat * nlon.
SPEEDY_API int down_surface_launch(int device, int K, int is_double,
                                   const void* const* in, int n_in,
                                   const void* lw_blob, const void* sfc_blob,
                                   int G, int nlon, void* out, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || nlon <= 0 || G % nlon != 0 || n_in != DOWN_SURFACE_N_IN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  LW_DISPATCH(launch_down_surface, in, lw_blob, sfc_blob, G, nlon, out, s)
  return (int)cudaGetLastError();
}

// K levels and is_double as above.  out (K + 2, G).
SPEEDY_API int radlw_up_launch(int device, int K, int is_double,
                               const void* ta, const void* ts,
                               const void* slrd, const void* slru_sfc,
                               const void* dfabs, const void* flux_bands,
                               const void* st4a_mean, const void* st4a_grad,
                               const void* tau2, const void* stratc,
                               const void* blob, int G, void* out,
                               void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  LW_DISPATCH(launch_up, ta, ts, slrd, slru_sfc, dfabs, flux_bands,
              st4a_mean, st4a_grad, tau2, stratc, blob, G, out, s)
  return (int)cudaGetLastError();
}

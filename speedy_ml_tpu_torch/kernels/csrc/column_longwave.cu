// K10: the 4-band longwave radiation of one step, as two kernels (the
// bodies: column_longwave.cuh): the downward pass before the surface
// fluxes and the upward pass after them.
//
// Replaces (JAX package) speedy_ml_tpu/physics/radiation.py:318
// radlw_down, :381 radlw_up and :38 _fband_lookup.
// Down.  In: ta (K, lat, lon), tau2 (K, 4, lat, lon).  Out, one buffer:
//   slrd, dfabs (K), flux_bands (4), st4a_mean (K), st4a_grad (K).
// Up.  In: ta, ts, slrd, slru_sfc, dfabs, flux_bands, st4a_mean,
//   st4a_grad, tau2, stratc (2, lat, lon).  Out, one buffer: slr, olr,
//   dfabs (K).
//
// Bound on an H100 SXM: memory, and latency-sized.  At T30L8 the
// downward pass reads 40 and writes 29 planes of 4,608 columns (~1.3 MB,
// 0.4 us at 3.35 TB/s), the upward pass reads 73 and writes 10 (~1.5 MB):
// one launch's latency is several times either.  Design of the downward
// pass: as K9's first one, 4,608 threads in blocks of 32 over all SMs,
// the levels of a column in registers, tau2 read where it is used
// (coalesced across neighbouring columns), the four band fractions of a
// level evaluated once.  The upward pass: K12's shape, 144 blocks of
// kLwCols columns x K warps (of 8, 16 and 32 columns a block, 32 ran
// fastest inside the window on an H100: PERF.md);
// warp k loads level k of its eight level planes (coalesced across the
// columns, every load issued at once) into shared memory and evaluates
// the band fractions at ta[k], warp 0 the surface planes; warps 0-3 then
// run the four band recursions up the column from shared memory, one
// band each; warp k forms and stores dfabs of level k.  This source is
// compiled with -fmad=false: every operation is rounded apart, in the
// plain version's order.

#include "column_longwave.cuh"
#include "common.cuh"

template <typename T, int K>
__global__ void radlw_down_kernel(const T* __restrict__ ta,
                                  const T* __restrict__ tau2,
                                  const T* __restrict__ blob, int G,
                                  T* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= G) return;
  radlw_down_at<T, K>(c, G, ta, tau2, blob, out);
}

// columns a K10b block (one warp wide)
constexpr int kLwCols = 32;

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

// threads a K10a block
static const int kBlock = 32;

template <typename T, int K>
static void launch_down(const void* ta, const void* tau2, const void* blob,
                        int G, void* out, cudaStream_t s) {
  const unsigned grid = (unsigned)((G + kBlock - 1) / kBlock);
  radlw_down_kernel<T, K><<<grid, kBlock, 0, s>>>(
      (const T*)ta, (const T*)tau2, (const T*)blob, G, (T*)out);
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

// K levels (5, 7 or 8); is_double selects the element type (0: float,
// 1: double).  blob: LongwaveTables.blob.  out (3K + 5, G).
SPEEDY_API int radlw_down_launch(int device, int K, int is_double,
                                 const void* ta, const void* tau2,
                                 const void* blob, int G, void* out,
                                 void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  LW_DISPATCH(launch_down, ta, tau2, blob, G, out, s)
  return (int)cudaGetLastError();
}

// out (K + 2, G).
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

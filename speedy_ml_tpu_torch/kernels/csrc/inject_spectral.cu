// K18: the injection's spectral glue between K5 and K6, one launch a
// cycle; a block per zonal wavenumber m, thread (n, k) on coefficient n
// of level k (the arithmetic and the block's phases: inject_spectral.cuh,
// which says what is computed).
//
// Replaces (JAX package) speedy_ml_tpu/hybrid/model.py:404-434
// inject_to_speedy's vds (core/spectral.py:307-349), the five trunct,
// uvspec (:351-387) and the stacks.  In: K5's 33 fields of (31, 32)
// complex at T30L8; out: the SpectralState's two levels (66 fields) and
// the 32 fields K6 takes.
//
// Bound on an H100 SXM: memory, and latency-sized: ~0.27 MB read and
// ~0.78 MB written, 0.31 us at 3.35 TB/s, for ~0.05 MFLOP.  Design (a
// first one, K15's shape): 31 blocks of 32 x K threads, loads coalesced
// along n, two barriers (the vds neighbours, then the uvspec neighbours
// of the truncated vor and div); every operation rounded apart in the
// plain version's order.

#include "common.cuh"
#include "inject_spectral.cuh"

template <typename T, int K>
__global__ void __launch_bounds__(STACK_MAX_N * 8)
    inject_spectral_kernel(const InjIO<T> io, const T* __restrict__ blob) {
  __shared__ InjShared<T, K> sh;
  const InjTab<T> tb(blob, io.mx, io.nx);
  const int n = threadIdx.x, k = threadIdx.y, m = blockIdx.x;
  inject_block_load(tb, io, sh, m, n, k);
  __syncthreads();
  inject_block_vds(tb, io, sh, m, n, k);
  __syncthreads();
  inject_block_uv(tb, io, sh, m, n, k);
}

template <typename T, int K>
static void launch(int mx, int nx, const void* spec, void* vor, void* div,
                   void* tem, void* ps, void* tr, void* stk,
                   const void* blob, cudaStream_t s) {
  InjIO<T> io;
  io.spec = (const stack_c<T>*)spec;
  io.vor = (stack_c<T>*)vor;
  io.div = (stack_c<T>*)div;
  io.t = (stack_c<T>*)tem;
  io.ps = (stack_c<T>*)ps;
  io.tr = (stack_c<T>*)tr;
  io.stk = (stack_c<T>*)stk;
  io.mx = mx;
  io.nx = nx;
  inject_spectral_kernel<T, K><<<mx, dim3(nx, K), 0, s>>>(io,
                                                          (const T*)blob);
}

// K levels (5, 7 or 8), nx <= STACK_MAX_N; spec (4K + 1, mx, nx), the
// state vor, div, t (2, K, mx, nx), ps (2, mx, nx), tr (2, 1, K, mx, nx)
// and stk (4K, mx, nx), complex of the element type (is_double: double);
// blob: 6 mx nx + mx + nx elements (inject_blob).
SPEEDY_API int inject_spectral_launch(int device, int K, int is_double,
                                      int mx, int nx, const void* spec,
                                      void* vor, void* div, void* tem,
                                      void* ps, void* tr, void* stk,
                                      const void* blob, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (mx <= 0 || nx <= 0 || nx > STACK_MAX_N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define INJ_CASE(KK)                                                        \
  case KK:                                                                  \
    if (is_double)                                                          \
      launch<double, KK>(mx, nx, spec, vor, div, tem, ps, tr, stk, blob, s); \
    else                                                                    \
      launch<float, KK>(mx, nx, spec, vor, div, tem, ps, tr, stk, blob, s); \
    break;
  switch (K) {
    INJ_CASE(5)
    INJ_CASE(7)
    INJ_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef INJ_CASE
  return (int)cudaGetLastError();
}

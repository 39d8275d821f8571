// K12: the vertical diffusion and the sums that close one physics step; a
// block of kPblCols neighbouring columns x K warps, warp k on level k
// (the arithmetic and the block's phases: column_pbl.cuh).
//
// Replaces (JAX package) speedy_ml_tpu/physics/vdiff.py:16 vdifsc and the
// sums of speedy_ml_tpu/physics/driver.py:258-275 and :298-307.  In: K9's
// se, rh, q, qsat, ttend, qtend, icnv, rps; phig; the carry's tt_rsw and
// ssrd; K10b's dfabs; K10a_down_surface's stresses, heat and moisture
// fluxes; the sea-ice temperature and fraction.  Out: utend, vtend,
// ttend, qtend (K, lat, lon each) and hflux_i (lat, lon) in one buffer.
//
// Bound on an H100 SXM: memory, and latency-sized.  At T30L8 a call
// reads 85 planes (9 level fields, icnv as two, 11 planes) and writes 33
// (4 level fields and one plane) of 4,608 columns (~2.2 MB in float32,
// 0.65 us at 3.35 TB/s) for some 0.3 MFLOP: one launch's latency is
// several times that.  Design: 144 blocks of 32 columns x 8 levels
// (of 8, 16 and 32 columns a block, 32 ran fastest on an H100).
// Warp k loads level k of the nine level fields (coalesced across the
// 32 columns, all loads issued at once), the planes spread over warps 0,
// 1 and K-1; warp 0 runs vdifsc up the column from shared memory; warp k
// then forms and stores the sums of level k.  This source is compiled
// with -fmad=false: every operation is rounded apart, in the plain
// version's order.

#include "column_pbl.cuh"
#include "common.cuh"

// columns a block (one warp wide)
constexpr int kPblCols = 32;

template <typename T, int K>
__global__ void __launch_bounds__(kPblCols * 8)
    column_pbl_kernel(const PblIn<T> in, const T* __restrict__ blob, int G,
                      T* __restrict__ out) {
  __shared__ PblShared<T, K, kPblCols> sh;
  const PblTab<T, K> tb(blob);
  const int x = threadIdx.x, k = threadIdx.y;
  const int c = blockIdx.x * kPblCols + x;
  PblReg<T> r;
  pbl_block_load(tb, in, G, out, sh, r, c, x, k);
  __syncthreads();
  if (k == 0) pbl_block_vdifsc(tb, G, sh, r, c, x);
  __syncthreads();
  pbl_block_sums(tb, G, out, sh, r, c, x, k);
}

template <typename T, int K>
static void launch(const void* const* in, const void* blob, int G, void* out,
                   cudaStream_t s) {
  const unsigned grid = (unsigned)((G + kPblCols - 1) / kPblCols);
  column_pbl_kernel<T, K><<<grid, dim3(kPblCols, K), 0, s>>>(
      pbl_in<T>(in), (const T*)blob, G, (T*)out);
}

// K levels (5, 7 or 8); is_double selects the element type of every float
// operand (0: float, 1: double).  in: n_in device pointers in the order of
// PblIn; blob: PblTables.blob; out (4K + 1, G).
SPEEDY_API int column_pbl_launch(int device, int K, int is_double,
                                 const void* const* in, int n_in,
                                 const void* blob, int G, void* out,
                                 void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || n_in != PBL_N_IN) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PBL_CASE(KK)                              \
  case KK:                                        \
    if (is_double)                                \
      launch<double, KK>(in, blob, G, out, s);    \
    else                                          \
      launch<float, KK>(in, blob, G, out, s);     \
    break;
  switch (K) {
    PBL_CASE(5)
    PBL_CASE(7)
    PBL_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PBL_CASE
  return (int)cudaGetLastError();
}

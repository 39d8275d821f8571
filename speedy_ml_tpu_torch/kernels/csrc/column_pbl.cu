// K12 and K12_pbl_flux: the vertical diffusion and the sums that close
// one physics step, and on a leapfrog step (K12_pbl_flux) the window's
// flux sums in the same launch; a block of kPblCols neighbouring columns
// x K warps, warp k on level k (the arithmetic and the block's phases:
// column_pbl.cuh, flux_accumulate.cuh).
//
// Replaces (JAX package) speedy_ml_tpu/physics/vdiff.py:16 vdifsc and the
// sums of speedy_ml_tpu/physics/driver.py:258-275 and :298-307;
// K12_pbl_flux also the FluxAccumulator update of GCM.leapfrog
// (speedy_ml_tpu/gcm.py:273-280).  In: K9's se, rh, q, qsat, ttend,
// qtend, icnv, rps; phig; the carry's tt_rsw and ssrd; K10b's dfabs;
// K10a_down_surface's stresses, heat and moisture fluxes; the sea-ice
// temperature and fraction; for the flux sums the four running sums,
// the land heat flux and K9's precnv and precls.  Out: utend, vtend,
// ttend, qtend (K, lat, lon each) and hflux_i (lat, lon) in one buffer,
// then the four new sums (lat, lon each).
//
// Bound on an H100 SXM: memory, and latency-sized.  At T30L8 a call
// reads 85 planes (9 level fields, icnv as two, 11 planes) and writes 33
// (4 level fields and one plane) of 4,608 columns (~2.2 MB in float32,
// 0.65 us at 3.35 TB/s) for some 0.3 MFLOP; the flux sums add 7 reads
// and 4 writes (129 planes, 2.4 MB, 0.71 us) and 11 FLOP a column: one
// launch's latency is several times that.  Design: 144 blocks of 32
// columns x 8 levels (of 8, 16 and 32 columns a block, 32 ran fastest on
// an H100).  Warp k loads level k of the nine level fields (coalesced
// across the 32 columns, all loads issued at once), the planes spread
// over warps 0, 1 and K-1; warp 0 runs vdifsc up the column from shared
// memory; warp k then forms and stores the sums of level k.  Warp 1
// forms the sea-ice flux and, in K12_pbl_flux, the four flux sums of its
// columns from it, before the first barrier: the sums take no launch of
// their own (their first design, K16, was a launch of 1.6 us for 0.07 us
// of bytes).  This source is compiled with -fmad=false: every operation
// is rounded apart, in the plain version's order.

#include "column_pbl.cuh"
#include "common.cuh"

// columns a block (one warp wide)
constexpr int kPblCols = 32;

template <typename T, int K, bool kFlux>
__device__ __forceinline__ void pbl_block(const PblIn<T>& in,
                                          const PblFlux<T>& fl,
                                          const T* __restrict__ blob, int G,
                                          T* __restrict__ out,
                                          PblShared<T, K, kPblCols>& sh) {
  const PblTab<T, K> tb(blob);
  const int x = threadIdx.x, k = threadIdx.y;
  const int c = blockIdx.x * kPblCols + x;
  PblReg<T> r;
  pbl_block_load<kFlux>(tb, in, fl, G, out, sh, r, c, x, k);
  __syncthreads();
  if (k == 0) pbl_block_vdifsc(tb, G, sh, r, c, x);
  __syncthreads();
  pbl_block_sums(tb, G, out, sh, r, c, x, k);
}

template <typename T, int K>
__global__ void __launch_bounds__(kPblCols * 8)
    column_pbl_kernel(const PblIn<T> in, const T* __restrict__ blob, int G,
                      T* __restrict__ out) {
  __shared__ PblShared<T, K, kPblCols> sh;
  pbl_block<T, K, false>(in, PblFlux<T>(), blob, G, out, sh);
}

template <typename T, int K>
__global__ void __launch_bounds__(kPblCols * 8)
    pbl_flux_kernel(const PblIn<T> in, const PblFlux<T> fl,
                    const T* __restrict__ blob, int G, T* __restrict__ out) {
  __shared__ PblShared<T, K, kPblCols> sh;
  pbl_block<T, K, true>(in, fl, blob, G, out, sh);
}

template <typename T, int K>
static void launch(const void* const* in, int flux, const void* blob, int G,
                   void* out, double rsteps, double delt2, cudaStream_t s) {
  const unsigned grid = (unsigned)((G + kPblCols - 1) / kPblCols);
  const dim3 block(kPblCols, K);
  if (flux)
    pbl_flux_kernel<T, K><<<grid, block, 0, s>>>(
        pbl_in<T>(in), pbl_flux<T>(in + PBL_N_IN, rsteps, delt2),
        (const T*)blob, G, (T*)out);
  else
    column_pbl_kernel<T, K><<<grid, block, 0, s>>>(
        pbl_in<T>(in), (const T*)blob, G, (T*)out);
}

// K levels (5, 7 or 8); is_double selects the element type of every float
// operand (0: float, 1: double).  flux 0: K12, in the n_in = PBL_N_IN
// device pointers in the order of PblIn, out (4K + 1, G); flux 1:
// K12_pbl_flux, in PblIn's pointers then PblFlux's (n_in = PBL_N_IN +
// PBL_FLUX_N_IN), out (4K + 5, G), rsteps and delt2 cast to the element
// type (unused by K12).  blob: PblTables.blob.
SPEEDY_API int column_pbl_launch(int device, int K, int is_double, int flux,
                                 const void* const* in, int n_in,
                                 const void* blob, int G, void* out,
                                 double rsteps, double delt2,
                                 void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || n_in != PBL_N_IN + (flux ? PBL_FLUX_N_IN : 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PBL_CASE(KK)                                                  \
  case KK:                                                            \
    if (is_double)                                                    \
      launch<double, KK>(in, flux, blob, G, out, rsteps, delt2, s);   \
    else                                                              \
      launch<float, KK>(in, flux, blob, G, out, rsteps, delt2, s);    \
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

// K12: the vertical diffusion and the sums that close one physics step,
// one thread per grid column (the body: column_pbl.cuh).
//
// Replaces (JAX package) speedy_ml_tpu/physics/vdiff.py:16 vdifsc and the
// sums of speedy_ml_tpu/physics/driver.py:258-275 and :298-307.  In: K9's
// se, rh, q, qsat, ttend, qtend, icnv, rps; phig; the carry's tt_rsw and
// ssrd; K10b's dfabs; K11's stresses, heat and moisture fluxes; the
// sea-ice temperature and fraction.  Out: utend, vtend, ttend, qtend
// (K, lat, lon each) and hflux_i (lat, lon) in one buffer.
//
// Bound on an H100 SXM: memory, and latency-sized.  At T30L8 a call
// reads 85 planes (9 level fields, icnv as two, 11 planes) and writes 33
// (4 level fields and one plane) of 4,608 columns (~2.2 MB in float32,
// 0.65 us at 3.35 TB/s) for some 0.3 MFLOP: one launch's latency is
// several times that.  Design:
// 4,608 threads in blocks of 32, so that the columns spread over all 132
// SMs; each thread keeps its column's levels in registers (the damping's
// double loop is unrolled over them) and writes its outputs once, the
// zeros of utend and vtend above the lowest level included.  This source
// is compiled with -fmad=false: every operation is rounded apart, in the
// plain version's order.

#include "column_pbl.cuh"
#include "common.cuh"

template <typename T, int K>
__global__ void column_pbl_kernel(PblIn<T> in, const T* __restrict__ blob,
                                  int G, T* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= G) return;
  column_pbl_at<T, K>(c, G, in, blob, out);
}

template <typename T, int K>
static void launch(const void* const* in, const void* blob, int G, void* out,
                   cudaStream_t s) {
  const int block = 32;
  const unsigned grid = (unsigned)((G + block - 1) / block);
  column_pbl_kernel<T, K><<<grid, block, 0, s>>>(pbl_in<T>(in),
                                                 (const T*)blob, G, (T*)out);
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

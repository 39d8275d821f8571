// K2: the ESN readout with its quadratic expansion and unstandardization.
//
// Replaces (JAX package) speedy_ml_tpu/esn/reservoir.py: quad_expand +
// readout, fused with Standardizer.unstandardize_output as
// hybrid/model.py:366-367 applies it, and, given the grid, with
// esn/domain.py:271,290 unpack_core_vector + scatter_core and the clamps
// of HybridAtmosphere.assemble_global (hybrid/model.py:373-402).  Computes
//   aug      = [local_model (S) ; x with odd indices squared (n)]
//   out[r,o] = (sum_a Wout[r,o,a] * aug[r,a]) * out_std[r,o] + out_mean[r,o]
// (out_std/out_mean null: the bare product).  With bf16 Wout, aug is
// rounded to bf16 first (round to nearest even), exactly where the JAX
// code casts aug.astype(bfloat16); products and sums are f32.
//
// Bound on an H100 SXM (3.35 TB/s): memory, one read of Wout.  At the
// T30 m=6000 layout Wout is (1056, 136, 5892) + 2 x (48, 136, 6180) in the
// coupled form, about 1.88 GB in bf16 (0.56 ms).  2 flops per weight is
// far below any compute rate.
// The store: into the (R, O) vector, or (the coupled and ML-only cycles)
// straight into its element of the assembled grid with the q and precip
// clamps, through the inverse table RegionLayout.core_output_index
// (readout.cuh RoScatter): the core scatter, formerly K4, a launch of
// its own.
// Design: block (region r, tile of output rows).  The block builds aug for
// its region in shared memory (A*4 bytes, 23-24 KB at m=6000), rounded
// once; each warp then streams whole Wout rows (readout.cuh): a 4-element
// head where the row starts 8 bytes past a 16-byte boundary (in the
// coupled form A = 5,892 and 6,180 are 4 mod 8, so every second bf16 row
// does), a body of 16-byte evict-first loads, RO_UNROLL of them in flight
// per lane, and a tail; then a shuffle butterfly.  The tile height is
// chosen per launch: as tall as the region's O rows where the class has
// enough regions to fill the card (aug built once per region), shorter
// for the 48-region polar classes so that ~4 blocks per SM still run.
// The scalar path is left for A % 4 != 0 (or a Wout not 8-byte aligned).
// The components form (readout_components_launch; the cycle's
// emit_components, JAX hybrid/model.py:354-364, 735-747) is the same
// launch with COMP: aug staged in f32 without the bf16 rounding, each
// lane's share split at S into two accumulators in the one pass over
// Wout (readout.cuh ro_lane_dot2), both reduced by the butterfly, and
// lane 0 stores the main output (v_p + v_ml, unstandardized, clamped)
// and v_p and v_ml as they are (ro_store_parts).  The main form's
// instantiations (COMP false) are the kernel as it was.

#include <stdint.h>

#include "common.cuh"
#include "readout.cuh"

#define READOUT_THREADS (RO_WARPS * 32)

template <int ES, bool VEC, bool COMP>
__global__ void __launch_bounds__(READOUT_THREADS)
readout_kernel(const unsigned char* __restrict__ wout,
               const float* __restrict__ x, const float* __restrict__ lm,
               const float* __restrict__ out_mean,
               const float* __restrict__ out_std, int O, int S, int n,
               int tile_rows, float* __restrict__ out, const RoScatter sc,
               const RoParts pt) {
  extern __shared__ float4 aug_s[];
  float* aug = reinterpret_cast<float*>(aug_s);
  const int r = blockIdx.x;
  const int A = S + n;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    const float v = ro_aug(x, lm, r, a, S, n);
    aug[a] = ES == 2 && !COMP ? ro_round_bf16(v) : v;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int o0 = blockIdx.y * tile_rows;
  const int o_end = min(O, o0 + tile_rows);
  for (int o = o0 + warp; o < o_end; o += RO_WARPS) {
    const long long k = (long long)r * O + o;
    if (COMP) {
      float p, m;
      ro_lane_dot2<ES, VEC>(wout + (size_t)k * A * ES, aug, A, S, lane, p,
                            m);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        p += __shfl_xor_sync(0xffffffffu, p, off);
        m += __shfl_xor_sync(0xffffffffu, m, off);
      }
      if (lane == 0) {
        const float acc = p + m;
        ro_store_parts(out_std ? ro_unstd(acc, out_std[k], out_mean[k])
                               : acc,
                       p, m, k, out, sc, pt);
      }
      continue;
    }
    float acc = ro_lane_dot<ES, VEC>(wout + (size_t)k * A * ES, aug, A, lane);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0)
      ro_store(out_std ? ro_unstd(acc, out_std[k], out_mean[k]) : acc, k,
               out, sc);
  }
}

template <int ES, bool COMP>
static int launch(int device, const void* wout, const void* x,
                  const void* lm, const void* out_mean, const void* out_std,
                  int R, int O, int S, int n, void* out, const RoScatter& sc,
                  const RoParts& pt, cudaStream_t st) {
  const int A = S + n;
  const size_t smem = ((size_t)A + 4) * sizeof(float);
  const bool vec = ro_vector_ok(wout, A, ES);
  void (*kern)(const unsigned char*, const float*, const float*,
               const float*, const float*, int, int, int, int, float*,
               const RoScatter, const RoParts) =
      vec ? &readout_kernel<ES, true, COMP>
          : &readout_kernel<ES, false, COMP>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int tile_rows = ro_tile_rows(sms, R, O);
  const dim3 grid(R, (O + tile_rows - 1) / tile_rows);
  kern<<<grid, READOUT_THREADS, smem, st>>>(
      (const unsigned char*)wout, (const float*)x, (const float*)lm,
      (const float*)out_mean, (const float*)out_std, O, S, n, tile_rows,
      (float*)out, sc, pt);
  return (int)cudaGetLastError();
}

// wout_bf16: 1 for bfloat16 Wout, 0 for float32.  lm null when S == 0;
// out_mean/out_std both null for the bare product.  grid null: the
// outputs go to out (R, O); else into the flat grid through index (R, O)
// with the clamps of [q0, q1) and [p0, p1) (readout.cuh RoScatter), and
// out is not written.
SPEEDY_API int readout_launch(int device, int wout_bf16, const void* wout,
                              const void* x, const void* lm,
                              const void* out_mean, const void* out_std,
                              int R, int O, int S, int n, void* out,
                              void* grid, const void* index, long long q0,
                              long long q1, long long p0, long long p1,
                              void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 1 || O < 1 || n < 1 || (grid ? !index : !out))
    return (int)cudaErrorInvalidValue;
  const RoScatter sc = {(float*)grid, (const int*)index, q0, q1, p0, p1};
  const RoParts pt = {nullptr, nullptr};
  cudaStream_t st = (cudaStream_t)stream;
  return wout_bf16 ? launch<2, false>(device, wout, x, lm, out_mean, out_std,
                                      R, O, S, n, out, sc, pt, st)
                   : launch<4, false>(device, wout, x, lm, out_mean, out_std,
                                      R, O, S, n, out, sc, pt, st);
}

// The components form: readout_launch's arguments with vp and vml, where
// v_p and v_ml go (standardized, no clamps): two (R, O) vectors beside
// out when grid is null, else two flat grids of grid's layout.  lm null
// (S == 0): v_p is 0.
SPEEDY_API int readout_components_launch(
    int device, int wout_bf16, const void* wout, const void* x,
    const void* lm, const void* out_mean, const void* out_std, int R, int O,
    int S, int n, void* out, void* vp, void* vml, void* grid,
    const void* index, long long q0, long long q1, long long p0, long long p1,
    void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 1 || O < 1 || n < 1 || (grid ? !index : !out) || !vp || !vml)
    return (int)cudaErrorInvalidValue;
  const RoScatter sc = {(float*)grid, (const int*)index, q0, q1, p0, p1};
  const RoParts pt = {(float*)vp, (float*)vml};
  cudaStream_t st = (cudaStream_t)stream;
  return wout_bf16 ? launch<2, true>(device, wout, x, lm, out_mean, out_std,
                                     R, O, S, n, out, sc, pt, st)
                   : launch<4, true>(device, wout, x, lm, out_mean, out_std,
                                     R, O, S, n, out, sc, pt, st);
}

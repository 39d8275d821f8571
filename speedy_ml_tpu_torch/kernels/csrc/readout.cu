// K2: the ESN readout with its quadratic expansion and unstandardization.
//
// Replaces (JAX package) speedy_ml_tpu/esn/reservoir.py: quad_expand +
// readout, fused with Standardizer.unstandardize_output as
// hybrid/model.py:366-367 applies it.  Computes
//   aug      = [local_model (S) ; x with odd indices squared (n)]
//   out[r,o] = (sum_a Wout[r,o,a] * aug[r,a]) * out_std[r,o] + out_mean[r,o]
// (out_std/out_mean null: the bare product).  With bf16 Wout, aug is
// rounded to bf16 first (round to nearest even), exactly where the JAX
// code casts aug.astype(bfloat16); products and sums are f32.
//
// Bound on an H100 SXM (3.35 TB/s): memory, one read of Wout.  At the
// T30 m=6000 layout Wout is (1056, 136, 5760) + 2 x (48, 136, 6048), about
// 1.81 GB in bf16 (0.54 ms) or 3.6 GB in f32.  2 flops per weight is far
// below any compute rate.
// Design: block (region r, tile of ROWS output rows).  The block stages
// aug for its region in shared memory (A*4 bytes, 23-24 KB at m=6000),
// then each warp streams whole Wout rows with 16-byte evict-first loads
// (__ldcs: Wout is read once per cycle and must not evict the state) and
// reduces with shuffles.  Many tiles per region keep ~9.5k blocks in
// flight at T30 so the polar classes do not idle most SMs.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

#define READOUT_THREADS 256
#define READOUT_ROWS 16

template <typename W>
struct WoutVec;

template <>
struct WoutVec<__nv_bfloat16> {
  static constexpr int N = 8;  // 8 bf16 per 16-byte load
  static __device__ __forceinline__ float dot(const __nv_bfloat16* p,
                                              const float* a) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 w = __bfloat1622float2(h[k]);
      s += w.x * a[2 * k] + w.y * a[2 * k + 1];
    }
    return s;
  }
  static __device__ __forceinline__ float scalar(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round_aug(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct WoutVec<float> {
  static constexpr int N = 4;  // 4 f32 per 16-byte load
  static __device__ __forceinline__ float dot(const float* p,
                                              const float* a) {
    const float4 w = __ldcs(reinterpret_cast<const float4*>(p));
    return w.x * a[0] + w.y * a[1] + w.z * a[2] + w.w * a[3];
  }
  static __device__ __forceinline__ float scalar(const float* p) {
    return *p;
  }
  static __device__ __forceinline__ float round_aug(float v) { return v; }
};

template <typename W, bool VEC>
__global__ void __launch_bounds__(READOUT_THREADS)
readout_kernel(const W* __restrict__ wout, const float* __restrict__ x,
               const float* __restrict__ lm,
               const float* __restrict__ out_mean,
               const float* __restrict__ out_std, int O, int S, int n,
               float* __restrict__ out) {
  extern __shared__ float aug[];
  const int r = blockIdx.x;
  const int A = S + n;
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    float v;
    if (a < S) {
      v = lm[(long long)r * S + a];
    } else {
      const int i = a - S;
      const float xi = x[(long long)r * n + i];
      v = (i & 1) ? __fmul_rn(xi, xi) : xi;
    }
    aug[a] = WoutVec<W>::round_aug(v);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int o_end = min(O, (int)(blockIdx.y + 1) * READOUT_ROWS);
  for (int o = blockIdx.y * READOUT_ROWS + warp; o < o_end; o += nwarps) {
    const W* row = wout + ((long long)r * O + o) * A;
    float acc = 0.f;
    if (VEC) {
      constexpr int N = WoutVec<W>::N;
      for (int c = lane; c < A / N; c += 32)
        acc += WoutVec<W>::dot(row + c * N, aug + c * N);
    } else {
      for (int a = lane; a < A; a += 32)
        acc += WoutVec<W>::scalar(row + a) * aug[a];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const long long k = (long long)r * O + o;
      out[k] = out_std ? __fadd_rn(__fmul_rn(acc, out_std[k]), out_mean[k])
                       : acc;
    }
  }
}

template <typename W>
static int launch(const void* wout, const void* x, const void* lm,
                  const void* out_mean, const void* out_std, int R, int O,
                  int S, int n, void* out, cudaStream_t st) {
  const int A = S + n;
  const size_t smem = (size_t)A * sizeof(float);
  const bool vec = (A % WoutVec<W>::N == 0) &&
                   ((uintptr_t)wout % 16 == 0);
  void (*kern)(const W*, const float*, const float*, const float*,
               const float*, int, int, int, float*) =
      vec ? &readout_kernel<W, true> : &readout_kernel<W, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(R, (O + READOUT_ROWS - 1) / READOUT_ROWS);
  kern<<<grid, READOUT_THREADS, smem, st>>>(
      (const W*)wout, (const float*)x, (const float*)lm,
      (const float*)out_mean, (const float*)out_std, O, S, n, (float*)out);
  return (int)cudaGetLastError();
}

// wout_bf16: 1 for bfloat16 Wout, 0 for float32.  lm null when S == 0;
// out_mean/out_std both null for the bare product.
SPEEDY_API int readout_launch(int device, int wout_bf16, const void* wout,
                              const void* x, const void* lm,
                              const void* out_mean, const void* out_std,
                              int R, int O, int S, int n, void* out,
                              void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (R < 1 || O < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return wout_bf16
             ? launch<__nv_bfloat16>(wout, x, lm, out_mean, out_std, R, O, S,
                                     n, out, st)
             : launch<float>(wout, x, lm, out_mean, out_std, R, O, S, n, out,
                             st);
}

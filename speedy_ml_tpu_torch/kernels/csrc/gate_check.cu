// K19: the injection's safety gate, one launch a cycle: the eight
// extrema of u, v, t and q over the grid K6 returned, and the 0-d flag
// (the arithmetic: gate_check.cuh, which says what is computed).
//
// Replaces (JAX package) speedy_ml_tpu/hybrid/model.py:423-426, the
// gate's eight reductions and seven ands.  In: 32 fields of 4,608 floats
// at T30L8 (0.59 MB); out: 8 values and one byte.
//
// Bound on an H100 SXM: memory: 0.59 MB read, 0.18 us at 3.35 TB/s.
// Design: one cluster of 8 blocks of 1,024 threads, each thread walking
// the four variables at once with a stride of the cluster (coalesced
// 16-byte loads, four a step, unrolled by two; element loads where a
// variable is not 16-byte aligned), then a warp reduction with shuffles,
// one across the block's 32 warps in shared memory, and one across the
// cluster's blocks in rank 0's shared memory (DSMEM, one cluster barrier);
// rank 0's thread 0 writes the extrema and the flag.  The work is the
// comparisons: 16 NaN-keeping min/max a element and variable.  (A first
// design, one block, took 11.4 us on an H100 with element loads and 10.9
// with 16-byte loads: the comparisons of one SM bound it.)

#include <cooperative_groups.h>

#include "common.cuh"
#include "gate_check.cuh"

namespace cg = cooperative_groups;

constexpr int kGateBlocks = 8;   // one cluster: the blocks reduce in DSMEM
constexpr int kGateThreads = 1024;
constexpr int kGateWarps = kGateThreads / 32;

template <typename T>
struct GateBounds {
  T b[GATE_EXTREMA];
};

// 16 bytes of T: the load of the kernel's main loop
template <typename T>
struct Gate16;
template <>
struct Gate16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ float at(const float4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};
template <>
struct Gate16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ double at(const double2& v, int j) {
    return j == 0 ? v.x : v.y;
  }
};

template <typename T>
__global__ void __cluster_dims__(kGateBlocks, 1, 1)
    __launch_bounds__(kGateThreads)
    gate_check_kernel(const T* __restrict__ back, int K, long long G,
                      const GateBounds<T> bounds, T* __restrict__ ext,
                      bool* __restrict__ safe) {
  using V = Gate16<T>;
  __shared__ T part[kGateWarps][GATE_EXTREMA];
  __shared__ T ranks[kGateBlocks][GATE_EXTREMA];   // read on rank 0
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long long first = (long long)rank * kGateThreads + threadIdx.x;
  const long long stride = (long long)kGateBlocks * kGateThreads;
  const long long n = (long long)K * G;
  const T* f[GATE_VARS];
  T e[GATE_EXTREMA];
  for (int v = 0; v < GATE_VARS; ++v) {
    f[v] = back + gate_offset(v, K, G);
    e[2 * v] = e[2 * v + 1] = f[v][0];
  }
  // the four variables at once, 16 bytes a load where every variable's
  // start is 16-byte aligned, unrolled: many loads in flight a thread
  const bool vec = n % V::n == 0 && ((size_t)back & 15) == 0;
  const long long nv = vec ? n / V::n : 0;
#pragma unroll 2
  for (long long i = first; i < nv; i += stride)
    for (int v = 0; v < GATE_VARS; ++v) {
      const typename V::type x =
          reinterpret_cast<const typename V::type*>(f[v])[i];
      for (int j = 0; j < V::n; ++j) {
        e[2 * v] = gate_min(e[2 * v], V::at(x, j));
        e[2 * v + 1] = gate_max(e[2 * v + 1], V::at(x, j));
      }
    }
#pragma unroll 4
  for (long long i = nv * V::n + first; i < n; i += stride)
    for (int v = 0; v < GATE_VARS; ++v) {
      const T x = f[v][i];
      e[2 * v] = gate_min(e[2 * v], x);
      e[2 * v + 1] = gate_max(e[2 * v + 1], x);
    }
  for (int off = 16; off > 0; off >>= 1)
    for (int v = 0; v < GATE_VARS; ++v) {
      e[2 * v] =
          gate_min(e[2 * v], __shfl_xor_sync(0xffffffffu, e[2 * v], off));
      e[2 * v + 1] = gate_max(e[2 * v + 1],
                              __shfl_xor_sync(0xffffffffu, e[2 * v + 1], off));
    }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0)
    for (int x = 0; x < GATE_EXTREMA; ++x) part[warp][x] = e[x];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kGateWarps; ++w)
      for (int v = 0; v < GATE_VARS; ++v) {
        e[2 * v] = gate_min(e[2 * v], part[w][2 * v]);
        e[2 * v + 1] = gate_max(e[2 * v + 1], part[w][2 * v + 1]);
      }
    // this block's extrema into rank 0's shared memory
    T* dst = cluster.map_shared_rank(&ranks[0][0], 0);
    for (int x = 0; x < GATE_EXTREMA; ++x)
      dst[rank * GATE_EXTREMA + x] = e[x];
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    for (int r = 1; r < kGateBlocks; ++r)
      for (int v = 0; v < GATE_VARS; ++v) {
        e[2 * v] = gate_min(e[2 * v], ranks[r][2 * v]);
        e[2 * v + 1] = gate_max(e[2 * v + 1], ranks[r][2 * v + 1]);
      }
    for (int x = 0; x < GATE_EXTREMA; ++x) ext[x] = e[x];
    *safe = gate_flag(e, bounds.b);
  }
}

// back (4K, G) = [t, q, u, v] (K levels each) of the element type
// (is_double: double); bounds: GATE_EXTREMA doubles (lo, hi of u, v, t,
// q); ext: GATE_EXTREMA elements; safe: one bool.
SPEEDY_API int gate_check_launch(int device, int is_double, int K,
                                 long long G, const void* back,
                                 const double* bounds, void* ext, void* safe,
                                 void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0 || G <= 0 || !bounds) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double) {
    GateBounds<double> b;
    for (int x = 0; x < GATE_EXTREMA; ++x) b.b[x] = bounds[x];
    gate_check_kernel<double><<<kGateBlocks, kGateThreads, 0, s>>>(
        (const double*)back, K, G, b, (double*)ext, (bool*)safe);
  } else {
    GateBounds<float> b;
    for (int x = 0; x < GATE_EXTREMA; ++x) b.b[x] = (float)bounds[x];
    gate_check_kernel<float><<<kGateBlocks, kGateThreads, 0, s>>>(
        (const float*)back, K, G, b, (float*)ext, (bool*)safe);
  }
  return (int)cudaGetLastError();
}

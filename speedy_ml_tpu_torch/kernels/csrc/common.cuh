// Shared helper of the port's kernels: the C interface every launch
// function exposes (pointers and the stream as void*, a cudaError_t code
// back).
#pragma once

#include <cuda_runtime.h>

#define SPEEDY_API extern "C" __attribute__((visibility("default")))

// Selects the caller's device, so the launch lands in the same primary
// context as PyTorch's tensors whatever this library's runtime last used.
static inline cudaError_t speedy_set_device(int device) {
  return cudaSetDevice(device);
}


#ifdef __CUDACC__
// 16 bytes of T: one vector load
template <typename T>
struct Speedy16;
template <>
struct Speedy16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ float at(const float4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};
template <>
struct Speedy16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ double at(const double2& v, int j) {
    return j == 0 ? v.x : v.y;
  }
};

// True where a 16-byte load may start at p and a row of `cols` holds
// whole vectors.
template <typename T>
static __device__ __forceinline__ bool speedy_vec_ok(const T* p, int cols) {
  return cols % Speedy16<T>::n == 0 && ((size_t)p & 15) == 0;
}

// The block's threads copy `rows` contiguous rows of `cols` from device
// memory into shared memory rows `ds` apart, with 16-byte loads where
// the source allows them, element loads otherwise.
template <typename T>
static __device__ __forceinline__ void speedy_stage_rows(T* dst, int ds,
                                                         const T* src,
                                                         int rows, int cols) {
  using V = Speedy16<T>;
  const int n = rows * cols;
  if (speedy_vec_ok(src, cols)) {
    const typename V::type* s = reinterpret_cast<const typename V::type*>(src);
    for (int i = threadIdx.x; i < n / V::n; i += blockDim.x) {
      const typename V::type v = s[i];
      const int r = i * V::n / cols, c = i * V::n % cols;
      for (int j = 0; j < V::n; ++j) dst[r * ds + c + j] = V::at(v, j);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[(i / cols) * ds + i % cols] = src[i];
  }
}

// The split cluster barrier: every thread of every block of the cluster
// arrives (relaxed: it orders no memory) and later waits.  A kernel
// arrives as it starts and waits before its first write into another
// block's shared memory, so that every block of the cluster is running.
static __device__ __forceinline__ void speedy_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" : : : "memory");
}
static __device__ __forceinline__ void speedy_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}
#endif

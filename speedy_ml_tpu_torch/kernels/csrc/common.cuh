// Shared helpers of the port's kernels: the C interface every launch
// function exposes (pointers and the stream as void*, a cudaError_t code
// back) and the per-call class tables passed to the kernels by value.
#pragma once

#include <cuda_runtime.h>

#define SPEEDY_API extern "C" __attribute__((visibility("default")))

// region classes a single launch can cover (the T30 layout has 3)
#define MAX_CLASSES 8

// Selects the caller's device, so the launch lands in the same primary
// context as PyTorch's tensors whatever this library's runtime last used.
static inline cudaError_t speedy_set_device(int device) {
  return cudaSetDevice(device);
}

// Index of the class whose half-open [start[c], start[c+1]) holds t.
__device__ __forceinline__ int class_of(long long t, const long long* start,
                                        int n_classes) {
  int c = 0;
  while (c + 1 < n_classes && t >= start[c + 1]) ++c;
  return c;
}

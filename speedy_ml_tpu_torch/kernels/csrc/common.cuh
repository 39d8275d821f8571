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


// K22: the slab ocean's per-cycle glue (the arithmetic: slab_ocean.cuh,
// which says what is computed).  The hybrid cycle with ocean packs
// launches the push form once a cycle; on a slab step (every
// SLAB_STRIDE-th cycle) the push_mean form instead, then, after the slab
// ESN step (K1) and readout (K2) of each class, the SST form.
//
// Replaces (JAX package) speedy_ml_tpu/hybrid/model.py:678-726, the
// slab-ocean branch of _cycle_jit (the buffer's concatenate and mean, the
// unstandardize, scatter_core, the land fill, the 272 K floor and the
// where(do_step)), which XLA fused.
// In/out at full width (T30, 1,152 regions; 144,384 ocean inputs a
// slot): push reads 0.58 MB (the inputs it gathers and their index maps)
// and writes one slot, 0.58 MB; push_mean also reads the 26 other slots,
// 15.0 MB, and writes the means, 0.58 MB; sst reads ~4,608 outputs, the
// source table, the land fill and mask, and writes 4,608 points.
//
// Bound on an H100 SXM: memory; push 1.1 MB, 0.00033 ms at 3.35 TB/s;
// push_mean 16.7 MB, 0.0050 ms; sst < 0.1 MB, a launch floor.  Design:
// the first, simple one; one thread an element of every class's slot (the
// push forms, one launch for all classes with their tables by value, as
// K3) and one thread a grid point (sst); neighbouring threads touch
// neighbouring elements of each slot, so the slots stream coalesced.
// Compiled without FMA contraction (SOURCE_FLAGS in kernels/build.py).
// The push forms' device-scalar form reads the slot from device memory: a
// captured CUDA graph of the cycle (hybrid/graph.py) refills it before
// each replay.

#include "common.cuh"
#include "slab_ocean.cuh"

constexpr int kPushBlock = 256;
constexpr int kSstBlock = 128;

// slot_dev: null, or the device-scalar form's slot (a double in device
// memory) read in place of a.slot
template <typename T>
__global__ void __launch_bounds__(kPushBlock)
    slab_push_kernel(const SoPush<T> a, const double* __restrict__ slot_dev) {
  const long long t = (long long)blockIdx.x * kPushBlock + threadIdx.x;
  if (t >= a.start[a.n_classes]) return;
  if (slot_dev) {
    const int slot = (int)slot_dev[0];
    if (slot >= 0 && slot < a.W) slab_push_at(a, t, slot);
  } else {
    slab_push_at(a, t);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSstBlock)
    slab_sst_kernel(const SoSst<T> a) {
  const long long g = (long long)blockIdx.x * kSstBlock + threadIdx.x;
  if (g < a.G) slab_sst_at(a, g);
}

template <typename T>
static int push(int n_classes, void* const* fb, void* const* idx,
                void* const* buf, void* const* mean, const long long* counts,
                const int* width, const int* fb_width, int W, int slot,
                double rw, const double* slot_dev, cudaStream_t stream) {
  SoPush<T> a;
  if (slab_push_args(&a, n_classes, fb, idx, buf, mean, counts, width,
                     fb_width, W, slot, rw))
    return (int)cudaErrorInvalidValue;
  const long long total = a.start[n_classes];
  if (total == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((total + kPushBlock - 1) / kPushBlock);
  slab_push_kernel<T><<<grid, kPushBlock, 0, stream>>>(a, slot_dev);
  return (int)cudaGetLastError();
}

template <typename T>
static int sst(int n_classes, void* const* out, void* const* mean_sst,
               void* const* std_sst, const long long* counts,
               const int* width, const void* src, const void* base,
               const void* land, long long G, double tmin, void* grid_out,
               cudaStream_t stream) {
  SoSst<T> a;
  if (slab_sst_args(&a, n_classes, out, mean_sst, std_sst, counts, width,
                    src, base, land, G, tmin, grid_out))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((G + kSstBlock - 1) / kSstBlock);
  slab_sst_kernel<T><<<grid, kSstBlock, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The push forms: per class c the device pointers fb[c] (Rc, fb_width[c]),
// idx[c] (width[c] int32), buf[c] (W, Rc, width[c]) and mean[c] (Rc,
// width[c]; all null for the push form), counts[c] = Rc * width[c]; slot
// = step mod W; rw the mean's factor 1/W.  slot_dev: null, or the
// device-scalar form's slot, a double in device memory read in place of
// slot (which must then be 0); a slot outside [0, W) writes nothing.
SPEEDY_API int slab_ocean_push_launch(int device, int is_double,
                                      int n_classes, void* const* fb,
                                      void* const* idx, void* const* buf,
                                      void* const* mean,
                                      const long long* counts,
                                      const int* width, const int* fb_width,
                                      int W, int slot, double rw,
                                      const double* slot_dev, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (slot_dev && slot != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_double
             ? push<double>(n_classes, fb, idx, buf, mean, counts, width,
                            fb_width, W, slot, rw, slot_dev, s)
             : push<float>(n_classes, fb, idx, buf, mean, counts, width,
                           fb_width, W, slot, rw, slot_dev, s);
}

// The SST form: per class c the device pointers out[c] (Rc, width[c]),
// mean_sst[c] and std_sst[c] (Rc,), counts[c] = Rc * width[c]; src (G,)
// int32, base (G,) and land (G,) bool (both null: no land fill), tmin the
// floor; sst (G,) the new grid.
SPEEDY_API int slab_ocean_sst_launch(int device, int is_double,
                                     int n_classes, void* const* out,
                                     void* const* mean_sst,
                                     void* const* std_sst,
                                     const long long* counts,
                                     const int* width, const void* src,
                                     const void* base, const void* land,
                                     long long G, double tmin, void* sst_out,
                                     void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  return is_double
             ? sst<double>(n_classes, out, mean_sst, std_sst, counts, width,
                           src, base, land, G, tmin, sst_out, s)
             : sst<float>(n_classes, out, mean_sst, std_sst, counts, width,
                          src, base, land, G, tmin, sst_out, s);
}

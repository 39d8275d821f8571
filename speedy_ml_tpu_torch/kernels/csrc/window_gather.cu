// K3: window gather + input standardization for every region class.
//
// Replaces (JAX package) speedy_ml_tpu/esn/domain.py: class_patches /
// pack_vector, and Standardizer.standardize_input, as
// HybridAtmosphere.build_feedback (hybrid/model.py:477-493) chains them.
// Computes, for every class c and element k of its (Rc, I) output,
//   out_c[k] = (src[idx_c[k]] - in_mean_c[k]) / in_std_c[k]
// where src is the flat concatenation [atmo (4, K, lat, lon), logp,
// precip, sst, tisr (lat, lon)] read through five pointers, and idx_c is
// the class's pack table (RegionLayout.pack_table: reference packing
// order, var fastest, then x, y, z, then the flat 2-D blocks).
//
// Bound on an H100 SXM (3.35 TB/s): memory, but the work is tiny: about
// 650k outputs at T30 (idx, mean, std read, out written: ~10 MB, ~3 us),
// so a launch costs more than the transfer.  Design: ONE launch for all
// classes (class tables passed by value), one thread per output element;
// idx/mean/std/out accesses are coalesced, and the ~150 KB of source
// fields stay in L2 for the scattered reads.  Subtract and divide are
// round-to-nearest IEEE, as in the plain version.  An index outside the
// source yields NaN (checked here, so the wrapper needs no device sync).

#include "common.cuh"

struct GatherArgs {
  const int* idx[MAX_CLASSES];
  const float* mean[MAX_CLASSES];
  const float* stdv[MAX_CLASSES];
  float* out[MAX_CLASSES];
  long long start[MAX_CLASSES + 1];
  const float* src[5];  // atmo, logp, precip, sst, tisr
  long long atmo_size;
  long long grid_size;
  int n_classes;
};

__global__ void window_gather_kernel(GatherArgs a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.start[a.n_classes]) return;
  const int c = class_of(t, a.start, a.n_classes);
  const long long k = t - a.start[c];
  const long long s = a.idx[c][k];
  float v;
  if (s < 0 || s >= a.atmo_size + 4 * a.grid_size) {
    v = __int_as_float(0x7fc00000);  // a bad table shows as NaN
  } else if (s < a.atmo_size) {
    v = a.src[0][s];
  } else {
    const long long s2 = s - a.atmo_size;
    const int f = (int)(s2 / a.grid_size);
    v = a.src[1 + f][s2 - (long long)f * a.grid_size];
  }
  a.out[c][k] = __fdiv_rn(__fsub_rn(v, a.mean[c][k]), a.stdv[c][k]);
}

// src: 5 device pointers (atmo, logp, precip, sst, tisr); per class c the
// device pointers idx[c] (int32), mean[c], stdv[c], out[c] and its element
// count counts[c] (Rc * I).
SPEEDY_API int window_gather_launch(int device, void* const* src,
                                    long long atmo_size, long long grid_size,
                                    int n_classes, void* const* idx,
                                    void* const* mean, void* const* stdv,
                                    void* const* out,
                                    const long long* counts, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n_classes < 1 || n_classes > MAX_CLASSES)
    return (int)cudaErrorInvalidValue;
  GatherArgs a = {};
  a.start[0] = 0;
  for (int c = 0; c < n_classes; ++c) {
    a.idx[c] = (const int*)idx[c];
    a.mean[c] = (const float*)mean[c];
    a.stdv[c] = (const float*)stdv[c];
    a.out[c] = (float*)out[c];
    a.start[c + 1] = a.start[c] + counts[c];
  }
  for (int f = 0; f < 5; ++f) a.src[f] = (const float*)src[f];
  a.atmo_size = atmo_size;
  a.grid_size = grid_size;
  a.n_classes = n_classes;
  const long long total = a.start[n_classes];
  if (total == 0) return (int)cudaSuccess;
  const int block = 256;
  const unsigned grid = (unsigned)((total + block - 1) / block);
  window_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K4: core scatter of every region's output vector into the global grids,
// with the physical clamps.
//
// Replaces (JAX package) speedy_ml_tpu/esn/domain.py: unpack_core_vector
// + scatter_core, and the q >= 1e-6 / precip < 1e-5 -> 0 clamps of
// HybridAtmosphere.assemble_global (hybrid/model.py:373-402).
// The cores tile the grid exactly once, so the scatter is written as a
// race-free gather: for every element e of the flat output
// [atmo (4, K, lat, lon), logp, precip (lat, lon)], table[e] is the
// offset of its value in the concatenation of the classes' flattened
// (Rc, O) output vectors (RegionLayout.core_source_table).
//   out[e] = vec[table[e]], then q = max(q, 1e-6), precip < 1e-5 -> 0.
//
// Bound on an H100 SXM (3.35 TB/s): memory, and tiny: 4*K*G + 2*G
// outputs (~157k at T30L8: table + values + out, ~2 MB, <1 us), so the
// launch dominates.  Design: ONE launch for all classes, one thread per
// output element; table/out accesses are coalesced, the vector reads
// scatter inside L2.  The comparisons keep NaN as the JAX clamps do.

#include "common.cuh"

struct ScatterArgs {
  const float* vec[MAX_CLASSES];
  long long start[MAX_CLASSES + 1];
  int n_classes;
};

__global__ void core_scatter_kernel(ScatterArgs a,
                                    const int* __restrict__ table,
                                    long long total, long long q0,
                                    long long q1, long long p0, long long p1,
                                    float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long s = table[e];
  if (s < 0 || s >= a.start[a.n_classes]) {
    out[e] = __int_as_float(0x7fc00000);  // a bad table shows as NaN
    return;
  }
  const int c = class_of(s, a.start, a.n_classes);
  float v = a.vec[c][s - a.start[c]];
  if (e >= q0 && e < q1) {
    v = (v < 1e-6f) ? 1e-6f : v;
  } else if (e >= p0 && e < p1) {
    v = (v < 1e-5f) ? 0.f : v;
  }
  out[e] = v;
}

// vec[c]: device pointer of class c's (Rc, O) outputs, counts[c] = Rc * O.
// [q0, q1) is the humidity block and [p0, p1) the precip block of out.
SPEEDY_API int core_scatter_launch(int device, int n_classes,
                                   void* const* vec, const long long* counts,
                                   const void* table, long long total,
                                   long long q0, long long q1, long long p0,
                                   long long p1, void* out, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n_classes < 1 || n_classes > MAX_CLASSES)
    return (int)cudaErrorInvalidValue;
  ScatterArgs a = {};
  a.start[0] = 0;
  for (int c = 0; c < n_classes; ++c) {
    a.vec[c] = (const float*)vec[c];
    a.start[c + 1] = a.start[c] + counts[c];
  }
  a.n_classes = n_classes;
  if (total == 0) return (int)cudaSuccess;
  const int block = 256;
  const unsigned grid = (unsigned)((total + block - 1) / block);
  core_scatter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      a, (const int*)table, total, q0, q1, p0, p1, (float*)out);
  return (int)cudaGetLastError();
}

// K3: window gather + input standardization for every region class.
//
// Replaces (JAX package) speedy_ml_tpu/esn/domain.py: class_patches /
// pack_vector, and Standardizer.standardize_input, as
// HybridAtmosphere.build_feedback (hybrid/model.py:477-493) chains them;
// in its date form also hybrid/model.py:525-544 tisr_field (K17b's plane)
// on the ML-only cycle.  Computes, for every class c and element k of its
// (Rc, I) output,
//   out_c[k] = (src[idx_c[k]] - in_mean_c[k]) / in_std_c[k]
// where src is the flat concatenation [atmo (4, K, lat, lon), logp,
// precip, sst, tisr (lat, lon)], and idx_c is the class's pack table
// (RegionLayout.pack_table: reference packing order, var fastest, then x,
// y, z, then the flat 2-D blocks).  The TISR plane is read, or worked out
// from the date where an element of it is read (window_gather.cuh, which
// holds the body; this source is compiled with -fmad=false, SOURCE_FLAGS
// in kernels/build.py, for sf_fsol's sake).
//
// Bound on an H100 SXM (3.35 TB/s): memory, but the work is tiny: about
// 650k outputs at T30 (idx, mean, std read, out written: ~10 MB, ~3 us),
// so a launch costs more than the transfer.  Design: ONE launch for all
// classes (class tables passed by value), one thread per output element;
// idx/mean/std/out accesses are coalesced, and the ~150 KB of source
// fields stay in L2 for the scattered reads.  In the date form the ~3% of
// the outputs that are TISR elements each work out their latitude's
// insolation (two sines, three cosines, an arccosine, a division), which
// saves the ML-only cycle the launch of K17b and the plane's round trip
// through device memory.  An index outside the source yields NaN
// (checked here, so the wrapper needs no device sync).  The
// device-scalar forms read the date, or the row of a TISR table, from
// device memory: a captured CUDA graph of the hybrid cycle
// (hybrid/graph.py) refills them before each replay.

#include "common.cuh"
#include "window_gather.cuh"

__global__ void window_gather_kernel(GatherArgs a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < a.start[a.n_classes]) window_gather_at(a, t);
}

// src: 5 device pointers (atmo, logp, precip, sst, tisr), tisr null for
// the date form; per class c the device pointers idx[c] (int32), mean[c],
// stdv[c], out[c] and its element count counts[c] (Rc * I).  The date
// form reads slat, clat (nlat floats), scal (SC_COUNT doubles,
// kernels/surface_forcing.py tisr_scalars) and nlon; the plane form none
// of them (null, 0).  The device-scalar forms: the date form with scal
// null and date_dev a device pointer to the date's scalars
// (sf_scalars_from's layout); the plane form with src[4] a TISR table and
// tisr_row a device pointer to its row (a double).  Both null otherwise.
SPEEDY_API int window_gather_launch(int device, void* const* src,
                                    long long atmo_size, long long grid_size,
                                    int n_classes, void* const* idx,
                                    void* const* mean, void* const* stdv,
                                    void* const* out,
                                    const long long* counts,
                                    const void* slat, const void* clat,
                                    const double* scal, int nlon,
                                    const double* date_dev,
                                    const double* tisr_row, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n_classes < 1 || n_classes > MAX_CLASSES ||
      (!src[4] && (!slat || !clat || !(scal || date_dev) || nlon <= 0)) ||
      (src[4] && date_dev) || (!src[4] && tisr_row))
    return (int)cudaErrorInvalidValue;
  static const double kNoDate[SC_COUNT] = {};
  GatherArgs a = window_gather_args(src, atmo_size, grid_size, n_classes,
                                    idx, mean, stdv, out, counts, slat, clat,
                                    scal ? scal : kNoDate, nlon);
  a.date_dev = date_dev;
  a.tisr_row = tisr_row;
  const long long total = a.start[n_classes];
  if (total == 0) return (int)cudaSuccess;
  const int block = 256;
  const unsigned grid = (unsigned)((total + block - 1) / block);
  window_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

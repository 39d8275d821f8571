// K3's per-element body, as CUDA device code and as plain C++
// (glue_host.cpp compiles this very file for the CPU tests).
//
// For every class c and element k of its (Rc, I) output,
//   out_c[k] = (src[idx_c[k]] - in_mean_c[k]) / in_std_c[k]
// where src is the flat concatenation [atmo (4, K, lat, lon), logp,
// precip, sst, tisr (lat, lon)] read through five pointers, and idx_c is
// the class's pack table.  The TISR plane comes in one of two forms: as a
// plane (src[4], the coupled cycle's window fsol), or, src[4] null, as
// the date: an element of the TISR block is then worked out where it is
// read, as sf_fsol of its latitude (surface_forcing.cuh, the function of
// K17b's point), which the source compiles without FMA contraction as
// surface_forcing.cu does, so it is K17b's value bit for bit.  Subtract
// and divide are round-to-nearest IEEE, as in the plain version.  An
// index outside the source yields NaN.
#pragma once

#include <string.h>

#include "surface_forcing.cuh"

// region classes a single launch can cover (the T30 layout has 3)
#define MAX_CLASSES 8

struct GatherArgs {
  const int* idx[MAX_CLASSES];
  const float* mean[MAX_CLASSES];
  const float* stdv[MAX_CLASSES];
  float* out[MAX_CLASSES];
  long long start[MAX_CLASSES + 1];
  const float* src[5];  // atmo, logp, precip, sst, tisr (null: the date)
  long long atmo_size;
  long long grid_size;
  int n_classes;
  // the date form: the latitudes' sines and cosines (nlat), the scalars
  // that sf_fsol reads (tyear, 2 pi, 4 SOLC / pi), nlon
  const float *slat, *clat;
  SfScalars<float> date;
  int nlon;
  // the device-scalar forms (null: the values above): the date's scalars
  // in device memory (sf_scalars_from's layout), read in place of date;
  // the row of a TISR table, a double in device memory: src[4] is then
  // the table (rows of grid_size) and the row is read where an element
  // of the TISR block is
  const double* date_dev;
  const double* tisr_row;
};

// Index of the class whose half-open [start[c], start[c+1]) holds t.
COL_HD int class_of(long long t, const long long* start, int n_classes) {
  int c = 0;
  while (c + 1 < n_classes && t >= start[c + 1]) ++c;
  return c;
}

COL_HD float wg_nan() {
#ifdef __CUDA_ARCH__
  return __int_as_float(0x7fc00000);
#else
  const unsigned bits = 0x7fc00000u;
  float v;
  memcpy(&v, &bits, sizeof v);
  return v;
#endif
}

// src[s], the source element s (NaN outside the source)
COL_HD float wg_source(const GatherArgs& a, long long s) {
  if (s < 0 || s >= a.atmo_size + 4 * a.grid_size) return wg_nan();
  if (s < a.atmo_size) return a.src[0][s];
  const long long s2 = s - a.atmo_size;
  const int f = (int)(s2 / a.grid_size);
  const long long g = s2 - (long long)f * a.grid_size;
  if (f == 3 && !a.src[4]) {
    const int j = (int)(g / a.nlon);
    if (a.date_dev) {
      SfScalars<float> d;
      sf_scalars_from(d, a.date_dev);
      return sf_fsol(d, a.slat[j], a.clat[j]);
    }
    return sf_fsol(a.date, a.slat[j], a.clat[j]);
  }
  if (f == 3 && a.tisr_row)
    return a.src[4][(long long)a.tisr_row[0] * a.grid_size + g];
  return a.src[1 + f][g];
}

// output element t of all the classes' outputs, in class order
COL_HD void window_gather_at(const GatherArgs& a, long long t) {
  const int c = class_of(t, a.start, a.n_classes);
  const long long k = t - a.start[c];
  const float v = wg_source(a, a.idx[c][k]);
#ifdef __CUDA_ARCH__
  a.out[c][k] = __fdiv_rn(__fsub_rn(v, a.mean[c][k]), a.stdv[c][k]);
#else
  a.out[c][k] = (v - a.mean[c][k]) / a.stdv[c][k];
#endif
}

// The launch's arguments (kernels/window_gather.py) as GatherArgs, on the
// host; n_classes in [1, MAX_CLASSES].
inline GatherArgs window_gather_args(void* const* src, long long atmo_size,
                                     long long grid_size, int n_classes,
                                     void* const* idx, void* const* mean,
                                     void* const* stdv, void* const* out,
                                     const long long* counts,
                                     const void* slat, const void* clat,
                                     const double* scal, int nlon) {
  GatherArgs a = {};
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
  if (!src[4]) {
    a.slat = (const float*)slat;
    a.clat = (const float*)clat;
    for (int k = 0; k < SC_COUNT; ++k) a.date.v[k] = (float)scal[k];
    a.nlon = nlon;
  }
  return a;
}

// K25 (random diabatic forcing: xs_rdf on shortwave steps and setrdf
// every step), for float and double, as CUDA device code and as plain C++
// (optional_host.cpp compiles this very file for the CPU tests).
//
// Replaces (JAX package) speedy_ml_tpu/physics/randfor.py:83-110 (xs_rdf,
// setrdf) and their use in physics/driver.py:277-288, which XLA fused into
// the physics step.
//
// Level k of the forcing, in the order of the plain version
// (kernels/rdf.py rdf_plain), every operation rounded apart:
// - on a shortwave step, for each latitude j the zonal sums, longitude 0
//   first and one longitude at a time, of tt_m (K9's tt_cnv + tt_lsc,
//   mode 0) and of the heating tt_rsw + (dfabs * rps) * grdscp[k]
//   (rdf_heat: the shortwave and longwave heating, mode 1), each times its
//   weight w[mode][k] (which holds 1/nlon); then, per mode, two passes of
//   v = 0.5 v + 0.25 (up + dn) over latitude with mirrored ends:
//   randfv[mode][j][k];
// - every step, tt[k][j][i] += h0[j][i] * v0[j] + h1[j][i] * v1[j], v
//   the new randfv on a shortwave step, the carried one on the others.
//
// The kernels cut a level's latitude rows into rdf_chunks(rows) chunks of
// rdf_chunk_rows(rows) rows (the last one shorter where they do not
// divide): at T30 eight chunks of 6 rows.  A chunk's rows of tt_m and of
// the heating sit in shared memory rows rdf_stride(nlon) apart.
//
// On a mesh (GCM.set_mesh) a shard holds a latitude band: the rows p0 ..
// p1 - 1 and their mirrors nlat - p1 .. nlat - p0 - 1 (parallel/mesh.py
// band_rows).  Its zonal sums are those of the band's rows; the sums of
// every band, gathered into latitude order, are smoothed as the whole
// ones are, and each band adds the forcing at its rows, row r reading the
// profiles at latitude rdf_band_lat(r).  So the result is the whole one's
// bit for bit.
#pragma once

#include "column_common.cuh"

constexpr int kRdfCluster = 8;   // the chunks of a level: a cluster's blocks

// The rows of a chunk of `rows` latitude rows, and the number of chunks.
COL_HD int rdf_chunk_rows(int rows) {
  return (rows + kRdfCluster - 1) / kRdfCluster;
}
COL_HD int rdf_chunks(int rows) {
  const int c = rdf_chunk_rows(rows);
  return (rows + c - 1) / c;
}
// Rows [r0, r0 + n) of chunk c (n may be 0 past the last row).
COL_HD void rdf_chunk(int rows, int c, int* r0, int* n) {
  const int rc = rdf_chunk_rows(rows);
  *r0 = c * rc;
  const int end = *r0 + rc < rows ? *r0 + rc : rows;
  *n = end > *r0 ? end - *r0 : 0;
}
// The shared row stride of a staged row (nlon reals), one more, so that
// the threads of a warp, a row each, read 32 banks.
COL_HD int rdf_stride(int nlon) { return nlon + 1; }

// The heating of mode 1 at one point: tt_rsw + (dfabs * rps) * gs.
template <typename T>
COL_HD T rdf_heat(T tt_rsw, T dfabs, T rps, T gs) {
  return gd_add(tt_rsw, gd_mul(gd_mul(dfabs, rps), gs));
}

// The weighted zonal sum of one staged row x (nlon), longitude 0 first.
template <typename T>
COL_HD T rdf_row_sum(const T* x, int nlon, T w) {
  T s = x[0];
  for (int i = 1; i < nlon; ++i) s = gd_add(s, x[i]);
  return gd_mul(s, w);
}

// One smoothing pass of latitude j: 0.5 v[j] + 0.25 (up + dn), up = v[j-1]
// (v[1] at j = 0), dn = v[j+1] (v[nlat-2] at the last row).
template <typename T>
COL_HD T rdf_smooth_at(const T* v, int nlat, int j) {
  const T up = j == 0 ? v[1] : v[j - 1];
  const T dn = j == nlat - 1 ? v[nlat - 2] : v[j + 1];
  return gd_add(gd_mul(T(0.5), v[j]), gd_mul(T(0.25), gd_add(up, dn)));
}

// The latitude of row r of the band of latitude pairs p0 .. p0 + nb - 1
// of nlat (the whole grid: p0 = 0, nb = nlat / 2, and the row itself).
COL_HD int rdf_band_lat(int r, int p0, int nb, int nlat) {
  return r < nb ? p0 + r : nlat - p0 - 2 * nb + r;
}

// The forcing of point (j, i) of level k added to tt in place: tt and h
// hold `rows` latitude rows, v0, v1 the latitude profiles of level k, read
// at latitude jv (row j's).
template <typename T>
COL_HD void rdf_add_at(const T* h, const T* v0, const T* v1, T* tt, int k,
                       int rows, int nlon, int j, int i, int jv) {
  const long long G = (long long)rows * nlon, p = (long long)j * nlon + i;
  const T f = gd_add(gd_mul(h[p], v0[jv]), gd_mul(h[G + p], v1[jv]));
  tt[(long long)k * G + p] = gd_add(tt[(long long)k * G + p], f);
}

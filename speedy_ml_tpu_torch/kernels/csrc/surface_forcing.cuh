// K17 (the window's entry: the climatological surface and the daily
// forcing's grid fields) and K17b (the TISR plane), for float and double,
// as CUDA device code and as plain C++ (glue_host.cpp compiles this very
// file for the CPU tests).
//
// Replaces (JAX package) speedy_ml_tpu/physics/land_sea.py:89-115
// forint, forin5 and :191-243 interp_climatology + init_surface_state;
// the grid part of PhysicsModel.daily_forcing
// (speedy_ml_tpu/physics/driver.py:132-175: snowc, the albedos, the two
// fields whose analysis gives tcorh and qcorh); the zonal solar rows of
// sol_oz_traced and solar_flux_traced (physics/radiation.py:118-160),
// stored as (lat, lon) planes; and, for K17b, the Hartmann insolation
// plane of HybridAtmosphere.tisr_field (hybrid/model.py:541-544).
//
// The arithmetic is written once, as functions of values: the surface of
// a point (sf_surface_v), the forcing planes that do not depend on the
// latitude (sf_forcing_v), and the solar rows split into their tyear
// terms (sf_year_sol, sf_year_zen) and a latitude's (sf_lat_fsol,
// sf_lat_zen).  K17's row block calls them (a latitude row a block, the
// solar terms worked out once a row: sf_block_*), and so do the
// per-point body (surface_forcing_at: the block's phases for one point,
// its row's solar terms worked out at the point, the host check's
// reference for the block's shared terms and barrier) and K17b's point
// (tisr_at), at the end.
//
// Every operation is the plain version's (kernels/surface_forcing.py),
// in its order and rounded apart (the source is compiled without FMA
// contraction), with the same functions (cosf, sinf, acosf, powf, expf:
// PyTorch's elementwise kernels call them too), so on the card the two
// give the same bits.  Two things differ from a literal transcription:
//   - a Python number divides a tensor (x / 180.0, snowd / SD2SC):
//     PyTorch's CUDA kernel multiplies by the reciprocal 1/c rounded in
//     the element type, its CPU kernel divides; sf_divs does the one or
//     the other (so the host build divides, as the CPU plain version);
//   - the month indices and weights, tyear and the constants that Python
//     works out in double (2 pi, 10/365, SSTFR, gamlat, pexp, ...) arrive
//     as the same Python numbers, rounded once to the element type, as a
//     PyTorch scalar operand is.
#pragma once

#include "column_common.cuh"
#include "column_moist.cuh"   // qsat_from_t

// the planes of the surface buffer (kernels/surface_forcing.py SURFACE)
enum {
  SF_STL, SF_SNOWD, SF_SOILW, SF_SST, SF_SICE, SF_TICE, SF_SST_AM, SF_ZERO,
  SF_PLANES
};
// the planes of the forcing buffer (kernels/surface_forcing.py FORCING);
// the first two are the input of the K5 analysis (tcorh, qcorh)
enum {
  FC_CORH, FC_QCORR, FC_FSOL, FC_OZUPP, FC_OZONE, FC_ZENIT, FC_STRATZ,
  FC_ALB_L, FC_ALB_S, FC_ALBSFC, FC_SNOWC, FC_PLANES
};
// the scalars of a call, in the order of kernels/surface_forcing.py
// SCALARS, and the integers, in the order of INDICES
enum {
  SC_WINT, SC_WM2, SC_WM1, SC_W0, SC_WP1, SC_WP2, SC_SSTFR, SC_SST_BIAS,
  SC_TYEAR, SC_TWO_PI, SC_DAY10, SC_PI, SC_OZ_A, SC_OZ_B, SC_CSOLP,
  SC_ALBICE_SEA, SC_GAMLAT, SC_PEXP, SC_COUNT
};
enum { IX_IMON, IX_IMON2, IX_IM2, IX_IM1, IX_IP1, IX_IP2, IX_COUNT };

template <typename T>
struct SfScalars {
  T v[SC_COUNT];
  int ix[IX_COUNT];
};

// The device-scalar form's SfScalars: d holds the SC_COUNT doubles, then
// the IX_COUNT integers as doubles (kernels/surface_forcing.py
// scalar_values, a row of the captured cycle's per-cycle block), rounded
// to the element type as the host arguments are, so both forms read the
// same values.
template <typename T>
COL_HD void sf_scalars_from(SfScalars<T>& s, const double* d) {
  for (int k = 0; k < SC_COUNT; ++k) s.v[k] = (T)d[k];
  for (int k = 0; k < IX_COUNT; ++k) s.ix[k] = (int)d[SC_COUNT + k];
}

// The operands (G = nlat * nlon points): the monthly tables (12, G); the
// hybrid SST (G) or null; alb0, fmask_l, fmask_s, phis0 (G); the given
// surface stl_am, snowd_am, sst_am, sice_am (G), read when no surface is
// made in the same call; slat, clat (nlat); the carried land temperature
// stl_lm (G) or null: the carry form, in which the forcing made with the
// surface reads it for stl_am (the persistent surface's window,
// hybrid/model.py), the surface planes staying as computed.  Out: the
// surface planes (SF_PLANES, G) or null, the forcing planes (FC_PLANES, G)
// or null.
template <typename T>
struct SfIO {
  const T *stl12, *snowd12, *soilw12, *sst12, *sice12, *sst_hyb;
  const T *alb0, *fmask_l, *fmask_s, *phis0;
  const T *stl_am, *snowd_am, *sst_am, *sice_am;
  const T *slat, *clat;
  const T* stl_carry;   // the carry form: the forcing's stl_am, or null

  T *sfc, *frc;
  long long G;
  int nlon;
  SfScalars<T> s;
};

// x / c, c a Python number (see the header)
template <typename T>
COL_HD T sf_divs(T x, T c) {
#ifdef __CUDA_ARCH__
  return x * (T(1) / c);
#else
  return x / c;
#endif
}
// torch.clamp's bounds, NaN passing through
template <typename T>
COL_HD T sf_min_at(T x, T hi) {
  return x > hi ? hi : x;
}
template <typename T>
COL_HD T sf_max_at(T x, T lo) {
  return x < lo ? lo : x;
}

// forint of one point's two months: a + wint (b - a), a the month imon,
// b imon2
template <typename T>
COL_HD T sf_forint_v(const SfScalars<T>& s, T a, T b) {
  return a + s.v[SC_WINT] * (b - a);
}

// forin5 of one point's five months f = (imon-2, imon-1, imon, imon+1,
// imon+2): wm2 f[0] + wm1 f[1] + w0 f[2] + wp1 f[3] + wp2 f[4], summed left
// to right
template <typename T>
COL_HD T sf_forin5_v(const SfScalars<T>& s, const T* f) {
  T acc = s.v[SC_WM2] * f[0];
  acc = acc + s.v[SC_WM1] * f[1];
  acc = acc + s.v[SC_W0] * f[2];
  acc = acc + s.v[SC_WP1] * f[3];
  return acc + s.v[SC_WP2] * f[4];
}

// the index (IX_*) of the k-th month that forin5 and forint read, in the
// order of their values above
COL_HD int sf_month5(int k) {
  return k == 0 ? IX_IM2 : k == 1 ? IX_IM1 : k == 2 ? IX_IMON
                                             : k == 3 ? IX_IP1 : IX_IP2;
}
COL_HD int sf_month2(int k) { return k == 0 ? IX_IMON : IX_IMON2; }

// The terms of solar_flux_traced that depend on tyear alone
template <typename T>
struct SfYearSol {
  T fdis, cdecl, sdecl, tdecl;
};
// ... and those of sol_oz_traced's ozone and zenith rows
template <typename T>
struct SfYearZen {
  T coz1, czen, szen;
};
// A latitude row's solar terms (what the forcing's solar planes read)
template <typename T>
struct SfRow {
  T fsol, oz, zenit;
};

// solar_flux_traced's tyear terms at s.v[SC_TYEAR]
template <typename T>
COL_HD SfYearSol<T> sf_year_sol(const SfScalars<T>& s) {
  const T alpha = s.v[SC_TWO_PI] * s.v[SC_TYEAR];
  const T ca1 = col_cos(alpha), sa1 = col_sin(alpha);
  const T ca2 = ca1 * ca1 - sa1 * sa1;
  const T sa2 = T(2) * sa1 * ca1;
  const T ca3 = ca1 * ca2 - sa1 * sa2;
  const T sa3 = sa1 * ca2 + sa2 * ca1;
  T decl = T(0.006918) - T(0.399912) * ca1;
  decl = decl + T(0.070257) * sa1;
  decl = decl - T(0.006758) * ca2;
  decl = decl + T(0.000907) * sa2;
  decl = decl - T(0.002697) * ca3;
  decl = decl + T(0.001480) * sa3;
  T fdis = T(1.000110) + T(0.034221) * ca1;
  fdis = fdis + T(0.001280) * sa1;
  fdis = fdis + T(0.000719) * ca2;
  fdis = fdis + T(0.000077) * sa2;
  SfYearSol<T> y;
  y.fdis = fdis;
  y.cdecl = col_cos(decl);
  y.sdecl = col_sin(decl);
  y.tdecl = y.sdecl / y.cdecl;
  return y;
}

// solar_flux_traced of one latitude from the tyear terms (csol = 4 SOLC,
// csolp = csol / pi)
template <typename T>
COL_HD T sf_lat_fsol(const SfScalars<T>& s, const SfYearSol<T>& y, T slat,
                     T clat) {
  const T ch0 = sf_min_at(sf_max_at(-y.tdecl * slat / clat, T(-1)), T(1));
  const T h0 = col_acos(ch0);
  const T sh0 = col_sin(h0);
  return s.v[SC_CSOLP] * y.fdis *
         (h0 * slat * y.sdecl + sh0 * clat * y.cdecl);
}

// solar_flux_traced at s.v[SC_TYEAR] for one latitude (K17b's point)
template <typename T>
COL_HD T sf_fsol(const SfScalars<T>& s, T slat, T clat) {
  return sf_lat_fsol(s, sf_year_sol(s), slat, clat);
}

// sol_oz_traced's tyear terms of the ozone and zenith rows
template <typename T>
COL_HD SfYearZen<T> sf_year_zen(const SfScalars<T>& s) {
  const T alpha = s.v[SC_TWO_PI] * (s.v[SC_TYEAR] + s.v[SC_DAY10]);
  const T calpha = col_cos(alpha);
  const T rzen = sf_divs(-calpha * T(23.45) * s.v[SC_PI], T(180));
  SfYearZen<T> z;
  z.coz1 = sf_max_at(calpha, T(0));
  z.czen = col_cos(rzen);
  z.szen = col_sin(rzen);
  return z;
}

// a latitude's ozone factor oz and zenit from the tyear terms
template <typename T>
COL_HD void sf_lat_zen(const SfScalars<T>& s, const SfYearZen<T>& z, T slat,
                       T clat, T& oz, T& zenit) {
  const T flat2 = T(1.5) * (slat * slat) - T(0.5);
  oz = s.v[SC_OZ_A] * (T(1) + z.coz1 * slat + T(1.8) * flat2);
  const T zd = T(1) - (clat * z.czen + slat * z.szen);
  zenit = T(1) + T(1) * (zd * zd);
}

// The row of latitude (slat, clat): fsol, oz, zenit
template <typename T>
COL_HD SfRow<T> sf_row(const SfScalars<T>& s, T slat, T clat) {
  SfRow<T> r;
  r.fsol = sf_lat_fsol(s, sf_year_sol(s), slat, clat);
  sf_lat_zen(s, sf_year_zen(s), slat, clat, r.oz, r.zenit);
  return r;
}

// The forcing's five solar planes of a point of row r: o[FC_FSOL ..
// FC_STRATZ]
template <typename T>
COL_HD void sf_solar_v(const SfScalars<T>& s, const SfRow<T>& r, T* o) {
  o[FC_FSOL] = r.fsol;
  o[FC_OZUPP] = r.fsol * s.v[SC_OZ_B] * r.zenit;
  o[FC_OZONE] = r.fsol * r.oz * r.zenit;
  o[FC_ZENIT] = r.zenit;
  o[FC_STRATZ] = sf_max_at(T(6) - r.fsol, T(0));
}

// The date's climatology of one point (interp_climatology): the
// interpolated months and the sea-ice adjustment (atm2sea), sst0 the
// adjustment's input (sstcl0)
template <typename T>
struct SfClim {
  T stl, snowd, soilw, sst0, sst, sice, tice;
};

// interp_climatology of one point from its months' values stl5, sst5
// (forin5's order) and snowd2, soilw2, sice2 (forint's)
template <typename T>
COL_HD SfClim<T> sf_climatology_v(const SfScalars<T>& s, const T* stl5,
                                  const T* sst5, const T* snowd2,
                                  const T* soilw2, const T* sice2) {
  SfClim<T> c;
  c.stl = sf_forin5_v(s, stl5);
  c.snowd = sf_forint_v(s, snowd2[0], snowd2[1]);
  c.soilw = sf_forint_v(s, soilw2[0], soilw2[1]);
  c.sst0 = sf_forin5_v(s, sst5);
  const T sice0 = sf_forint_v(s, sice2[0], sice2[1]);
  // the sea-ice adjustment (atm2sea)
  const T sstfr = s.v[SC_SSTFR];
  const bool warm = c.sst0 > sstfr;
  const T sice_w = sf_min_at(sice0, T(0.5));
  const T sst_w =
      sice_w > T(0) ? sstfr + (c.sst0 - sstfr) / (T(1) - sice_w) : c.sst0;
  const T sice_c = sf_max_at(sice0, T(0.5));
  const T tice_c = sstfr + (c.sst0 - sstfr) / sice_c;
  c.sst = warm ? sst_w : sstfr;
  c.sice = warm ? sice_w : sice_c;
  c.tice = warm ? sstfr : tice_c;
  return c;
}

// The months' values of point i that the climatology reads (the tables
// (12, G) in the order of sf_climatology_v's arguments)
template <typename T>
COL_HD void sf_load_months(const SfScalars<T>& s, const T* stl12,
                           const T* sst12, const T* snowd12,
                           const T* soilw12, const T* sice12, long long G,
                           long long i, T* stl5, T* sst5, T* snowd2,
                           T* soilw2, T* sice2) {
  for (int k = 0; k < 5; ++k) {
    stl5[k] = stl12[s.ix[sf_month5(k)] * G + i];
    sst5[k] = sst12[s.ix[sf_month5(k)] * G + i];
  }
  for (int k = 0; k < 2; ++k) {
    snowd2[k] = snowd12[s.ix[sf_month2(k)] * G + i];
    soilw2[k] = soilw12[s.ix[sf_month2(k)] * G + i];
    sice2[k] = sice12[s.ix[sf_month2(k)] * G + i];
  }
}

// The surface of one point (interp_climatology + init_surface_state) from
// its months' values stl5, sst5 (forin5's order) and snowd2, soilw2,
// sice2 (forint's) and the hybrid SST hyb (has_hyb): o[SF_*].
template <typename T>
COL_HD void sf_surface_v(const SfScalars<T>& s, const T* stl5, const T* sst5,
                         const T* snowd2, const T* soilw2, const T* sice2,
                         bool has_hyb, T hyb, T* o) {
  const SfClim<T> c = sf_climatology_v(s, stl5, sst5, snowd2, soilw2, sice2);
  // the hybrid SST (cpl_sea.f90:38-46), then the ice blend
  T sst_am = c.sst;
  if (has_hyb) {
    const T diff = sst_am - hyb;
    sst_am = (diff < T(6) ? hyb : sst_am) + s.v[SC_SST_BIAS];
  }
  sst_am = sst_am + c.sice * (c.tice - sst_am);
  o[SF_STL] = c.stl;
  o[SF_SNOWD] = c.snowd;
  o[SF_SOILW] = c.soilw;
  o[SF_SST] = c.sst;
  o[SF_SICE] = c.sice;
  o[SF_TICE] = c.tice;
  o[SF_SST_AM] = sst_am;
  o[SF_ZERO] = T(0);   // the ocean model's SST when icsea <= 0
}

// The forcing planes of one point that do not depend on the latitude
// (the albedos and the fields of the diffusion corrections,
// ini_fordate.f90:72-113), from the point's alb0, fmask_l (fl), fmask_s
// (fs), phis0 and the surface (stl_am, snowd_am, sst_am, sice_am):
// o[FC_CORH], o[FC_QCORR], o[FC_ALB_L .. FC_SNOWC].
template <typename T>
COL_HD void sf_forcing_v(const SfScalars<T>& s, T alb0, T fl, T fs, T phis0,
                         T stl_am, T snowd_am, T sst_am, T sice_am, T* o) {
  // the surface albedo
  const T snowc = sf_min_at(sf_divs(snowd_am, T(60)), T(1));
  const T alb_l = alb0 + snowc * (T(0.60) - alb0);
  const T alb_s = T(0.07) + sice_am * s.v[SC_ALBICE_SEA];
  const T corh = s.v[SC_GAMLAT] * phis0;
  const T tsfc = fl * stl_am + fs * sst_am;
  const T tref = tsfc + corh;
  const T psfc = col_pow(tsfc / tref, s.v[SC_PEXP]);
  const T qref = qsat_from_t(tref, T(1));
  const T qsfc = qsat_from_t(tsfc, psfc);
  o[FC_CORH] = corh;
  o[FC_QCORR] = T(0.7) * (qref - qsfc);
  o[FC_ALB_L] = alb_l;
  o[FC_ALB_S] = alb_s;
  o[FC_ALBSFC] = alb_s + fl * (alb_l - alb_s);
  o[FC_SNOWC] = snowc;
}

// ---- K17's row block: a latitude row j a block.  Its point threads
// (thread c on point c of the row, then c + the point threads, ...) issue
// every load of their point at once, form the surface planes and the
// forcing planes that do not depend on the latitude and store them;
// meanwhile lanes 0 and 1 of the solar warp work out the row's fsol and
// its oz and zenit (each with its own tyear terms) into shared memory
// (SfRow).  One barrier, then the point threads store the five solar
// planes.  Every value is the per-point body's, from the same functions.

// Phase 1 of point c of row j: every load, then the surface planes and
// the forcing planes of sf_forcing_v, stored
template <typename T>
COL_HD void sf_block_points(const SfIO<T>& io, int j, int c) {
  const SfScalars<T>& s = io.s;
  const long long G = io.G;
  const long long i = (long long)j * io.nlon + c;
  T stl5[5], sst5[5], snowd2[2], soilw2[2], sice2[2], hyb = T(0);
  T am[4] = {T(0), T(0), T(0), T(0)};
  T alb0 = T(0), fl = T(0), fs = T(0), phis0 = T(0);
  if (io.sfc) {
    sf_load_months(s, io.stl12, io.sst12, io.snowd12, io.soilw12, io.sice12,
                   G, i, stl5, sst5, snowd2, soilw2, sice2);
    if (io.sst_hyb) hyb = io.sst_hyb[i];
    if (io.stl_carry) am[0] = io.stl_carry[i];
  } else {
    am[0] = io.stl_am[i];
    am[1] = io.snowd_am[i];
    am[2] = io.sst_am[i];
    am[3] = io.sice_am[i];
  }
  if (io.frc) {
    alb0 = io.alb0[i];
    fl = io.fmask_l[i];
    fs = io.fmask_s[i];
    phis0 = io.phis0[i];
  }
  if (io.sfc) {
    T o[SF_PLANES];
    sf_surface_v(s, stl5, sst5, snowd2, soilw2, sice2, io.sst_hyb != nullptr,
                 hyb, o);
    for (int p = 0; p < SF_PLANES; ++p) io.sfc[p * G + i] = o[p];
    if (!io.stl_carry) am[0] = o[SF_STL];
    am[1] = o[SF_SNOWD];
    am[2] = o[SF_SST_AM];
    am[3] = o[SF_SICE];
  }
  if (!io.frc) return;
  T f[FC_PLANES];
  sf_forcing_v(s, alb0, fl, fs, phis0, am[0], am[1], am[2], am[3], f);
  io.frc[FC_CORH * G + i] = f[FC_CORH];
  io.frc[FC_QCORR * G + i] = f[FC_QCORR];
  for (int p = FC_ALB_L; p < FC_PLANES; ++p) io.frc[p * G + i] = f[p];
}

// Phase 1 of the solar warp's lane `lane` for row j: lane 0 the row's
// fsol, lane 1 its oz and zenit, into shared memory
template <typename T>
COL_HD void sf_block_solar(const SfIO<T>& io, SfRow<T>& row, int j,
                           int lane) {
  if (lane == 0)
    row.fsol = sf_lat_fsol(io.s, sf_year_sol(io.s), io.slat[j], io.clat[j]);
  else if (lane == 1)
    sf_lat_zen(io.s, sf_year_zen(io.s), io.slat[j], io.clat[j], row.oz,
               row.zenit);
}

// Phase 2 of point c of row j, after the barrier: the five solar planes
// from shared memory
template <typename T>
COL_HD void sf_block_solar_store(const SfIO<T>& io, const SfRow<T>& row,
                                 int j, int c) {
  const long long i = (long long)j * io.nlon + c;
  T o[FC_PLANES];
  sf_solar_v(io.s, row, o);
  for (int p = FC_FSOL; p <= FC_STRATZ; ++p) io.frc[p * io.G + i] = o[p];
}

// ---- the per-point body: one point (j, c) alone, its row's solar terms
// worked out again at the point (the first design's layout: the host
// check's reference for the row block), and K17b's point

// K17 at point i: the surface, the forcing, or the one then the other.
template <typename T>
COL_HD void surface_forcing_at(const SfIO<T>& io, long long i) {
  const int j = (int)(i / io.nlon), c = (int)(i % io.nlon);
  sf_block_points(io, j, c);
  if (io.frc)
    sf_block_solar_store(io, sf_row(io.s, io.slat[j], io.clat[j]), j, c);
}

// K17b at point i: the TISR plane, solar_flux_traced of the point's
// latitude (only SC_TYEAR, SC_TWO_PI and SC_CSOLP of the scalars are read)
template <typename T>
COL_HD void tisr_at(const SfScalars<T>& s, const T* slat, const T* clat,
                    int nlon, T* out, long long i) {
  const int j = (int)(i / nlon);
  out[i] = sf_fsol(s, slat[j], clat[j]);
}

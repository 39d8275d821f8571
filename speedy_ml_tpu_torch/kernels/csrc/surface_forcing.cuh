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
// plane of HybridAtmosphere.tisr_field (hybrid/model.py:541-544).  One
// point (j, i) of the grid a call: every latitude's solar row is worked
// out again by each point of that row, from the same scalars, so no
// point waits on another.
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

// The operands (G = nlat * nlon points): the monthly tables (12, G); the
// hybrid SST (G) or null; alb0, fmask_l, fmask_s, phis0 (G); the given
// surface stl_am, snowd_am, sst_am, sice_am (G), read when no surface is
// made in the same call; slat, clat (nlat).  Out: the surface planes
// (SF_PLANES, G) or null, the forcing planes (FC_PLANES, G) or null.
template <typename T>
struct SfIO {
  const T *stl12, *snowd12, *soilw12, *sst12, *sice12, *sst_hyb;
  const T *alb0, *fmask_l, *fmask_s, *phis0;
  const T *stl_am, *snowd_am, *sst_am, *sice_am;
  const T *slat, *clat;
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

// forint: a + wint (b - a), a the month imon, b imon2
template <typename T>
COL_HD T sf_forint(const T* f12, const SfScalars<T>& s, long long G,
                   long long i) {
  const T a = f12[s.ix[IX_IMON] * G + i];
  const T b = f12[s.ix[IX_IMON2] * G + i];
  return a + s.v[SC_WINT] * (b - a);
}

// forin5: wm2 f[imon-2] + wm1 f[imon-1] + w0 f[imon] + wp1 f[imon+1]
// + wp2 f[imon+2], summed left to right
template <typename T>
COL_HD T sf_forin5(const T* f12, const SfScalars<T>& s, long long G,
                   long long i) {
  T acc = s.v[SC_WM2] * f12[s.ix[IX_IM2] * G + i];
  acc = acc + s.v[SC_WM1] * f12[s.ix[IX_IM1] * G + i];
  acc = acc + s.v[SC_W0] * f12[s.ix[IX_IMON] * G + i];
  acc = acc + s.v[SC_WP1] * f12[s.ix[IX_IP1] * G + i];
  return acc + s.v[SC_WP2] * f12[s.ix[IX_IP2] * G + i];
}

// solar_flux_traced at s.v[SC_TYEAR] for one latitude (csol = 4 SOLC,
// csolp = csol / pi)
template <typename T>
COL_HD T sf_fsol(const SfScalars<T>& s, T slat, T clat) {
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
  const T cdecl = col_cos(decl), sdecl = col_sin(decl);
  const T tdecl = sdecl / cdecl;
  const T ch0 = sf_min_at(sf_max_at(-tdecl * slat / clat, T(-1)), T(1));
  const T h0 = col_acos(ch0);
  const T sh0 = col_sin(h0);
  return s.v[SC_CSOLP] * fdis * (h0 * slat * sdecl + sh0 * clat * cdecl);
}

// The surface of point i (interp_climatology + init_surface_state):
// writes the SF_* planes; returns stl, snowd, sst_am and sice, what the
// forcing reads.
template <typename T>
COL_HD void sf_surface_at(const SfIO<T>& io, long long i, T& stl, T& snowd,
                          T& sst_am, T& sice) {
  const SfScalars<T>& s = io.s;
  const long long G = io.G;
  stl = sf_forin5(io.stl12, s, G, i);
  snowd = sf_forint(io.snowd12, s, G, i);
  const T soilw = sf_forint(io.soilw12, s, G, i);
  const T sst0 = sf_forin5(io.sst12, s, G, i);
  const T sice0 = sf_forint(io.sice12, s, G, i);
  // the sea-ice adjustment (atm2sea)
  const T sstfr = s.v[SC_SSTFR];
  const bool warm = sst0 > sstfr;
  const T sice_w = sf_min_at(sice0, T(0.5));
  const T sst_w =
      sice_w > T(0) ? sstfr + (sst0 - sstfr) / (T(1) - sice_w) : sst0;
  const T sice_c = sf_max_at(sice0, T(0.5));
  const T tice_c = sstfr + (sst0 - sstfr) / sice_c;
  const T sst = warm ? sst_w : sstfr;
  sice = warm ? sice_w : sice_c;
  const T tice = warm ? sstfr : tice_c;
  // the hybrid SST (cpl_sea.f90:38-46), then the ice blend
  sst_am = sst;
  if (io.sst_hyb) {
    const T hyb = io.sst_hyb[i];
    const T diff = sst_am - hyb;
    sst_am = (diff < T(6) ? hyb : sst_am) + s.v[SC_SST_BIAS];
  }
  sst_am = sst_am + sice * (tice - sst_am);
  T* o = io.sfc;
  o[SF_STL * G + i] = stl;
  o[SF_SNOWD * G + i] = snowd;
  o[SF_SOILW * G + i] = soilw;
  o[SF_SST * G + i] = sst;
  o[SF_SICE * G + i] = sice;
  o[SF_TICE * G + i] = tice;
  o[SF_SST_AM * G + i] = sst_am;
  o[SF_ZERO * G + i] = T(0);   // the ocean model's SST when icsea <= 0
}

// The forcing of point i from the surface (stl_am, snowd_am, sst_am,
// sice_am): writes the FC_* planes.
template <typename T>
COL_HD void sf_forcing_at(const SfIO<T>& io, long long i, T stl_am,
                          T snowd_am, T sst_am, T sice_am) {
  const SfScalars<T>& s = io.s;
  const long long G = io.G;
  const int j = (int)(i / io.nlon);
  const T slat = io.slat[j], clat = io.clat[j];
  // the zonal solar forcing (sol_oz_traced)
  const T fsol = sf_fsol(s, slat, clat);
  const T alpha = s.v[SC_TWO_PI] * (s.v[SC_TYEAR] + s.v[SC_DAY10]);
  const T calpha = col_cos(alpha);
  const T coz1 = sf_max_at(calpha, T(0));
  const T rzen = sf_divs(-calpha * T(23.45) * s.v[SC_PI], T(180));
  const T czen = col_cos(rzen), szen = col_sin(rzen);
  const T flat2 = T(1.5) * (slat * slat) - T(0.5);
  const T oz = s.v[SC_OZ_A] * (T(1) + coz1 * slat + T(1.8) * flat2);
  const T zd = T(1) - (clat * czen + slat * szen);
  const T zenit = T(1) + T(1) * (zd * zd);
  // the surface albedo
  const T snowc = sf_min_at(sf_divs(snowd_am, T(60)), T(1));
  const T alb0 = io.alb0[i], fl = io.fmask_l[i];
  const T alb_l = alb0 + snowc * (T(0.60) - alb0);
  const T alb_s = T(0.07) + sice_am * s.v[SC_ALBICE_SEA];
  // the fields of the diffusion corrections (ini_fordate.f90:72-113)
  const T corh = s.v[SC_GAMLAT] * io.phis0[i];
  const T tsfc = fl * stl_am + io.fmask_s[i] * sst_am;
  const T tref = tsfc + corh;
  const T psfc = col_pow(tsfc / tref, s.v[SC_PEXP]);
  const T qref = qsat_from_t(tref, T(1));
  const T qsfc = qsat_from_t(tsfc, psfc);
  T* o = io.frc;
  o[FC_CORH * G + i] = corh;
  o[FC_QCORR * G + i] = T(0.7) * (qref - qsfc);
  o[FC_FSOL * G + i] = fsol;
  o[FC_OZUPP * G + i] = fsol * s.v[SC_OZ_B] * zenit;
  o[FC_OZONE * G + i] = fsol * oz * zenit;
  o[FC_ZENIT * G + i] = zenit;
  o[FC_STRATZ * G + i] = sf_max_at(T(6) - fsol, T(0));
  o[FC_ALB_L * G + i] = alb_l;
  o[FC_ALB_S * G + i] = alb_s;
  o[FC_ALBSFC * G + i] = alb_s + fl * (alb_l - alb_s);
  o[FC_SNOWC * G + i] = snowc;
}

// K17 at point i: the surface, the forcing, or the one then the other.
template <typename T>
COL_HD void surface_forcing_at(const SfIO<T>& io, long long i) {
  T stl, snowd, sst_am, sice;
  if (io.sfc) {
    sf_surface_at(io, i, stl, snowd, sst_am, sice);
  } else {
    stl = io.stl_am[i];
    snowd = io.snowd_am[i];
    sst_am = io.sst_am[i];
    sice = io.sice_am[i];
  }
  if (io.frc) sf_forcing_at(io, i, stl, snowd, sst_am, sice);
}

// K17b at point i: the TISR plane, solar_flux_traced of the point's
// latitude (only SC_TYEAR, SC_TWO_PI and SC_CSOLP of the scalars are read)
template <typename T>
COL_HD void tisr_at(const SfScalars<T>& s, const T* slat, const T* clat,
                    int nlon, T* out, long long i) {
  const int j = (int)(i / nlon);
  out[i] = sf_fsol(s, slat[j], clat[j]);
}

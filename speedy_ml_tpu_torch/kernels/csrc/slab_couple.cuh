// K21 (the persistent surface's flux accumulation and the daily slab
// coupler), for float and double, as CUDA device code and as plain C++
// (glue_host.cpp compiles this very file for the CPU tests).
//
// Replaces (JAX package) speedy_ml_tpu/physics/land_sea.py:244-325
// couple_daily and :327-331 sstan_for_window, the accumulation and the
// selects of the coupled cycle (hybrid/model.py:640-659) and the day
// loop's exchange (gcm.py:322-332).
//
// One grid point's work is one call of slab_couple_at, in three forms:
//   - accumulate: the flux sums acc + (ok ? window : 0), stored;
//   - couple: the same sums, then the date's climatology (K17's
//     sf_climatology_v, so its bits are K17's), the slab land model, the
//     sea and ice models, the sea-to-atmosphere SST of the icsea mode and
//     the ice blend; the coupled surface stored and the sums zeroed;
//   - day: the day's sums as given (no window, no store of sums), the
//     coupler with the observed anomaly forint'ed from three monthly
//     planes (sstan_for_window) at the date.
// The window's sums count only where ok (the cycle's gate) is true, by a
// select: a NaN of a skipped window never reaches the sums.
//
// Every operation is the plain version's (kernels/slab_couple.py), in its
// order and rounded apart (compiled without FMA contraction), so on the
// card the two give the same bits.  One operation differs from a literal
// transcription: a Python number divided by a tensor (anom0 / d) is
// PyTorch's reciprocal of d times the number, written so here.
#pragma once

#include "surface_forcing.cuh"

// the planes of the surface buffer, the fields of land_sea.SurfaceState
// in their order (kernels/slab_couple.py SURFACE_FIELDS)
enum {
  SL_STL_LM, SL_SST_OM, SL_TICE_OM, SL_SICE_OM, SL_STL_AM, SL_SNOWD_AM,
  SL_SOILW_AM, SL_SST_AM, SL_SICE_AM, SL_TICE_AM, SL_PLANES
};
// the planes of the flux sums (gcm.FluxAccumulator)
enum { FX_HFLUX_L, FX_HFLUX_S, FX_HFLUX_I, FX_PRECIP, FX_PLANES };
// the slab coefficients (land_sea.SlabCoeffs)
enum { CO_RHCAPL, CO_CDLAND, CO_RHCAPS, CO_RHCAPI, CO_CDSEA, CO_CDICE,
       CO_PLANES };
// the operands, in the order of the launch's pointer array
// (kernels/slab_couple.py INPUTS)
enum {
  IN_STL12, IN_SNOWD12, IN_SOILW12, IN_SST12, IN_SICE12, IN_OM12,
  IN_STL_LM, IN_SST_OM, IN_TICE_OM, IN_COEF, IN_WSST = IN_COEF + CO_PLANES,
  IN_SSTAN, IN_ACC = IN_SSTAN + 3, IN_WIN = IN_ACC + FX_PLANES,
  IN_OK = IN_WIN + FX_PLANES, IN_COUNT
};
// the integer options, in the order of kernels/slab_couple.py OPTIONS
enum {
  OP_ICLAND, OP_ICSEA, OP_ICICE, OP_ADD_ANOM, OP_BLEND, OP_DO_COUPLE,
  OP_AN2, OP_COUNT
};

// The operands (G points): the monthly tables (12, G) and the ocean
// model's SST climatology om12 (12, G; null: sst12); the carried surface's
// stl_lm, sst_om, tice_om; the slab coefficients; the elnino weights wsst
// (null unless blending); the observed anomaly: three monthly planes
// sstan[0..2] forint'ed with w_an between sstan[1] and sstan[an2], or
// sstan[1] alone (sstan[0] null), or none; the sums acc[4] (acc[3] may be
// null when no sums are stored); the window's sums win[4] (null: the day
// form) and the gate's flag ok (null: true).  Out: the surface (SL_PLANES,
// G) when coupling, the sums (FX_PLANES, G) when a window is given.
template <typename T>
struct SlabIO {
  const T *stl12, *snowd12, *soilw12, *sst12, *sice12, *om12;
  const T *stl_lm, *sst_om, *tice_om;
  const T* coef[CO_PLANES];
  const T* wsst;
  const T* sstan[3];
  const T* acc[FX_PLANES];
  const T* win[FX_PLANES];
  const bool* ok;
  T *sfc, *fx;
  long long G;
  SfScalars<T> s;   // K17's month indices and weights and SSTFR
  T w_an;
  int op[OP_COUNT];
};

// The coupled surface of one point (couple_daily) from the day's heat
// fluxes (f[FX_HFLUX_*]), the climatology c, the carry (stl_lm, sst_om,
// tice_om), the coefficients co[CO_*], the ocean model's climatology
// om0 (forin5 of om12), the anomaly an (has_an) and the elnino weight
// wsst: o[SL_*].
template <typename T>
COL_HD void slab_couple_v(const SlabIO<T>& io, const SfClim<T>& c,
                          const T* f, T stl_lm, T sst_om, T tice_om,
                          const T* co, T om0, T an, T wsst, T* o) {
  const T sstfr = io.s.v[SC_SSTFR];
  // land model (mod_cpl_land_model.f90:85-126)
  if (io.op[OP_ICLAND] > 0) {
    T tanom = stl_lm - c.stl;
    tanom = co[CO_CDLAND] * (tanom + co[CO_RHCAPL] * f[FX_HFLUX_L]);
    o[SL_STL_LM] = tanom + c.stl;
    o[SL_STL_AM] = o[SL_STL_LM];
  } else {
    o[SL_STL_LM] = c.stl;
    o[SL_STL_AM] = c.stl;
  }
  // sea and ice models (cpl_sea_model.f90:117-206), sice0 = the date's
  // climatological ice fraction
  const T sice0 = c.sice;
  T sst_om1 = sst_om, tice_om1 = tice_om;
  if (io.op[OP_ICSEA] > 0 || io.op[OP_ICICE] > 0) {
    const T dti = sstfr - tice_om;
    const T hflux = f[FX_HFLUX_S] - sice0 * (f[FX_HFLUX_I] + dti);
    T tanom_s = sst_om - c.sst;
    tanom_s = co[CO_CDSEA] * (tanom_s + co[CO_RHCAPS] * hflux);
    sst_om1 = tanom_s + c.sst;
    const T hflux_i = f[FX_HFLUX_I] + dti;
    T tanom_i = tice_om - c.tice;
    const T d = T(20) + (tanom_i < T(0) ? -tanom_i : tanom_i);
    const T cdis = co[CO_CDICE] * ((T(1) / d) * T(20));
    tanom_i = cdis * (tanom_i + co[CO_RHCAPI] * hflux_i);
    tice_om1 = tanom_i + c.tice;
  }
  // sea2atm (cpl_sea.f90:150-201)
  T sst_am;
  if (io.op[OP_ICSEA] <= 1) {
    sst_am = io.op[OP_ADD_ANOM] ? c.sst + an : c.sst;
  } else if (io.op[OP_ICSEA] == 2) {
    sst_am = sst_om1;
  } else {
    const T sstcl_om = om0 + (c.sst - c.sst0);
    T sstan_am = sst_om1 - sstcl_om;
    if (io.op[OP_BLEND]) sstan_am = sstan_am + wsst * (an - sstan_am);
    sst_am = c.sst + sstan_am;
  }
  T sice_am, tice_am;
  if (io.op[OP_ICICE] > 0) {
    sice_am = sice0;
    tice_am = tice_om1;
  } else {
    sice_am = c.sice;
    tice_am = c.tice;
  }
  o[SL_SST_OM] = sst_om1;
  o[SL_TICE_OM] = tice_om1;
  o[SL_SICE_OM] = c.sice;
  o[SL_SNOWD_AM] = c.snowd;
  o[SL_SOILW_AM] = c.soilw;
  o[SL_SST_AM] = sst_am + sice_am * (tice_am - sst_am);
  o[SL_SICE_AM] = sice_am;
  o[SL_TICE_AM] = tice_am;
}

// K21 at point i: every load first, then the sums and, when coupling, the
// coupled surface; stored.
template <typename T>
COL_HD void slab_couple_at(const SlabIO<T>& io, long long i) {
  const long long G = io.G;
  const bool couple = io.op[OP_DO_COUPLE] != 0;
  const bool okv = io.ok ? *io.ok : true;
  T f[FX_PLANES];
  for (int k = 0; k < FX_PLANES; ++k) f[k] = io.acc[k] ? io.acc[k][i] : T(0);
  if (io.win[0])
    for (int k = 0; k < FX_PLANES; ++k)
      f[k] = f[k] + (okv ? io.win[k][i] : T(0));
  if (!couple) {
    for (int k = 0; k < FX_PLANES; ++k) io.fx[k * G + i] = f[k];
    return;
  }
  T stl5[5], sst5[5], snowd2[2], soilw2[2], sice2[2], om5[5], co[CO_PLANES];
  sf_load_months(io.s, io.stl12, io.sst12, io.snowd12, io.soilw12,
                 io.sice12, G, i, stl5, sst5, snowd2, soilw2, sice2);
  const bool om = io.op[OP_ICSEA] >= 3;
  if (om)
    for (int k = 0; k < 5; ++k)
      om5[k] = io.om12 ? io.om12[io.s.ix[sf_month5(k)] * G + i] : sst5[k];
  const T stl_lm = io.stl_lm[i], sst_om = io.sst_om[i],
          tice_om = io.tice_om[i];
  for (int k = 0; k < CO_PLANES; ++k) co[k] = io.coef[k][i];
  T an = T(0), wsst = T(0);
  if (io.sstan[1]) {
    an = io.sstan[1][i];
    if (io.sstan[0]) {
      const T a2 = io.sstan[io.op[OP_AN2]][i];
      an = an + io.w_an * (a2 - an);
    }
  }
  if (io.wsst) wsst = io.wsst[i];
  const SfClim<T> c =
      sf_climatology_v(io.s, stl5, sst5, snowd2, soilw2, sice2);
  const T om0 = om ? sf_forin5_v(io.s, om5) : T(0);
  T o[SL_PLANES];
  slab_couple_v(io, c, f, stl_lm, sst_om, tice_om, co, om0, an, wsst, o);
  for (int p = 0; p < SL_PLANES; ++p) io.sfc[p * G + i] = o[p];
  if (io.fx)
    for (int k = 0; k < FX_PLANES; ++k) io.fx[k * G + i] = T(0);
}

// The operands of a launch: in[IN_COUNT] pointers (null where not read),
// the outputs, K17's scalars and month indices, the anomaly weight and the
// options
template <typename T>
COL_HD SlabIO<T> slab_io(long long G, const void* const* in, void* sfc,
                         void* fx, const double* scal, const int* ix,
                         double w_an, const int* op) {
  SlabIO<T> io;
  const T* const* p = (const T* const*)in;
  io.stl12 = p[IN_STL12];
  io.snowd12 = p[IN_SNOWD12];
  io.soilw12 = p[IN_SOILW12];
  io.sst12 = p[IN_SST12];
  io.sice12 = p[IN_SICE12];
  io.om12 = p[IN_OM12];
  io.stl_lm = p[IN_STL_LM];
  io.sst_om = p[IN_SST_OM];
  io.tice_om = p[IN_TICE_OM];
  for (int k = 0; k < CO_PLANES; ++k) io.coef[k] = p[IN_COEF + k];
  io.wsst = p[IN_WSST];
  for (int k = 0; k < 3; ++k) io.sstan[k] = p[IN_SSTAN + k];
  for (int k = 0; k < FX_PLANES; ++k) {
    io.acc[k] = p[IN_ACC + k];
    io.win[k] = p[IN_WIN + k];
  }
  io.ok = (const bool*)in[IN_OK];
  io.sfc = (T*)sfc;
  io.fx = (T*)fx;
  io.G = G;
  for (int k = 0; k < SC_COUNT; ++k) io.s.v[k] = (T)scal[k];
  for (int k = 0; k < IX_COUNT; ++k) io.s.ix[k] = ix[k];
  io.w_an = (T)w_an;
  for (int k = 0; k < OP_COUNT; ++k) io.op[k] = op[k];
  return io;
}

// What a launch may be given: 0 if the operands fit the options, else 1
COL_HD int slab_check(const void* const* in, const void* sfc, const void* fx,
                      const int* op) {
  const bool couple = op[OP_DO_COUPLE] != 0, window = in[IN_WIN] != nullptr;
  if (couple != (sfc != nullptr) || window != (fx != nullptr)) return 1;
  if (!couple && !window) return 1;
  for (int k = 0; k < FX_PLANES; ++k)
    if ((window && (!in[IN_WIN + k] || !in[IN_ACC + k])) ||
        (k < FX_PRECIP && !in[IN_ACC + k]))
      return 1;
  if (!couple) return 0;
  for (int k = IN_STL12; k <= IN_SICE12; ++k)
    if (!in[k]) return 1;
  for (int k = IN_STL_LM; k < IN_COEF + CO_PLANES; ++k)
    if (!in[k]) return 1;
  if ((op[OP_ADD_ANOM] || op[OP_BLEND]) && !in[IN_SSTAN + 1]) return 1;
  if (op[OP_BLEND] && !in[IN_WSST]) return 1;
  if (in[IN_SSTAN] && (!in[IN_SSTAN + 2] || (op[OP_AN2] != 0 &&
                                             op[OP_AN2] != 2)))
    return 1;
  return 0;
}

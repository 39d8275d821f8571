// K11 column body: the surface fluxes of one grid column (bulk formulas
// over land and sea, the land skin temperature from one Newton step of
// the energy balance, the land/sea blend), for float and double, as CUDA
// device code and as plain C++ (the host build of the CPU tests compiles
// this very file).
//
// Replaces (JAX package) speedy_ml_tpu/physics/surface.py:40 suflux.
// Every operation stands in the order of the plain PyTorch version
// (physics/surface.py suflux of the port) and is rounded apart (the
// sources that include this file are compiled without FMA contraction):
// three decisions (the lapse-rate stability, the skin-air and sea-air
// stability, evaporation > 0, which switches the Newton step's dqsat)
// fall as they do there.  Powers are written as PyTorch evaluates them:
// x ** 3 as x*x*x, x ** 4 with col_pow.
#pragma once

#include "column_common.cuh"
#include "column_moist.cuh"  // qsat_from_t

// The table blob (SurfaceTables.blob in kernels/surface_fluxes.py), all
// of type T: the scalars of suflux in the order of blob_scalars there.
template <typename T>
struct SurfaceTab {
  T fwind0, rcp, rdphi0, wvi2_bot, ftemp0, gtemp0, prd, vg2, ctday, rdth,
      astab, dtheta, cdl, chl, chlcp, esbc, esbc4, alhc, clambda, dclamb,
      cp, cds, chs, chscp;
  COL_HD explicit SurfaceTab(const T* s) {
    fwind0 = s[0]; rcp = s[1]; rdphi0 = s[2]; wvi2_bot = s[3];
    ftemp0 = s[4]; gtemp0 = s[5]; prd = s[6]; vg2 = s[7]; ctday = s[8];
    rdth = s[9]; astab = s[10]; dtheta = s[11]; cdl = s[12]; chl = s[13];
    chlcp = s[14]; esbc = s[15]; esbc4 = s[16]; alhc = s[17];
    clambda = s[18]; dclamb = s[19]; cp = s[20]; cds = s[21]; chs = s[22];
    chscp = s[23];
  }
};

// The operands, in the order of INPUTS in kernels/surface_fluxes.py:
// psg, clat (lat) and the (lat, lon) planes; ua, va, ta, qa, phi are
// (K, lat, lon) level fields, of which the two lowest levels are read.
constexpr int SURFACE_N_IN = 18;
template <typename T>
struct SurfaceIn {
  const T *psg, *ua, *va, *ta, *qa, *phi, *phi0, *fmask, *tland, *tsea,
      *swav, *ssrd, *slrd, *forog, *alb_l, *alb_s, *snowc, *clat;
};
template <typename T>
inline SurfaceIn<T> surface_in(const void* const* p) {
  SurfaceIn<T> in;
  const T** f[SURFACE_N_IN] = {
      &in.psg,  &in.ua,   &in.va,    &in.ta,    &in.qa,    &in.phi,
      &in.phi0, &in.fmask, &in.tland, &in.tsea, &in.swav,  &in.ssrd,
      &in.slrd, &in.forog, &in.alb_l, &in.alb_s, &in.snowc, &in.clat};
  for (int i = 0; i < SURFACE_N_IN; ++i) *f[i] = (const T*)p[i];
  return in;
}

// Column c of G (nlon columns a latitude row): load, body, store.  out
// (23, G): ustr, vstr, shf, evap, slru (land, sea, blend each), hfluxn
// (land, sea), tsfc, tskin, u0, v0, t0, q0 (kernels/surface_fluxes.py
// unpack).
template <typename T, int K>
COL_HD void surface_fluxes_at(int c, int G, int nlon, SurfaceIn<T> in,
                              const T* blob, T* out) {
  const SurfaceTab<T> tb(blob);
  const size_t bot = (size_t)(K - 1) * G + c, nl1 = (size_t)(K - 2) * G + c;
  const T psa = in.psg[c];
  const T ua = in.ua[bot], va = in.va[bot];
  const T ta = in.ta[bot], ta1 = in.ta[nl1];
  const T qa = in.qa[bot], phi = in.phi[bot];
  const T phi0 = in.phi0[c], w = in.fmask[c], tland = in.tland[c];
  const T tsea = in.tsea[c], swav = in.swav[c], ssrd = in.ssrd[c];
  const T slrd = in.slrd[c], forog = in.forog[c], alb_l = in.alb_l[c];
  const T alb_s = in.alb_s[c], snowc = in.snowc[c];
  const T clat = in.clat[c / nlon];
  const T zero = T(0);

  // 1. extrapolation to the surface
  const T u0 = tb.fwind0 * ua;
  const T v0 = tb.fwind0 * va;
  const T dt1 = tb.wvi2_bot * (ta - ta1);
  T t1_land = ta + dt1;
  T t1_sea = t1_land + phi0 * dt1 * tb.rdphi0;
  const T t2_sea = ta + tb.rcp * phi;
  const T t2_land = t2_sea - tb.rcp * phi0;
  const bool unstable = ta > ta1;
  t1_land = unstable ? tb.ftemp0 * t1_land + tb.gtemp0 * t2_land : ta;
  t1_sea = unstable ? tb.ftemp0 * t1_sea + tb.gtemp0 * t2_sea : ta;
  const T t0 = t1_sea + w * (t1_land - t1_sea);
  // density * wind speed with gustiness
  const T denvvs0 =
      (tb.prd * psa / t0) * col_sqrt(u0 * u0 + v0 * v0 + tb.vg2);

  // 2. land fluxes with the effective skin temperature
  T tskin = tland + tb.ctday * col_sqrt(clat) * ssrd * (T(1) - alb_l) * psa;
  const T dthl = tskin > t2_land
                     ? col_min(tskin - t2_land, tb.dtheta)
                     : col_max(tb.astab * (tskin - t2_land), -tb.dtheta);
  const T denvvs1 = denvvs0 * (T(1) + dthl * tb.rdth);
  const T cdldv = tb.cdl * denvvs0 * forog;
  const T ustr_l = -cdldv * ua;
  const T vstr_l = -cdldv * va;
  T shf_l = tb.chlcp * denvvs1 * (tskin - t1_land);
  const T q1 = qa;  // FHUM0 = 0: land and sea alike
  const T qsat_skin = qsat_from_t(tskin, psa);
  T evap_l = tb.chl * denvvs1 * col_max(swav * qsat_skin - q1, zero);

  // 3. land energy balance -> skin temperature Newton correction
  const T tsk3 = tskin * tskin * tskin;
  const T dslr = tb.esbc4 * tsk3;
  T slru_l = tb.esbc * tsk3 * tskin;
  T hflux_l =
      ssrd * (T(1) - alb_l) + slrd - (slru_l + shf_l + tb.alhc * evap_l);
  const T clamb = tb.clambda + snowc * tb.dclamb;
  hflux_l = hflux_l - clamb * (tskin - tland);
  const T dqsat =
      evap_l > zero ? swav * (qsat_from_t(tskin + T(1), psa) - qsat_skin)
                    : zero;
  const T dhfdt = clamb + dslr + tb.chl * denvvs1 * (tb.cp + tb.alhc * dqsat);
  const T dtskin = hflux_l / dhfdt;
  tskin = tskin + dtskin;
  shf_l = shf_l + tb.chlcp * denvvs1 * dtskin;
  evap_l = evap_l + tb.chl * denvvs1 * dqsat * dtskin;
  slru_l = slru_l + dslr * dtskin;
  hflux_l = clamb * (tskin - tland);

  // 4. sea fluxes
  const T dths = tsea > t2_sea
                     ? col_min(tsea - t2_sea, tb.dtheta)
                     : col_max(tb.astab * (tsea - t2_sea), -tb.dtheta);
  const T denvvs2 = denvvs0 * (T(1) + dths * tb.rdth);
  const T cdsdv = tb.cds * denvvs2;
  const T ustr_s = -cdsdv * ua;
  const T vstr_s = -cdsdv * va;
  const T shf_s = tb.chscp * denvvs2 * (tsea - t1_sea);
  const T evap_s = tb.chs * denvvs2 * (qsat_from_t(tsea, psa) - q1);
  const T slru_s = tb.esbc * col_pow(tsea, T(4));
  const T hflux_s =
      ssrd * (T(1) - alb_s) + slrd - (slru_s + shf_s + tb.alhc * evap_s);

  // 5. land/sea weighted averages, s + w * (l - s)
  const T vals[23] = {ustr_l, ustr_s, ustr_s + w * (ustr_l - ustr_s),
                      vstr_l, vstr_s, vstr_s + w * (vstr_l - vstr_s),
                      shf_l,  shf_s,  shf_s + w * (shf_l - shf_s),
                      evap_l, evap_s, evap_s + w * (evap_l - evap_s),
                      slru_l, slru_s, slru_s + w * (slru_l - slru_s),
                      hflux_l, hflux_s,
                      tsea + w * (tland - tsea),
                      tsea + w * (tskin - tsea),
                      u0, v0,
                      t1_sea + w * (t1_land - t1_sea),
                      q1 + w * (q1 - q1)};
#pragma unroll
  for (int i = 0; i < 23; ++i) out[(size_t)i * G + c] = vals[i];
}

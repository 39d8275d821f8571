// K11's part of K10a_down_surface: the surface fluxes of one grid column
// (bulk formulas over land and sea, the land skin temperature from one
// Newton step of the energy balance, the land/sea blend), for float and
// double, as CUDA device code and as plain C++ (the host build of the CPU
// tests compiles this very file).
//
// Replaces (JAX package) speedy_ml_tpu/physics/surface.py:40 suflux.
// Every operation stands in the order of the plain PyTorch version
// (physics/surface.py suflux of the port) and is rounded apart (the
// sources that include this file are compiled without FMA contraction):
// three decisions (the lapse-rate stability, the skin-air and sea-air
// stability, evaporation > 0, which switches the Newton step's dqsat)
// fall as they do there.  Powers are written as PyTorch evaluates them:
// x ** 3 as x*x*x, x ** 4 with col_pow.
//
// The body is two pieces, which the fused kernel's block
// (column_longwave.cuh, the dnsfc_block_* phases) runs on a warp of its
// own: sfc_head (the loads and every step that does not need the
// downward longwave at the surface, slrd, with the 14 planes that do not
// depend on it stored) while the other warps run the longwave, and
// sfc_tail (the steps from the first use of slrd on) after them.
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

// The surface operands (in the fused kernel's INPUTS order,
// kernels/column_longwave.py): psg, clat (lat) and the (lat, lon)
// planes; ua, va, ta, qa, phi are (K, lat, lon) level fields, of which
// the two lowest levels are read.
template <typename T>
struct SurfaceIn {
  const T *ta, *psg, *ua, *va, *qa, *phi, *phi0, *fmask, *tland, *tsea,
      *swav, *ssrd, *forog, *alb_l, *alb_s, *snowc, *clat;
};

// What the surface warp keeps in registers from sfc_head to sfc_tail:
// the land state before the Newton step, the sea fluxes and the terms of
// the two energy balances that do not hold slrd.
template <typename T>
struct SfcReg {
  T w, tland, tsea, tskin, denvvs1, shf_l, evap_l, slru_l, dslr, dqsat,
      dhfdt, clamb, shf_s, evap_s, slru_s;
  T hl_in, hl_out, hl_store;  // ssrd (1 - alb_l); slru + shf + alhc evap;
                              // clamb (tskin - tland)
  T hs_in, hs_out;            // ssrd (1 - alb_s); slru + shf + alhc evap
};

// Column c of G (nlon columns a latitude row), before slrd: the loads,
// 1. the extrapolation to the surface and density x wind, 2. the land
// fluxes with the skin temperature, 3. the land energy balance's terms
// and its Newton step's derivative, 4. the sea fluxes; the planes that
// do not depend on slrd stored.  out (23, G): ustr, vstr, shf, evap,
// slru (land, sea, blend each), hfluxn (land, sea), tsfc, tskin, u0, v0,
// t0, q0 (kernels/surface_fluxes.py unpack).
template <typename T, int K>
COL_HD void sfc_head(const SurfaceTab<T>& tb, const SurfaceIn<T>& in, int G,
                     int nlon, int c, T* out, SfcReg<T>& r) {
  const size_t bot = (size_t)(K - 1) * G + c, nl1 = (size_t)(K - 2) * G + c;
  const T psa = in.psg[c];
  const T ua = in.ua[bot], va = in.va[bot];
  const T ta = in.ta[bot], ta1 = in.ta[nl1];
  const T qa = in.qa[bot], phi = in.phi[bot];
  const T phi0 = in.phi0[c], w = in.fmask[c], tland = in.tland[c];
  const T tsea = in.tsea[c], swav = in.swav[c], ssrd = in.ssrd[c];
  const T forog = in.forog[c], alb_l = in.alb_l[c];
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
  const T tskin =
      tland + tb.ctday * col_sqrt(clat) * ssrd * (T(1) - alb_l) * psa;
  const T dthl = tskin > t2_land
                     ? col_min(tskin - t2_land, tb.dtheta)
                     : col_max(tb.astab * (tskin - t2_land), -tb.dtheta);
  const T denvvs1 = denvvs0 * (T(1) + dthl * tb.rdth);
  const T cdldv = tb.cdl * denvvs0 * forog;
  const T ustr_l = -cdldv * ua;
  const T vstr_l = -cdldv * va;
  const T shf_l = tb.chlcp * denvvs1 * (tskin - t1_land);
  const T q1 = qa;  // FHUM0 = 0: land and sea alike
  const T qsat_skin = qsat_from_t(tskin, psa);
  const T evap_l = tb.chl * denvvs1 * col_max(swav * qsat_skin - q1, zero);

  // 3. land energy balance -> skin temperature Newton correction: the
  // terms without slrd
  const T tsk3 = tskin * tskin * tskin;
  const T dslr = tb.esbc4 * tsk3;
  const T slru_l = tb.esbc * tsk3 * tskin;
  r.hl_in = ssrd * (T(1) - alb_l);
  r.hl_out = slru_l + shf_l + tb.alhc * evap_l;
  const T clamb = tb.clambda + snowc * tb.dclamb;
  r.hl_store = clamb * (tskin - tland);
  const T dqsat =
      evap_l > zero ? swav * (qsat_from_t(tskin + T(1), psa) - qsat_skin)
                    : zero;
  r.dhfdt = clamb + dslr + tb.chl * denvvs1 * (tb.cp + tb.alhc * dqsat);

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
  r.hs_in = ssrd * (T(1) - alb_s);
  r.hs_out = slru_s + shf_s + tb.alhc * evap_s;

  // 5., what does not depend on slrd: s + w * (l - s)
  const int now[14] = {0, 1, 2, 3, 4, 5, 7, 10, 13, 17, 19, 20, 21, 22};
  const T vals[14] = {ustr_l, ustr_s, ustr_s + w * (ustr_l - ustr_s),
                      vstr_l, vstr_s, vstr_s + w * (vstr_l - vstr_s),
                      shf_s, evap_s, slru_s,
                      tsea + w * (tland - tsea),
                      u0, v0,
                      t1_sea + w * (t1_land - t1_sea),
                      q1 + w * (q1 - q1)};
#pragma unroll
  for (int i = 0; i < 14; ++i) out[(size_t)now[i] * G + c] = vals[i];
  r.w = w;
  r.tland = tland;
  r.tsea = tsea;
  r.tskin = tskin;
  r.denvvs1 = denvvs1;
  r.shf_l = shf_l;
  r.evap_l = evap_l;
  r.slru_l = slru_l;
  r.dslr = dslr;
  r.dqsat = dqsat;
  r.clamb = clamb;
  r.shf_s = shf_s;
  r.evap_s = evap_s;
  r.slru_s = slru_s;
}

// Column c of G, given slrd: the rest of step 3 (the land energy balance
// and the Newton step of the skin temperature), the sea energy balance
// and the blends that depend on them; out as sfc_head's.
template <typename T>
COL_HD void sfc_tail(const SurfaceTab<T>& tb, const SfcReg<T>& r, T slrd,
                     int G, int c, T* out) {
  const T w = r.w, tland = r.tland, tsea = r.tsea, denvvs1 = r.denvvs1;
  T hflux_l = r.hl_in + slrd - r.hl_out;
  hflux_l = hflux_l - r.hl_store;
  const T dtskin = hflux_l / r.dhfdt;
  const T tskin = r.tskin + dtskin;
  const T shf_l = r.shf_l + tb.chlcp * denvvs1 * dtskin;
  const T evap_l = r.evap_l + tb.chl * denvvs1 * r.dqsat * dtskin;
  const T slru_l = r.slru_l + r.dslr * dtskin;
  hflux_l = r.clamb * (tskin - tland);
  const T hflux_s = r.hs_in + slrd - r.hs_out;

  const T shf_s = r.shf_s, evap_s = r.evap_s, slru_s = r.slru_s;
  const int later[9] = {6, 8, 9, 11, 12, 14, 15, 16, 18};
  const T vals[9] = {shf_l, shf_s + w * (shf_l - shf_s),
                     evap_l, evap_s + w * (evap_l - evap_s),
                     slru_l, slru_s + w * (slru_l - slru_s),
                     hflux_l, hflux_s,
                     tsea + w * (tskin - tsea)};
#pragma unroll
  for (int i = 0; i < 9; ++i) out[(size_t)later[i] * G + c] = vals[i];
}

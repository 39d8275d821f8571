// K12: the vertical diffusion of grid columns (shallow convection between
// the two lowest layers, moisture diffusion above the PBL, damping of
// super-adiabatic lapse rates) and the sums that close the physics step
// (radiative heating, the diffusion tendencies with the surface fluxes
// on the lowest level, the sea-ice heat flux), for float and double, as
// CUDA device code and as plain C++ (the host build of the CPU tests
// compiles this very file).
//
// Replaces (JAX package) speedy_ml_tpu/physics/vdiff.py:16 vdifsc and the
// sums of speedy_ml_tpu/physics/driver.py:258-275 and :298-307.  Every
// operation stands in the order of the plain PyTorch version
// (kernels/column_pbl.py column_pbl_plain) and is rounded apart.  Each
// level's accumulator receives its terms in the plain version's order:
// the super-adiabatic damping of layer k adds to every level below k in
// increasing k, as the double loop of vdifsc does.
//
// The arithmetic is three pieces: vdifsc of one column (vdifsc_body, the
// serial part), the sums of one level (pbl_level) and the sea-ice flux
// (pbl_ice_flux).  Two callers use them: column_pbl_at, one column in a
// row (the first design, kept for the host build), and the pbl_block_*
// phases of the kernel's block, C columns x K warps, warp k on level k,
// the pieces handing on through shared memory.  Both give the same bits.
// K12_pbl_flux is the same block with the window's flux sums of a
// leapfrog step (flux_accumulate.cuh) formed in its first phase, on the
// warp that forms the sea-ice flux.
#pragma once

#include "column_common.cuh"
#include "flux_accumulate.cuh"

// The table blob (PblTables.blob in kernels/column_pbl.py), all of type
// T: seven (K,) tables, then the scalars.  drh0 and fvdiq2 at level k
// belong to the layer pair (k, k+1); vdon[k] is 1 where vdifsc diffuses
// moisture above the PBL (sigh[k+1] > 0.5, k = 2..K-3), else 0.
template <typename T, int K>
struct PblTab {
  const T *rsig, *rsig1, *grdsig, *grdscp, *drh0, *fvdiq2, *vdon;
  T alhc, fshcse, fshcq, redshc1, segrad, fvdise, albdif, esbc, sstfr4;
  COL_HD explicit PblTab(const T* b)
      : rsig(b), rsig1(b + K), grdsig(b + 2 * K), grdscp(b + 3 * K),
        drh0(b + 4 * K), fvdiq2(b + 5 * K), vdon(b + 6 * K) {
    const T* s = b + 7 * K;
    alhc = s[0]; fshcse = s[1]; fshcq = s[2]; redshc1 = s[3];
    segrad = s[4]; fvdise = s[5]; albdif = s[6]; esbc = s[7];
    sstfr4 = s[8];
  }
};

// vdifsc of one column: the T and q tendencies (utend and vtend are 0).
template <typename T, int K>
COL_HD void vdifsc_body(const PblTab<T, K>& tb, const T (&se)[K],
                        const T (&rh)[K], const T (&qa)[K],
                        const T (&qsat)[K], const T (&phi)[K],
                        long long icnv, T (&tt)[K], T (&qt)[K]) {
  constexpr int nl1 = K - 2;
  const T zero = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) tt[k] = qt[k] = zero;

  // 2. shallow convection between the two lowest layers
  const T dmse = (se[K - 1] - se[nl1]) + tb.alhc * (qa[K - 1] - qsat[nl1]);
  const T drh = rh[K - 1] - rh[nl1];
  const T fcnv = T(1) - tb.redshc1 * (icnv > 0 ? T(1) : zero);
  const bool shallow = dmse >= zero;
  const T fluxse = shallow ? fcnv * tb.fshcse * dmse : zero;
  tt[nl1] = tt[nl1] + fluxse * tb.rsig[nl1];
  tt[K - 1] = tt[K - 1] - fluxse * tb.rsig[K - 1];
  const T fluxq_sc = (shallow && drh >= zero)
                         ? fcnv * tb.fshcq * qsat[K - 1] * drh : zero;
  const T fluxq_vd = (!shallow && drh >= tb.drh0[nl1])
                         ? tb.fvdiq2[nl1] * qsat[nl1] * drh : zero;
  const T fluxq = fluxq_sc + fluxq_vd;
  qt[nl1] = qt[nl1] + fluxq * tb.rsig[nl1];
  qt[K - 1] = qt[K - 1] - fluxq * tb.rsig[K - 1];

  // 3. moisture diffusion above the PBL (a table flag per layer pair)
#pragma unroll
  for (int k = 2; k < K - 2; ++k) {
    if (tb.vdon[k] != zero) {
      const T drhk = rh[k + 1] - rh[k];
      const T fq = drhk >= tb.drh0[k] ? tb.fvdiq2[k] * qsat[k] * drhk : zero;
      qt[k] = qt[k] + fq * tb.rsig[k];
      qt[k + 1] = qt[k + 1] - fq * tb.rsig[k + 1];
    }
  }

  // 4. damping of super-adiabatic lapse rate
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    const T se0 = se[k + 1] + tb.segrad * (phi[k] - phi[k + 1]);
    const T f = se[k] < se0 ? tb.fvdise * (se0 - se[k]) : zero;
    tt[k] = tt[k] + f * tb.rsig[k];
#pragma unroll
    for (int k1 = k + 1; k1 < K; ++k1) tt[k1] = tt[k1] - f * tb.rsig1[k];
  }
}

// The operands, in the order of INPUTS in kernels/column_pbl.py: level
// fields (K, G) se, rh, qg, qsat, phig, ttend, qtend (K9's), tt_rsw,
// dfabs_lw; icnv (G) int64; planes (G) rps, ustr, vstr (blends), shf_s,
// shf, evap_s, evap (blend), hflux_s, ssrd, tice, sice.
constexpr int PBL_N_IN = 21;
template <typename T>
struct PblIn {
  const T *se, *rh, *qg, *qsat, *phig, *ttend, *qtend, *tt_rsw, *dfabs;
  const long long* icnv;
  const T *rps, *ustr, *vstr, *shf_s, *shf, *evap_s, *evap, *hflux_s,
      *ssrd, *tice, *sice;
};
template <typename T>
inline PblIn<T> pbl_in(const void* const* p) {
  PblIn<T> in;
  const T** f[9] = {&in.se,    &in.rh,    &in.qg,     &in.qsat, &in.phig,
                    &in.ttend, &in.qtend, &in.tt_rsw, &in.dfabs};
  for (int i = 0; i < 9; ++i) *f[i] = (const T*)p[i];
  in.icnv = (const long long*)p[9];
  const T** g[11] = {&in.rps,    &in.ustr, &in.vstr,    &in.shf_s,
                     &in.shf,    &in.evap_s, &in.evap,  &in.hflux_s,
                     &in.ssrd,   &in.tice, &in.sice};
  for (int i = 0; i < 11; ++i) *g[i] = (const T*)p[10 + i];
  return in;
}

// K12_pbl_flux's operands beyond K12's, in the order of FLUX_INPUTS in
// kernels/column_pbl.py: the window's four running sums (hflux_l,
// hflux_s, hflux_i, precip), the step's land heat flux and its
// convective and large-scale precipitation (G each); rsteps =
// 1/nsteps_day and delt2.  The new sums are rows 4K+1..4K+4 of out.
constexpr int PBL_FLUX_N_IN = 7;
template <typename T>
struct PblFlux {
  const T *acc[4], *hflux_l, *precnv, *precls;
  T rsteps, delt2;
};
template <typename T>
inline PblFlux<T> pbl_flux(const void* const* p, double rsteps,
                           double delt2) {
  PblFlux<T> fl;
  for (int f = 0; f < 4; ++f) fl.acc[f] = (const T*)p[f];
  fl.hflux_l = (const T*)p[4];
  fl.precnv = (const T*)p[5];
  fl.precls = (const T*)p[6];
  fl.rsteps = (T)rsteps;
  fl.delt2 = (T)delt2;
  return fl;
}

// ---- the pieces of the sums, in the order of the plain version.  The
// per-column loop (column_pbl_at) and K12's block (the pbl_block_*
// phases) both call these, so they run the same operations.

// Level k of the sums of physics/driver.py, with the surface stresses and
// fluxes on the lowest level: utend, vtend, ttend, qtend from vdifsc's tt
// and qt, K9's ttend and qtend, the shortwave and longwave heating.
template <typename T>
struct PblLevel {
  T ut, vt, tt, qt;
};
template <typename T, int K>
COL_HD PblLevel<T> pbl_level(const PblTab<T, K>& tb, int k, T tt_pbl,
                             T qt_pbl, T ttend, T qtend, T tt_rsw, T dfabs,
                             T rps, T ustr, T vstr, T shf, T evap) {
  constexpr int bot = K - 1;
  const T zero = T(0);
  T ut = zero, vt = zero;
  if (k == bot) {
    ut = ut + ustr * rps * tb.grdsig[bot];
    vt = vt + vstr * rps * tb.grdsig[bot];
    tt_pbl = tt_pbl + shf * rps * tb.grdscp[bot];
    qt_pbl = qt_pbl + evap * rps * tb.grdsig[bot];
  }
  const T tt_rlw = dfabs * rps * tb.grdscp[k];
  PblLevel<T> o;
  o.ut = ut;
  o.vt = vt;
  o.tt = ttend + tt_rsw + tt_rlw + tt_pbl;
  o.qt = qtend + qt_pbl;
  return o;
}

// The sea-ice heat flux hflux_i; difice as in ppo_dmflux.f90:114-118.
template <typename T, int K>
COL_HD T pbl_ice_flux(const PblTab<T, K>& tb, T ssrd, T tice, T shf_s,
                      T evap_s, T hflux_s, T sice) {
  const T difice = tb.albdif * ssrd
                   + tb.esbc * (tb.sstfr4 - col_pow(tice, T(4)))
                   + shf_s + evap_s * tb.alhc;
  return hflux_s + difice * (T(1) - sice);
}

template <typename T, int K>
COL_HD void pbl_store(T* out, int G, int k, int c, const PblLevel<T>& o) {
  const size_t i = (size_t)k * G + c;
  out[i] = o.ut;
  out[(size_t)K * G + i] = o.vt;
  out[(size_t)(2 * K) * G + i] = o.tt;
  out[(size_t)(3 * K) * G + i] = o.qt;
}

// Column c of G: load, body, the sums, store (the first design, one
// column in a row).  out (4K + 1, G): utend, vtend, ttend, qtend (K
// each), hflux_i.
template <typename T, int K>
COL_HD void column_pbl_at(int c, int G, PblIn<T> in, const T* blob,
                          T* out) {
  const PblTab<T, K> tb(blob);
  T se[K], rh[K], qa[K], qsat[K], phi[K], tt[K], qt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t i = (size_t)k * G + c;
    se[k] = in.se[i];
    rh[k] = in.rh[i];
    qa[k] = in.qg[i];
    qsat[k] = in.qsat[i];
    phi[k] = in.phig[i];
  }
  vdifsc_body<T, K>(tb, se, rh, qa, qsat, phi, in.icnv[c], tt, qt);
  const T rps = in.rps[c];
  const T ustr = in.ustr[c], vstr = in.vstr[c], shf = in.shf[c],
          evap = in.evap[c];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t i = (size_t)k * G + c;
    pbl_store<T, K>(out, G, k, c,
                    pbl_level(tb, k, tt[k], qt[k], in.ttend[i], in.qtend[i],
                              in.tt_rsw[i], in.dfabs[i], rps, ustr, vstr,
                              shf, evap));
  }
  out[(size_t)(4 * K) * G + c] =
      pbl_ice_flux(tb, in.ssrd[c], in.tice[c], in.shf_s[c], in.evap_s[c],
                   in.hflux_s[c], in.sice[c]);
}

// ---- K12's block: C neighbouring columns, one warp (threadIdx.y) per
// level.  What one phase hands to the next lies in PblShared (the levels
// vdifsc reads, its tendencies) or, for a warp's own level, in PblReg,
// the thread's registers; each pbl_block_* function is what thread
// (x, k) of the block does between two barriers (x: the column in the
// block, c: the column in the grid).

template <typename T, int K, int C>
struct PblShared {
  T se[K][C], rh[K][C], qa[K][C], qsat[K][C], phi[K][C];  // load -> vdifsc
  T tt[K][C], qt[K][C];                                   // vdifsc -> sums
};

// What thread (x, k) keeps from the load to the sums: level k's other
// operands and the planes its level needs (the surface terms on the
// lowest level's warp, 0 elsewhere); icnv on warp 0, for vdifsc.
template <typename T>
struct PblReg {
  T ttend, qtend, tt_rsw, dfabs, rps, ustr, vstr, shf, evap;
  long long icnv;
};

// Phase 1, every warp: level k of vdifsc's five fields into shared
// memory, of the other four into registers, with rps; warp 0 loads icnv,
// the lowest level's warp the surface stresses and fluxes, and warp 1
// the sea-ice planes, whose flux hflux_i it stores now.  kFlux
// (K12_pbl_flux): warp 1 also loads the four sums and the step's other
// terms first, and stores the new sums beside hflux_i.
template <bool kFlux, typename T, int K, int C>
COL_HD void pbl_block_load(const PblTab<T, K>& tb, const PblIn<T>& in,
                           const PblFlux<T>& fl, int G, T* out,
                           PblShared<T, K, C>& sh, PblReg<T>& r, int c,
                           int x, int k) {
  if (c >= G) return;
  T acc[4], hflux_l, precnv, precls;
  if constexpr (kFlux) {
    if (k == 1) {
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[f] = fl.acc[f][c];
      hflux_l = fl.hflux_l[c];
      precnv = fl.precnv[c];
      precls = fl.precls[c];
    }
  }
  const size_t i = (size_t)k * G + c;
  sh.se[k][x] = in.se[i];
  sh.rh[k][x] = in.rh[i];
  sh.qa[k][x] = in.qg[i];
  sh.qsat[k][x] = in.qsat[i];
  sh.phi[k][x] = in.phig[i];
  r.ttend = in.ttend[i];
  r.qtend = in.qtend[i];
  r.tt_rsw = in.tt_rsw[i];
  r.dfabs = in.dfabs[i];
  r.rps = in.rps[c];
  r.icnv = k == 0 ? in.icnv[c] : 0;
  const bool bot = k == K - 1;
  r.ustr = bot ? in.ustr[c] : T(0);
  r.vstr = bot ? in.vstr[c] : T(0);
  r.shf = bot ? in.shf[c] : T(0);
  r.evap = bot ? in.evap[c] : T(0);
  if (k == 1) {
    const T hflux_s = in.hflux_s[c];
    const T hflux_i = pbl_ice_flux(tb, in.ssrd[c], in.tice[c], in.shf_s[c],
                                   in.evap_s[c], hflux_s, in.sice[c]);
    out[(size_t)(4 * K) * G + c] = hflux_i;
    if constexpr (kFlux) {
      T* o = out + (size_t)(4 * K + 1) * G;
      o[c] = flux_heat_sum(acc[0], hflux_l, fl.rsteps);
      o[(size_t)G + c] = flux_heat_sum(acc[1], hflux_s, fl.rsteps);
      o[(size_t)(2 * G) + c] = flux_heat_sum(acc[2], hflux_i, fl.rsteps);
      o[(size_t)(3 * G) + c] = flux_precip_sum(acc[3], precnv, precls,
                                               fl.delt2);
    }
  }
}

// Phase 2, one warp: vdifsc of column x.
template <typename T, int K, int C>
COL_HD void pbl_block_vdifsc(const PblTab<T, K>& tb, int G,
                             PblShared<T, K, C>& sh, const PblReg<T>& r,
                             int c, int x) {
  if (c >= G) return;
  T se[K], rh[K], qa[K], qsat[K], phi[K], tt[K], qt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    se[k] = sh.se[k][x];
    rh[k] = sh.rh[k][x];
    qa[k] = sh.qa[k][x];
    qsat[k] = sh.qsat[k][x];
    phi[k] = sh.phi[k][x];
  }
  vdifsc_body<T, K>(tb, se, rh, qa, qsat, phi, r.icnv, tt, qt);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sh.tt[k][x] = tt[k];
    sh.qt[k][x] = qt[k];
  }
}

// Phase 3, every warp: the sums of level k, stored.
template <typename T, int K, int C>
COL_HD void pbl_block_sums(const PblTab<T, K>& tb, int G, T* out,
                           const PblShared<T, K, C>& sh, const PblReg<T>& r,
                           int c, int x, int k) {
  if (c >= G) return;
  pbl_store<T, K>(out, G, k, c,
                  pbl_level(tb, k, sh.tt[k][x], sh.qt[k][x], r.ttend,
                            r.qtend, r.tt_rsw, r.dfabs, r.rps, r.ustr,
                            r.vstr, r.shf, r.evap));
}

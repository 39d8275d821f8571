// K12 column body: the vertical diffusion of one grid column (shallow
// convection between the two lowest layers, moisture diffusion above the
// PBL, damping of super-adiabatic lapse rates) and the sums that close
// the physics step (radiative heating, the diffusion tendencies with the
// surface fluxes on the lowest level, the sea-ice heat flux), for float
// and double, as CUDA device code and as plain C++ (the host build of the
// CPU tests compiles this very file).
//
// Replaces (JAX package) speedy_ml_tpu/physics/vdiff.py:16 vdifsc and the
// sums of speedy_ml_tpu/physics/driver.py:258-275 and :298-307.  Every
// operation stands in the order of the plain PyTorch version
// (kernels/column_pbl.py column_pbl_plain) and is rounded apart.  Each
// level's accumulator receives its terms in the plain version's order:
// the super-adiabatic damping of layer k adds to every level below k in
// increasing k, as the double loop of vdifsc does.
#pragma once

#include "column_common.cuh"

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

// Column c of G: load, body, the sums, store.  out (4K + 1, G): utend,
// vtend, ttend, qtend (K each), hflux_i.
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

  // the sums of physics/driver.py, with the surface fluxes on the lowest
  // level
  constexpr int bot = K - 1;
  const T zero = T(0);
  const T rps = in.rps[c];
  T* o_u = out;
  T* o_v = out + (size_t)K * G;
  T* o_t = out + (size_t)(2 * K) * G;
  T* o_q = out + (size_t)(3 * K) * G;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t i = (size_t)k * G + c;
    T tt_pbl = tt[k], qt_pbl = qt[k], ut = zero, vt = zero;
    if (k == bot) {
      ut = ut + in.ustr[c] * rps * tb.grdsig[bot];
      vt = vt + in.vstr[c] * rps * tb.grdsig[bot];
      tt_pbl = tt_pbl + in.shf[c] * rps * tb.grdscp[bot];
      qt_pbl = qt_pbl + in.evap[c] * rps * tb.grdsig[bot];
    }
    const T tt_rlw = in.dfabs[i] * rps * tb.grdscp[k];
    o_u[i] = ut;
    o_v[i] = vt;
    o_t[i] = in.ttend[i] + in.tt_rsw[i] + tt_rlw + tt_pbl;
    o_q[i] = in.qtend[i] + qt_pbl;
  }
  // difice as in ppo_dmflux.f90:114-118
  const T tice = in.tice[c];
  const T difice = tb.albdif * in.ssrd[c]
                   + tb.esbc * (tb.sstfr4 - col_pow(tice, T(4)))
                   + in.shf_s[c] + in.evap_s[c] * tb.alhc;
  out[(size_t)(4 * K) * G + c] =
      in.hflux_s[c] + difice * (T(1) - in.sice[c]);
}

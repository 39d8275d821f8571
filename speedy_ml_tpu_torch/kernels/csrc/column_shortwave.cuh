// K13 column body: the clouds and the shortwave step of one grid column
// (cloud cover and top, the two-band shortwave fluxes down and up, the
// longwave transmissivities tau2 for the next steps, the shortwave
// heating), for float and double, as CUDA device code and as plain C++
// (the host build of the CPU tests compiles this very file).
//
// Replaces (JAX package) speedy_ml_tpu/physics/radiation.py:165 cloud,
// :201 radsw and the do_sw branch of physics/driver.py:221-238.  Every
// operation stands in the order of the plain PyTorch version
// (kernels/column_shortwave.py column_shortwave_plain) and is rounded
// apart.  The cloud top icltop depends on the data: every level lookup is
// a select inside an unrolled loop, never an indexed register array.  The
// reference's quirk is kept: the downward pass replaces the cloud
// reflectivity of levels 2..K-1 by the reflected flux, while levels 0
// and 1 keep the reflectivity, which the upward pass then adds to the
// flux as it does the reflected flux of the levels below.
#pragma once

#include "column_common.cuh"

// The table blob (ShortwaveTables.blob in kernels/column_shortwave.py),
// all of type T: dsig, abs1 = ABSDRY + ABSAER sig^2, grdscp (K each), then
// the scalars.
template <typename T, int K>
struct ShortwaveTab {
  const T *dsig, *abs1, *grdscp;
  T rhcl1, rrcl, qacl, prfac, pmaxcl, wpcl, rgse, gse_s0, clsmax, clfact,
      clsminl, albcl, albcls, abscl1, abscl2, absdry, abswv1, abswv2,
      fband1, fband2, ablcl2, ablwin, ablco2, ablwv1, ablwv2, ablcl1, eps1;
  COL_HD explicit ShortwaveTab(const T* b)
      : dsig(b), abs1(b + K), grdscp(b + 2 * K) {
    const T* s = b + 3 * K;
    rhcl1 = s[0]; rrcl = s[1]; qacl = s[2]; prfac = s[3]; pmaxcl = s[4];
    wpcl = s[5]; rgse = s[6]; gse_s0 = s[7]; clsmax = s[8]; clfact = s[9];
    clsminl = s[10]; albcl = s[11]; albcls = s[12]; abscl1 = s[13];
    abscl2 = s[14]; absdry = s[15]; abswv1 = s[16]; abswv2 = s[17];
    fband1 = s[18]; fband2 = s[19]; ablcl2 = s[20]; ablwin = s[21];
    ablco2 = s[22]; ablwv1 = s[23]; ablwv2 = s[24]; ablcl1 = s[25];
    eps1 = s[26];
  }
};

// The operands, in the order of INPUTS in kernels/column_shortwave.py:
// level fields (K, G) qg, rh, se, phig; planes (G) precnv, precls, psg,
// rps, fmask, fsol, ozupp, ozone, zenit, stratz, albsfc; itop (G) int64.
constexpr int SHORTWAVE_N_IN = 16;
template <typename T>
struct ShortwaveIn {
  const T *qg, *rh, *se, *phig, *precnv, *precls, *psg, *rps, *fmask,
      *fsol, *ozupp, *ozone, *zenit, *stratz, *albsfc;
  const long long* itop;
};
template <typename T>
inline ShortwaveIn<T> shortwave_in(const void* const* p) {
  ShortwaveIn<T> in;
  const T** f[15] = {&in.qg,     &in.rh,    &in.se,    &in.phig,
                     &in.precnv, &in.precls, &in.psg,  &in.rps,
                     &in.fmask,  &in.fsol,  &in.ozupp, &in.ozone,
                     &in.zenit,  &in.stratz, &in.albsfc};
  for (int i = 0; i < 15; ++i) *f[i] = (const T*)p[i];
  in.itop = (const long long*)p[15];
  return in;
}

// Column c of G: load, clouds, shortwave, tau2, store.  out (5K + 5, G):
// tau2 (K, 4), stratc (2), tt_rsw (K), ssrd, ssr, tsr
// (kernels/column_shortwave.py unpack).
template <typename T, int K>
COL_HD void column_shortwave_at(int c, int G, ShortwaveIn<T> in,
                                const T* blob, T* out) {
  const ShortwaveTab<T, K> tb(blob);
  constexpr int nl1 = K - 2;
  const T zero = T(0), one = T(1);
  T qa[K], rh[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    qa[k] = in.qg[(size_t)k * G + c];
    rh[k] = in.rh[(size_t)k * G + c];
  }
  const T psa = in.psg[c];
  const T gse = (in.se[(size_t)nl1 * G + c] - in.se[(size_t)(K - 1) * G + c])
                / (in.phig[(size_t)nl1 * G + c]
                   - in.phig[(size_t)(K - 1) * G + c]);

  // ---- cloud: cover and top
  T cloudc = rh[nl1] > tb.rhcl1 ? rh[nl1] - tb.rhcl1 : zero;
  int icltop = rh[nl1] > tb.rhcl1 ? nl1 : K;
#pragma unroll
  for (int k = 2; k < K - 2; ++k) {
    const T drh = rh[k] - tb.rhcl1;
    if (drh > cloudc && qa[k] > tb.qacl) {
      cloudc = drh;
      icltop = k;
    }
  }
  const T cl1 = col_min(cloudc * tb.rrcl, one);
  const T pr1 = col_min(tb.prfac * (in.precnv[c] + in.precls[c]), tb.pmaxcl);
  cloudc = col_min(tb.wpcl * col_sqrt(pr1) + cl1 * cl1, one);
  const long long iptop = in.itop[c];
  if (iptop < icltop) icltop = (int)iptop;
  const T qcloud = qa[nl1];
  // stratiform clouds at the PBL top
  const T fstab = col_min(col_max(tb.rgse * (gse - tb.gse_s0), zero), one);
  T clstr = fstab * col_max(tb.clsmax - tb.clfact * cloudc, zero);
  const T clstrl = col_max(clstr, tb.clsminl) * rh[K - 1];
  clstr = clstr + in.fmask[c] * (clstrl - clstr);

  // ---- radsw: the cloud reflectivity (the band-3 slot of the
  // reference's tau2), then the transmissivities
  T tau_refl[K];
#pragma unroll
  for (int k = 0; k < K - 1; ++k)
    tau_refl[k] = (icltop == k) ? tb.albcl * cloudc : zero;
  tau_refl[K - 1] = tb.albcls * clstr;
  const T psaz = psa * in.zenit[c];
  const T acloud = cloudc * col_min(tb.abscl1 * qcloud, tb.abscl2);
  T tau1[K], taunir[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T deltap = psaz * tb.dsig[k];
    if (k == 0) {
      tau1[k] = col_exp(-deltap * tb.absdry);
      taunir[k] = one;
    } else {
      const T a = tb.abs1[k] + tb.abswv1 * qa[k];
      tau1[k] = (k < K - 1 && k >= icltop) ? col_exp(-deltap * (a + acloud))
                                            : col_exp(-deltap * a);
      taunir[k] = col_exp(-deltap * tb.abswv2 * qa[k]);
    }
  }

  const T fsol = in.fsol[c];
  T flux1 = fsol * tb.fband1;
  T flux2 = fsol * tb.fband2;
  T dfabs[K];
  // stratosphere: ozone absorption
  dfabs[0] = flux1;
  flux1 = tau1[0] * (flux1 - in.ozupp[c] * psa);
  dfabs[0] = dfabs[0] - flux1;
  dfabs[1] = flux1;
  flux1 = tau1[1] * (flux1 - in.ozone[c] * psa);
  dfabs[1] = dfabs[1] - flux1;
  // troposphere: cloud reflection + absorption
#pragma unroll
  for (int k = 2; k < K; ++k) {
    const T refl = flux1 * tau_refl[k];
    flux1 = flux1 - refl;
    dfabs[k] = flux1;
    flux1 = tau1[k] * flux1;
    dfabs[k] = dfabs[k] - flux1;
    tau_refl[k] = refl;  // reflected flux, reused upward
  }
#pragma unroll
  for (int k = 1; k < K; ++k) {
    dfabs[k] = dfabs[k] + flux2;
    flux2 = taunir[k] * flux2;
    dfabs[k] = dfabs[k] - flux2;
  }
  const T ssrd = flux1 + flux2;
  flux1 = flux1 * in.albsfc[c];
  const T ssr = ssrd - flux1;
  // upward absorption and cloud re-reflection
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    dfabs[k] = dfabs[k] + flux1;
    flux1 = tau1[k] * flux1;
    dfabs[k] = dfabs[k] - flux1;
    flux1 = flux1 + tau_refl[k];
  }
  const T tsr = fsol - flux1;

  // ---- LW transmissivities (tau2) for radlw, straight into (K, 4, G)
  const T acloud_lw = cloudc * tb.ablcl2;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T deltap = psa * tb.dsig[k];
    T t1, t3, t4;
    const T t2 = col_exp(-deltap * tb.ablco2);
    if (k == 0) {
      t1 = col_exp(-deltap * tb.ablwin);
      t3 = t4 = one;
    } else if (k == 1 || k == K - 1) {
      t1 = col_exp(-deltap * tb.ablwin);
      t3 = col_exp(-deltap * tb.ablwv1 * qa[k]);
      t4 = col_exp(-deltap * tb.ablwv2 * qa[k]);
    } else {
      const T acl1 = k < icltop ? acloud_lw : tb.ablcl1 * cloudc;
      t1 = col_exp(-deltap * (tb.ablwin + acl1));
      t3 = col_exp(-deltap * col_max(tb.ablwv1 * qa[k], acloud_lw));
      t4 = col_exp(-deltap * col_max(tb.ablwv2 * qa[k], acloud_lw));
    }
    out[(size_t)(4 * k + 0) * G + c] = t1;
    out[(size_t)(4 * k + 1) * G + c] = t2;
    out[(size_t)(4 * k + 2) * G + c] = t3;
    out[(size_t)(4 * k + 3) * G + c] = t4;
  }
  T* o = out + (size_t)(4 * K) * G;
  o[c] = in.stratz[c] * psa;
  o[(size_t)G + c] = tb.eps1 * psa;
  const T rps = in.rps[c];
#pragma unroll
  for (int k = 0; k < K; ++k)
    o[(size_t)(2 + k) * G + c] = dfabs[k] * rps * tb.grdscp[k];
  o[(size_t)(K + 2) * G + c] = ssrd;
  o[(size_t)(K + 3) * G + c] = ssr;
  o[(size_t)(K + 4) * G + c] = tsr;
}

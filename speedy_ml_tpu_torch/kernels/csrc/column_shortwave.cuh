// K13's arithmetic: the clouds and the shortwave step of a grid column
// (cloud cover and top, the two-band shortwave fluxes down and up, the
// longwave transmissivities tau2 for the next steps, the shortwave
// heating), for float and double, as CUDA device code and as plain C++
// (the host build of the CPU tests compiles this very file).  On the
// card it runs as phases 5-7 of K9_moist_shortwave's block
// (column_moist.cu), on the shortwave steps.
//
// Replaces (JAX package) speedy_ml_tpu/physics/radiation.py:165 cloud,
// :201 radsw and the do_sw branch of physics/driver.py:221-238.  Every
// operation stands in the order of the plain PyTorch version
// (kernels/column_shortwave.py column_shortwave_plain) and is rounded
// apart.  The cloud top icltop depends on the data: every level lookup is
// a select inside an unrolled loop, or a comparison of the level with
// icltop, never an indexed register array.  The reference's quirk is
// kept: the downward pass replaces the cloud reflectivity of levels
// 2..K-1 by the reflected flux, while levels 0 and 1 keep the
// reflectivity, which the upward pass then adds to the flux as it does
// the reflected flux of the levels below.
//
// The arithmetic is four pieces: the cloud of a column (sw_cloud), the
// transmissivities and reflectivity of one level (sw_level), the tau2 of
// one level (sw_tau2) and the fluxes down and up the column (sw_fluxes,
// the serial part: products and sums only).  Two callers use them:
// column_shortwave_at, one column in a row (the first design, K13, kept
// for the host build), and the sw_block_* phases of K9_moist_shortwave's
// block, C columns x K warps, the pieces handing on through shared
// memory.  Both give the same bits.
#pragma once

#include "column_common.cuh"
#include "column_moist.cuh"

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

// The first design's operands (column_shortwave_at, run by the host build
// of the tests; SW_INPUTS in tests/test_torch_column_kernels_b2.py):
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

// ---- the pieces, in the order of the plain version.  The per-column
// body (column_shortwave_at) and K9_moist_shortwave's block (the
// sw_block_* phases) both call these, so they run the same operations.

// The static stability of the lowest layer (driver.py's gse).
template <typename T>
COL_HD T sw_gse(T se2, T se1, T phi2, T phi1) {
  return (se2 - se1) / (phi2 - phi1);
}

// The cloud of one column: its top icltop (K where no level is cloudy),
// cover cloudc and stratiform cover clstr.  qa, rh: the column's levels;
// iptop: K9's itop; fmask: the land fraction.
template <typename T>
struct SwCloud {
  int icltop;
  T cloudc, clstr;
};
template <typename T, int K>
COL_HD SwCloud<T> sw_cloud(const ShortwaveTab<T, K>& tb, const T (&qa)[K],
                           const T (&rh)[K], T precnv, T precls,
                           long long iptop, T gse, T fmask) {
  constexpr int nl1 = K - 2;
  const T zero = T(0), one = T(1);
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
  const T pr1 = col_min(tb.prfac * (precnv + precls), tb.pmaxcl);
  cloudc = col_min(tb.wpcl * col_sqrt(pr1) + cl1 * cl1, one);
  if (iptop < icltop) icltop = (int)iptop;
  // stratiform clouds at the PBL top
  const T fstab = col_min(col_max(tb.rgse * (gse - tb.gse_s0), zero), one);
  T clstr = fstab * col_max(tb.clsmax - tb.clfact * cloudc, zero);
  const T clstrl = col_max(clstr, tb.clsminl) * rh[K - 1];
  clstr = clstr + fmask * (clstrl - clstr);
  SwCloud<T> cl;
  cl.icltop = icltop;
  cl.cloudc = cloudc;
  cl.clstr = clstr;
  return cl;
}

// The cloud absorptivity of the column's shortwave, from its cover and
// the humidity qcloud of level K-2.
template <typename T, int K>
COL_HD T sw_acloud(const ShortwaveTab<T, K>& tb, const SwCloud<T>& cl,
                   T qcloud) {
  return cl.cloudc * col_min(tb.abscl1 * qcloud, tb.abscl2);
}

// Level k of radsw before the fluxes: the cloud reflectivity (the band-3
// slot of the reference's tau2), the visible and near-infrared
// transmissivities.  psaz = psa * zenit.
template <typename T>
struct SwLevel {
  T tau1, taunir, refl;
};
template <typename T, int K>
COL_HD SwLevel<T> sw_level(const ShortwaveTab<T, K>& tb, int k, T qa,
                           T psaz, T acloud, const SwCloud<T>& cl) {
  const T zero = T(0), one = T(1);
  SwLevel<T> o;
  o.refl = k < K - 1 ? (cl.icltop == k ? tb.albcl * cl.cloudc : zero)
                     : tb.albcls * cl.clstr;
  const T deltap = psaz * tb.dsig[k];
  if (k == 0) {
    o.tau1 = col_exp(-deltap * tb.absdry);
    o.taunir = one;
  } else {
    const T a = tb.abs1[k] + tb.abswv1 * qa;
    o.tau1 = (k < K - 1 && k >= cl.icltop) ? col_exp(-deltap * (a + acloud))
                                            : col_exp(-deltap * a);
    o.taunir = col_exp(-deltap * tb.abswv2 * qa);
  }
  return o;
}

// The longwave transmissivities tau2 of level k, for radlw.
template <typename T, int K>
COL_HD void sw_tau2(const ShortwaveTab<T, K>& tb, int k, T qa, T psa,
                    const SwCloud<T>& cl, T (&t)[4]) {
  const T one = T(1);
  const T acloud_lw = cl.cloudc * tb.ablcl2;
  const T deltap = psa * tb.dsig[k];
  t[1] = col_exp(-deltap * tb.ablco2);
  if (k == 0) {
    t[0] = col_exp(-deltap * tb.ablwin);
    t[2] = t[3] = one;
  } else if (k == 1 || k == K - 1) {
    t[0] = col_exp(-deltap * tb.ablwin);
    t[2] = col_exp(-deltap * tb.ablwv1 * qa);
    t[3] = col_exp(-deltap * tb.ablwv2 * qa);
  } else {
    const T acl1 = k < cl.icltop ? acloud_lw : tb.ablcl1 * cl.cloudc;
    t[0] = col_exp(-deltap * (tb.ablwin + acl1));
    t[2] = col_exp(-deltap * col_max(tb.ablwv1 * qa, acloud_lw));
    t[3] = col_exp(-deltap * col_max(tb.ablwv2 * qa, acloud_lw));
  }
}

// The shortwave fluxes down and up the column: the absorbed flux of each
// level, ssrd, ssr, tsr.  refl comes in as each level's reflectivity and
// leaves with levels 2..K-1 holding their reflected flux.
template <typename T, int K>
COL_HD void sw_fluxes(const ShortwaveTab<T, K>& tb, const T (&tau1)[K],
                      const T (&taunir)[K], T (&refl)[K], T fsol, T ozupp,
                      T ozone, T psa, T albsfc, T (&dfabs)[K], T& ssrd,
                      T& ssr, T& tsr) {
  T flux1 = fsol * tb.fband1;
  T flux2 = fsol * tb.fband2;
  // stratosphere: ozone absorption
  dfabs[0] = flux1;
  flux1 = tau1[0] * (flux1 - ozupp * psa);
  dfabs[0] = dfabs[0] - flux1;
  dfabs[1] = flux1;
  flux1 = tau1[1] * (flux1 - ozone * psa);
  dfabs[1] = dfabs[1] - flux1;
  // troposphere: cloud reflection + absorption
#pragma unroll
  for (int k = 2; k < K; ++k) {
    const T r = flux1 * refl[k];
    flux1 = flux1 - r;
    dfabs[k] = flux1;
    flux1 = tau1[k] * flux1;
    dfabs[k] = dfabs[k] - flux1;
    refl[k] = r;  // reflected flux, reused upward
  }
#pragma unroll
  for (int k = 1; k < K; ++k) {
    dfabs[k] = dfabs[k] + flux2;
    flux2 = taunir[k] * flux2;
    dfabs[k] = dfabs[k] - flux2;
  }
  ssrd = flux1 + flux2;
  flux1 = flux1 * albsfc;
  ssr = ssrd - flux1;
  // upward absorption and cloud re-reflection
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    dfabs[k] = dfabs[k] + flux1;
    flux1 = tau1[k] * flux1;
    dfabs[k] = dfabs[k] - flux1;
    flux1 = flux1 + refl[k];
  }
  tsr = fsol - flux1;
}

// The output planes of the shortwave, (5K + 5, G): tau2 (K, 4), stratc
// (2), tt_rsw (K), ssrd, ssr, tsr (kernels/column_shortwave.py unpack).
template <typename T, int K>
COL_HD void sw_store_tau2(T* out, int G, int k, int c, const T (&t)[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) out[(size_t)(4 * k + b) * G + c] = t[b];
}
template <typename T, int K>
COL_HD void sw_store_column(const ShortwaveTab<T, K>& tb, T* out, int G,
                            int c, T psa, T rps, T stratz,
                            const T (&dfabs)[K], T ssrd, T ssr, T tsr) {
  T* o = out + (size_t)(4 * K) * G;
  o[c] = stratz * psa;
  o[(size_t)G + c] = tb.eps1 * psa;
#pragma unroll
  for (int k = 0; k < K; ++k)
    o[(size_t)(2 + k) * G + c] = dfabs[k] * rps * tb.grdscp[k];
  o[(size_t)(K + 2) * G + c] = ssrd;
  o[(size_t)(K + 3) * G + c] = ssr;
  o[(size_t)(K + 4) * G + c] = tsr;
}

// Column c of G: load, clouds, shortwave, tau2, store (the first design,
// K13, one column in a row).
template <typename T, int K>
COL_HD void column_shortwave_at(int c, int G, ShortwaveIn<T> in,
                                const T* blob, T* out) {
  const ShortwaveTab<T, K> tb(blob);
  constexpr int nl1 = K - 2;
  T qa[K], rh[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    qa[k] = in.qg[(size_t)k * G + c];
    rh[k] = in.rh[(size_t)k * G + c];
  }
  const T psa = in.psg[c];
  const T gse = sw_gse(in.se[(size_t)nl1 * G + c],
                       in.se[(size_t)(K - 1) * G + c],
                       in.phig[(size_t)nl1 * G + c],
                       in.phig[(size_t)(K - 1) * G + c]);
  const SwCloud<T> cl = sw_cloud(tb, qa, rh, in.precnv[c], in.precls[c],
                                 in.itop[c], gse, in.fmask[c]);
  const T psaz = psa * in.zenit[c];
  const T acloud = sw_acloud(tb, cl, qa[nl1]);
  T tau1[K], taunir[K], refl[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const SwLevel<T> lv = sw_level(tb, k, qa[k], psaz, acloud, cl);
    tau1[k] = lv.tau1;
    taunir[k] = lv.taunir;
    refl[k] = lv.refl;
  }
  T dfabs[K], ssrd, ssr, tsr;
  sw_fluxes(tb, tau1, taunir, refl, in.fsol[c], in.ozupp[c], in.ozone[c],
            psa, in.albsfc[c], dfabs, ssrd, ssr, tsr);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T t[4];
    sw_tau2(tb, k, qa[k], psa, cl, t);
    sw_store_tau2<T, K>(out, G, k, c, t);
  }
  sw_store_column(tb, out, G, c, psa, in.rps[c], in.stratz[c], dfabs, ssrd,
                  ssr, tsr);
}

// ---- K9_moist_shortwave's phases after K9's four (column_moist.cuh):
// the block of C neighbouring columns x K warps goes on with the
// shortwave of its columns.  What one phase hands to the next lies in
// SwShared, or, for what a thread loaded at the start, in SwReg; each
// sw_block_* function is what thread (x, k) of the block does between
// two barriers (x: the column in the block, c: the column in the grid).

// The planes the shortwave reads beyond K9's operands, in the order of
// SW_PLANES in kernels/column_shortwave.py, and its output (5K + 5, G).
constexpr int SW_N_PLANES = 7;
template <typename T>
struct SwIO {
  const T *fmask, *fsol, *ozupp, *ozone, *zenit, *stratz, *albsfc;
  T* out;
};
template <typename T>
inline SwIO<T> sw_io(const void* const* p, void* out) {
  SwIO<T> io;
  const T** f[SW_N_PLANES] = {&io.fmask, &io.fsol,   &io.ozupp, &io.ozone,
                              &io.zenit, &io.stratz, &io.albsfc};
  for (int i = 0; i < SW_N_PLANES; ++i) *f[i] = (const T*)p[i];
  io.out = (T*)out;
  return io;
}

template <typename T, int K, int C>
struct SwShared {
  T rh[K][C];                              // phase 1 -> 5
  T phi[2][C];                             // phig at K-2, K-1: 1 -> 5
  int icltop[C];                           // phase 5 -> 6
  T cloudc[C], clstr[C];
  T tau1[K][C], taunir[K][C], refl[K][C];  // phase 6 -> 7
};

// What thread (x, k) keeps in registers: zenit on every warp; on warp 0,
// which runs phases 4, 5 and 7, the other planes and K9's final itop and
// precls from its close.
template <typename T>
struct SwReg {
  T zenit, fmask, fsol, ozupp, ozone, stratz, albsfc, precls;
  int itop;
};

// At the kernel's start, before K9's phase 1: the plane loads, in flight
// through K9's four phases.
template <typename T>
COL_HD void sw_block_start(const MoistIO<T>& io, const SwIO<T>& sw,
                           SwReg<T>& r, int c, int k) {
  if (c >= io.G) return;
  r.zenit = sw.zenit[c];
  if (k != 0) return;
  r.fmask = sw.fmask[c];
  r.fsol = sw.fsol[c];
  r.ozupp = sw.ozupp[c];
  r.ozone = sw.ozone[c];
  r.stratz = sw.stratz[c];
  r.albsfc = sw.albsfc[c];
}

// Phase 1 (after K9's moist_block_levels, every warp): level k's rh, and
// phig of the two lowest levels, into shared memory.
template <typename T, int K, int C>
COL_HD void sw_block_keep(const MoistIO<T>& io, SwShared<T, K, C>& sw, T rh,
                          int c, int x, int k) {
  if (c >= io.G) return;
  sw.rh[k][x] = rh;
  if (k >= K - 2) sw.phi[k - (K - 2)][x] = io.phig[(size_t)k * io.G + c];
}

// Phase 5 (warp 0, right after K9's close on the same warp): the cloud of
// column x.
template <typename T, int K, int C>
COL_HD void sw_block_cloud(const ShortwaveTab<T, K>& tb, const MoistIO<T>& io,
                           const MoistShared<T, K, C>& sh,
                           SwShared<T, K, C>& sw, const SwReg<T>& r, int c,
                           int x) {
  if (c >= io.G) return;
  T qa[K], rh[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    qa[k] = sh.q[k][x];
    rh[k] = sw.rh[k][x];
  }
  const T gse = sw_gse(sh.se[K - 2][x], sh.se[K - 1][x], sw.phi[0][x],
                       sw.phi[1][x]);
  const SwCloud<T> cl = sw_cloud(tb, qa, rh, sh.precnv[x], r.precls,
                                 (long long)r.itop, gse, r.fmask);
  sw.icltop[x] = cl.icltop;
  sw.cloudc[x] = cl.cloudc;
  sw.clstr[x] = cl.clstr;
}

// Phase 6, every warp: level k's transmissivities and reflectivity into
// shared memory, its tau2 stored.
template <typename T, int K, int C>
COL_HD void sw_block_level(const ShortwaveTab<T, K>& tb, const MoistIO<T>& io,
                           const SwIO<T>& out, const MoistShared<T, K, C>& sh,
                           SwShared<T, K, C>& sw, const SwReg<T>& r, int c,
                           int x, int k) {
  if (c >= io.G) return;
  SwCloud<T> cl;
  cl.icltop = sw.icltop[x];
  cl.cloudc = sw.cloudc[x];
  cl.clstr = sw.clstr[x];
  const T psa = col_exp(io.pslg[c]);
  const T qa = sh.q[k][x];
  const SwLevel<T> lv = sw_level(tb, k, qa, psa * r.zenit,
                                 sw_acloud(tb, cl, sh.q[K - 2][x]), cl);
  sw.tau1[k][x] = lv.tau1;
  sw.taunir[k][x] = lv.taunir;
  sw.refl[k][x] = lv.refl;
  T t[4];
  sw_tau2(tb, k, qa, psa, cl, t);
  sw_store_tau2<T, K>(out.out, io.G, k, c, t);
}

// Phase 7 (warp 0): the fluxes down and up column x from shared memory,
// and the column's other planes stored (tt_rsw of every level, each
// store coalesced across the warp's 32 columns).
template <typename T, int K, int C>
COL_HD void sw_block_fluxes(const ShortwaveTab<T, K>& tb,
                            const MoistIO<T>& io, const SwIO<T>& out,
                            const SwShared<T, K, C>& sw, const SwReg<T>& r,
                            int c, int x) {
  if (c >= io.G) return;
  T tau1[K], taunir[K], refl[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    tau1[k] = sw.tau1[k][x];
    taunir[k] = sw.taunir[k][x];
    refl[k] = sw.refl[k][x];
  }
  const T psa = col_exp(io.pslg[c]);
  T dfabs[K], ssrd, ssr, tsr;
  sw_fluxes(tb, tau1, taunir, refl, r.fsol, r.ozupp, r.ozone, psa, r.albsfc,
            dfabs, ssrd, ssr, tsr);
  sw_store_column(tb, out.out, io.G, c, psa, T(1) / psa, r.stratz, dfabs,
                  ssrd, ssr, tsr);
}

// K10 column bodies: the 4-band longwave recursions of one grid column,
// downward (K10a_down_surface, with K11's surface fluxes) and upward
// (K10b, radlw_up), for float and double, as CUDA device code and as
// plain C++ (the host build of the CPU tests compiles this very file).
//
// Replaces (JAX package) speedy_ml_tpu/physics/radiation.py:318
// radlw_down, :381 radlw_up and :38 _fband_lookup, and, through
// column_surface.cuh, physics/surface.py:40 suflux.  Every operation
// stands in the order of the plain PyTorch version (physics/radiation.py
// and physics/surface.py of the port) and is rounded apart.  The plain
// version loops bands outside and levels inside; here a level's band
// terms are formed on its own warp and each band's recursion runs on a
// warp of its own: each band's flux recursion and each level's
// absorbed-flux sum see the same operations in the same order either
// way.
//
// Both passes are blocks of C columns x K warps (the downward pass with
// a surface warp beside them) handing on through shared memory: the
// dnsfc_block_* phases (K10a_down_surface) and the lwup_block_* phases
// (K10b); down_surface_at and radlw_up_at run them for one column (C =
// 1: the host build's loop).
#pragma once

#include "column_common.cuh"
#include "column_surface.cuh"

// The table blob (LongwaveTables.blob in kernels/column_longwave.py),
// all of type T: wvi2 (K), dsig (K), then the scalars.
template <typename T, int K>
struct LongwaveTab {
  const T *wvi2, *dsig;
  T sbc, eps1, emisfc, refsfc, epslw, corlw;
  COL_HD explicit LongwaveTab(const T* b) : wvi2(b), dsig(b + K) {
    const T* s = b + 2 * K;
    sbc = s[0]; eps1 = s[1]; emisfc = s[2]; refsfc = s[3]; epslw = s[4];
    corlw = s[5];
  }
};

// The four band energy fractions at round(T) clipped to [200, 320]
// (radiation.py _fband_lookup: f2, f3, f4, then eps1 - (f2 + f3 + f4)).
template <typename T>
COL_HD void fband4(T ta, T eps1, T (&f)[4]) {
  const T tc = col_min(col_max(col_rint(ta), T(200.0)), T(320.0));
  const T d2 = tc - T(247.0), d3 = tc - T(282.0), d4 = tc - T(315.0);
  f[1] = (T(0.148) - T(3.0e-6) * (d2 * d2)) * eps1;
  f[2] = (T(0.356) - T(5.2e-6) * (d3 * d3)) * eps1;
  f[3] = (T(0.314) + T(1.0e-5) * (d4 * d4)) * eps1;
  f[0] = eps1 - (f[1] + f[2] + f[3]);
}

// ---- K10a_down_surface's block: C neighbouring columns, one warp
// (threadIdx.y) per level k and the surface warp k = K.  Each
// dnsfc_block_* function is what thread (x, k) of the block does between
// two barriers (x: the column in the block, c: the column in the grid).
// Warp k < K forms level k's Planck terms and band terms; after a barrier
// of the level warps alone, warps 0-3 run one band's downward recursion
// each.  The surface warp meanwhile runs the surface fluxes as far as
// they go without slrd, through both phases, and meets the level warps
// at the second barrier; then warp k < K sums level k's absorbed flux,
// and the surface warp forms slrd from the four band fluxes at the
// surface and finishes the surface fluxes.

template <typename T, int K, int C>
struct LwDownShared {
  static_assert(K >= 4, "the four band recursions need four warps");
  T tau[K][4][C];   // tau2
  T src[K][4][C];   // emis * brad: what level k adds to band jb's flux
  T fout[K][4][C];  // band jb's flux leaving level k downward
  T corlw[C];       // the black-band correction EPSLW EMISFC st4a_mean[K-1]
};

// The operands, in the order of INPUTS in kernels/column_longwave.py:
// ta (K, lat, lon), tau2 (K, 4, lat, lon), then the surface fluxes' (ta
// among them, once).
constexpr int DOWN_SURFACE_N_IN = 18;
template <typename T>
struct DownSurfaceIn {
  const T* tau2;
  SurfaceIn<T> s;
};
template <typename T>
inline DownSurfaceIn<T> down_surface_in(const void* const* p) {
  DownSurfaceIn<T> in;
  const T** f[DOWN_SURFACE_N_IN] = {
      &in.s.ta,    &in.tau2,    &in.s.psg,   &in.s.ua,    &in.s.va,
      &in.s.qa,    &in.s.phi,   &in.s.phi0,  &in.s.fmask, &in.s.tland,
      &in.s.tsea,  &in.s.swav,  &in.s.ssrd,  &in.s.forog, &in.s.alb_l,
      &in.s.alb_s, &in.s.snowc, &in.s.clat};
  for (int i = 0; i < DOWN_SURFACE_N_IN; ++i) *f[i] = (const T*)p[i];
  return in;
}

// Phase 1, warp k < K: level k's Planck terms st4a_mean and st4a_grad
// (from ta of levels k - 1 to k + 1, read here), stored; tau2 and the
// band terms emis * brad of level k (bands 0 and 1 only on level 0) into
// shared memory; warp K - 1 also the black-band correction.  The surface
// warp (k = K): sfc_head.  out (3K + 5 + 23, G): slrd, dfabs (K),
// flux_bands (4), st4a_mean (K), st4a_grad (K), then column_surface.cuh's
// 23 planes.
template <typename T, int K, int C>
COL_HD void dnsfc_block_load(const LongwaveTab<T, K>& tb,
                             const SurfaceTab<T>& ts, int G, int nlon,
                             const DownSurfaceIn<T>& in, T* out,
                             LwDownShared<T, K, C>& sh, SfcReg<T>& sr,
                             int c, int x, int k) {
  if (c >= G) return;
  if (k == K) {
    sfc_head<T, K>(ts, in.s, G, nlon, c, out + (size_t)(3 * K + 5) * G, sr);
    return;
  }
  const T* ta = in.s.ta;
  const T zero = T(0);
  const size_t i = (size_t)k * G + c;
  const T t = ta[i];
  T mean, grad;
  if (k <= 1) {
    const T t0 = ta[c], t1 = ta[(size_t)G + c];
    const T th0 = t0 + tb.wvi2[0] * (t1 - t0);
    if (k == 0) {
      const T t_strat1 = T(0.75) * t0 + T(0.25) * th0;
      // x ** 4 as torch.pow evaluates it (powf / pow)
      mean = tb.sbc * col_pow(t_strat1, T(4));
    } else {
      const T t2 = ta[(size_t)2 * G + c];
      const T th1 = t1 + tb.wvi2[1] * (t2 - t1);
      const T t_strat2 = T(0.50) * t1 + T(0.25) * (th0 + th1);
      mean = tb.sbc * col_pow(t_strat2, T(4));
    }
    grad = zero;
  } else {
    // the temperature gradient across the layer, from the half levels
    // above (thalf[k - 1]) and below (thalf[k]) level k
    const T tm = ta[i - G];
    const T thm = tm + tb.wvi2[k - 1] * (t - tm);
    T gr;
    if (k < K - 1) {
      const T tp = ta[i + G];
      const T th = t + tb.wvi2[k] * (tp - t);
      gr = T(0.5) * col_max(th - thm, zero);
    } else {
      gr = col_max(t - thm, zero);
    }
    const T st3a = tb.sbc * (t * t * t);
    mean = st3a * t;
    grad = T(4.0) * st3a * gr;
  }
  out[(size_t)(K + 5 + k) * G + c] = mean;
  out[(size_t)(2 * K + 5 + k) * G + c] = grad;
  T f[4];
  fband4(t, tb.eps1, f);
  // level 0 takes part in bands 0 and 1 only
  const int nb = k == 0 ? 2 : 4;
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    if (jb >= nb) break;
    const T tau = in.tau2[(size_t)(k * 4 + jb) * G + c];
    const T emis = T(1) - tau;
    const T brad = f[jb] * (mean + emis * grad);
    sh.tau[k][jb][x] = tau;
    sh.src[k][jb][x] = emis * brad;
  }
  // "black" band correction incl. surface reflection
  if (k == K - 1) sh.corlw[x] = tb.corlw * mean;
}

// Phase 2, warp jb = 0-3: the recursion of band jb down column x, from
// level 0 (bands 0 and 1; bands 2 and 3 start at 0 below it), each
// level's outgoing flux into shared memory and the flux at the surface
// stored (flux_bands).
template <typename T, int K, int C>
COL_HD void dnsfc_block_band(int G, T* out, LwDownShared<T, K, C>& sh, int c,
                             int x, int jb) {
  if (c >= G) return;
  T flux = jb < 2 ? sh.src[0][jb][x] : T(0);
  sh.fout[0][jb][x] = flux;
#pragma unroll
  for (int l = 1; l < K; ++l) {
    flux = sh.tau[l][jb][x] * flux + sh.src[l][jb][x];
    sh.fout[l][jb][x] = flux;
  }
  out[(size_t)(K + 1 + jb) * G + c] = flux;
}

// Phase 3, warp k < K: dfabs of level k (+ the flux entering, - the flux
// leaving, band by band; - corlw on the lowest level), stored.  The
// surface warp: slrd from the band fluxes at the surface, stored, and
// sfc_tail.
template <typename T, int K, int C>
COL_HD void dnsfc_block_sums(const LongwaveTab<T, K>& tb,
                             const SurfaceTab<T>& ts, int G, T* out,
                             const LwDownShared<T, K, C>& sh,
                             const SfcReg<T>& sr, int c, int x, int k) {
  if (c >= G) return;
  if (k == K) {
    T slrd = T(0);
#pragma unroll
    for (int jb = 0; jb < 4; ++jb)
      slrd = slrd + tb.emisfc * sh.fout[K - 1][jb][x];
    slrd = slrd + sh.corlw[x];
    out[c] = slrd;
    sfc_tail(ts, sr, slrd, G, c, out + (size_t)(3 * K + 5) * G);
    return;
  }
  T d = T(0);
  if (k == 0) {
    d = d - sh.fout[0][0][x];
    d = d - sh.fout[0][1][x];
  } else {
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      d = d + sh.fout[k - 1][jb][x];
      d = d - sh.fout[k][jb][x];
    }
  }
  if (k == K - 1) d = d - sh.corlw[x];
  out[(size_t)(1 + k) * G + c] = d;
}

// Column c of G (nlon columns a latitude row), down and surface:
// K10a_down_surface's phases for one column (C = 1), its threads run one
// after another.  in: DownSurfaceIn; lw_blob: LongwaveTables.blob;
// sfc_blob: SurfaceTables.blob; out (3K + 28, G) as dnsfc_block_load's.
template <typename T, int K>
COL_HD void down_surface_at(int c, int G, int nlon,
                            const DownSurfaceIn<T>& in, const T* lw_blob,
                            const T* sfc_blob, T* out) {
  const LongwaveTab<T, K> tb(lw_blob);
  const SurfaceTab<T> ts(sfc_blob);
  LwDownShared<T, K, 1> sh;
  SfcReg<T> sr;
  for (int k = 0; k <= K; ++k)
    dnsfc_block_load(tb, ts, G, nlon, in, out, sh, sr, c, 0, k);
  for (int jb = 0; jb < 4; ++jb) dnsfc_block_band(G, out, sh, c, 0, jb);
  for (int k = 0; k <= K; ++k)
    dnsfc_block_sums(tb, ts, G, out, sh, sr, c, 0, k);
}

// ---- K10b's block: C neighbouring columns, one warp (threadIdx.y) per
// level k.  Each lwup_block_* function is what thread (x, k) of the block
// does between two barriers (x: the column in the block, c: the column in
// the grid); the four band recursions are independent, so band jb runs
// on warp jb (K >= 4), and each level's absorbed flux takes its bands'
// terms in the plain version's order: + the flux entering, - the flux
// leaving, band 0 first.

template <typename T, int K, int C>
struct LwUpShared {
  static_assert(K >= 4, "the four band recursions need four warps");
  T f[K][4][C];              // the band fractions at ta[k]
  T tau[K][4][C];            // tau2
  T mean[K][C], grad[K][C];  // st4a_mean, st4a_grad
  T fin[K][4][C];            // band jb's flux entering level k from below
  T fout[K][4][C];           // and leaving it upward
  T flux[4][C];              // the band fluxes at the surface, then the top
};

// What thread (x, k) keeps in registers from the load to the sums: its
// level's absorbed flux and Planck term; the surface and stratospheric
// planes on the warps that use them (0 elsewhere).
template <typename T>
struct LwUpReg {
  T dfabs, mean, slru, slrd, stratc0, stratc1;
};

// Phase 1, every warp: level k of tau2 (four bands), st4a_mean and
// st4a_grad into shared memory with the band fractions at ta[k]; dfabs
// into registers.  Warp 0 also loads the surface planes and forms the
// band fluxes leaving the surface (fband4(ts) slru_sfc + refsfc
// flux_bands); warp 1 loads stratc[1] and the lowest level's warp
// slru_sfc, for the sums.
template <typename T, int K, int C>
COL_HD void lwup_block_load(const LongwaveTab<T, K>& tb, int G, const T* ta,
                            const T* ts, const T* slrd, const T* slru_sfc,
                            const T* dfabs, const T* flux_bands,
                            const T* st4a_mean, const T* st4a_grad,
                            const T* tau2, const T* stratc,
                            LwUpShared<T, K, C>& sh, LwUpReg<T>& r, int c,
                            int x, int k) {
  if (c >= G) return;
  const size_t i = (size_t)k * G + c;
  const T t = ta[i];
  T tau[4];
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) tau[jb] = tau2[(size_t)(k * 4 + jb) * G + c];
  r.dfabs = dfabs[i];
  r.mean = st4a_mean[i];
  const T grad = st4a_grad[i];
  r.slru = r.slrd = r.stratc0 = r.stratc1 = T(0);
  T fb[4], s0 = T(0);
  if (k == 0) {
    s0 = ts[c];
    r.slru = slru_sfc[c];
    r.slrd = slrd[c];
    r.stratc0 = stratc[c];
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) fb[jb] = flux_bands[(size_t)jb * G + c];
  }
  if (k <= 1) r.stratc1 = stratc[(size_t)G + c];
  if (k == K - 1) r.slru = slru_sfc[c];
  T f[4];
  fband4(t, tb.eps1, f);
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    sh.f[k][jb][x] = f[jb];
    sh.tau[k][jb][x] = tau[jb];
  }
  sh.mean[k][x] = r.mean;
  sh.grad[k][x] = grad;
  if (k == 0) {
    fband4(s0, tb.eps1, f);
#pragma unroll
    for (int jb = 0; jb < 4; ++jb)
      sh.flux[jb][x] = f[jb] * r.slru + tb.refsfc * fb[jb];
  }
}

// Phase 2, warps 0-3: the recursion of band jb up column x (level 0 takes
// part in bands 0 and 1 only).
template <typename T, int K, int C>
COL_HD void lwup_block_band(int G, LwUpShared<T, K, C>& sh, int c, int x,
                            int jb) {
  if (c >= G) return;
  T flux = sh.flux[jb][x];
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    if (k == 0 && jb >= 2) break;
    const T tau = sh.tau[k][jb][x];
    const T emis = T(1) - tau;
    const T brad = sh.f[k][jb][x] * (sh.mean[k][x] - emis * sh.grad[k][x]);
    sh.fin[k][jb][x] = flux;
    flux = tau * flux + emis * brad;
    sh.fout[k][jb][x] = flux;
  }
  sh.flux[jb][x] = flux;
}

// Phase 3, every warp: dfabs of level k, with the stratospheric
// corrections on levels 0 and 1, stored; warp 0 also forms slr and olr.
// out: slr (G), olr (G), dfabs (K, G), as radlw_up_at's.
template <typename T, int K, int C>
COL_HD void lwup_block_sums(const LongwaveTab<T, K>& tb, int G, T* out,
                            const LwUpShared<T, K, C>& sh,
                            const LwUpReg<T>& r, int c, int x, int k) {
  if (c >= G) return;
  T d = r.dfabs;
  if (k == K - 1) d = d + tb.epslw * r.slru;
  const int nb = k == 0 ? 2 : 4;
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) {
    if (jb >= nb) break;
    d = d + sh.fin[k][jb][x];
    d = d - sh.fout[k][jb][x];
  }
  if (k <= 1) {
    const T corlw2 = tb.dsig[1] * r.stratc1 * sh.mean[1][x];
    if (k == 0) {
      const T corlw1 = tb.dsig[0] * r.stratc1 * r.mean + r.stratc0;
      d = d - corlw1;
      T olr = corlw1 + corlw2;
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) olr = olr + sh.flux[jb][x];
      out[c] = r.slru - r.slrd;
      out[(size_t)G + c] = olr;
    } else {
      d = d - corlw2;
    }
  }
  out[(size_t)(2 + k) * G + c] = d;
}

// Column c of G, upward: K10b's phases for one column (C = 1), its
// threads run one after another.  ts, slrd, slru_sfc (G); dfabs,
// st4a_mean, st4a_grad (K, G); flux_bands (4, G); tau2 (K, 4, G); stratc
// (2, G).  out: slr (G), olr (G), dfabs (K, G).
template <typename T, int K>
COL_HD void radlw_up_at(int c, int G, const T* ta, const T* ts,
                        const T* slrd, const T* slru_sfc, const T* dfabs,
                        const T* flux_bands, const T* st4a_mean,
                        const T* st4a_grad, const T* tau2, const T* stratc,
                        const T* blob, T* out) {
  const LongwaveTab<T, K> tb(blob);
  LwUpShared<T, K, 1> sh;
  LwUpReg<T> r[K];
  for (int k = 0; k < K; ++k)
    lwup_block_load(tb, G, ta, ts, slrd, slru_sfc, dfabs, flux_bands,
                    st4a_mean, st4a_grad, tau2, stratc, sh, r[k], c, 0, k);
  for (int jb = 0; jb < 4; ++jb) lwup_block_band(G, sh, c, 0, jb);
  for (int k = 0; k < K; ++k) lwup_block_sums(tb, G, out, sh, r[k], c, 0, k);
}

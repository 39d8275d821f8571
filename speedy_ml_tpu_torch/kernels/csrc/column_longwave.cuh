// K10 column bodies: the 4-band longwave recursions of one grid column,
// downward (radlw_down) and upward (radlw_up), for float and double, as
// CUDA device code and as plain C++ (the host build of the CPU tests
// compiles this very file).
//
// Replaces (JAX package) speedy_ml_tpu/physics/radiation.py:318
// radlw_down, :381 radlw_up and :38 _fband_lookup.  Every operation
// stands in the order of the plain PyTorch version
// (physics/radiation.py of the port) and is rounded apart.  The plain
// version loops bands outside and levels inside; here the levels are
// outside, so that the four band fractions of a level are evaluated
// once: each band's flux recursion and each level's absorbed-flux sum
// see the same operations in the same order either way.
//
// The upward pass is the lwup_block_* phases of K10b's block, C columns
// x K warps handing on through shared memory; radlw_up_at runs them for
// one column (the host build's loop).  In radlw_down_at tau2 is read
// from memory inside the loops (32 values a column, each used once a
// pass); the Planck terms and the absorbed flux stay in registers.
#pragma once

#include "column_common.cuh"

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

// Downward pass of one column.  tau2 points at this column's (k, jb)
// values, tau2[(k * 4 + jb) * G].  Out: slrd, dfabs (K), flux (4), the
// Planck terms st4a_mean and st4a_grad (K each).
template <typename T, int K>
COL_HD void radlw_down_body(const LongwaveTab<T, K>& tb, const T (&ta)[K],
                            const T* tau2, size_t G, T& slrd, T (&dfabs)[K],
                            T (&flux)[4], T (&mean)[K], T (&grad)[K]) {
  const T zero = T(0);
  T thalf[K - 1];
#pragma unroll
  for (int k = 0; k < K - 1; ++k)
    thalf[k] = ta[k] + tb.wvi2[k] * (ta[k + 1] - ta[k]);
  const T t_strat1 = T(0.75) * ta[0] + T(0.25) * thalf[0];
  const T t_strat2 = T(0.50) * ta[1] + T(0.25) * (thalf[0] + thalf[1]);
  // x ** 4 as torch.pow evaluates it (powf / pow)
  mean[0] = tb.sbc * col_pow(t_strat1, T(4));
  mean[1] = tb.sbc * col_pow(t_strat2, T(4));
  grad[0] = grad[1] = zero;
  // the temperature gradient across each layer, into grad for now
#pragma unroll
  for (int k = 2; k < K - 1; ++k)
    grad[k] = T(0.5) * col_max(thalf[k] - thalf[k - 1], zero);
  grad[K - 1] = col_max(ta[K - 1] - thalf[K - 2], zero);
#pragma unroll
  for (int k = 2; k < K; ++k) {
    const T st3a = tb.sbc * (ta[k] * ta[k] * ta[k]);
    mean[k] = st3a * ta[k];
    grad[k] = T(4.0) * st3a * grad[k];
  }

  T f[4];
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) flux[jb] = zero;
  // level 0 takes part in bands 0 and 1 only
  fband4(ta[0], tb.eps1, f);
  dfabs[0] = zero;
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    const T emis = T(1) - tau2[(size_t)jb * G];
    const T brad = f[jb] * (mean[0] + emis * grad[0]);
    flux[jb] = emis * brad;
    dfabs[0] = dfabs[0] - flux[jb];
  }
#pragma unroll
  for (int k = 1; k < K; ++k) {
    fband4(ta[k], tb.eps1, f);
    dfabs[k] = zero;
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      const T tau = tau2[(size_t)(k * 4 + jb) * G];
      const T emis = T(1) - tau;
      const T brad = f[jb] * (mean[k] + emis * grad[k]);
      dfabs[k] = dfabs[k] + flux[jb];
      flux[jb] = tau * flux[jb] + emis * brad;
      dfabs[k] = dfabs[k] - flux[jb];
    }
  }
  slrd = zero;
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) slrd = slrd + tb.emisfc * flux[jb];
  // "black" band correction incl. surface reflection
  const T corlw = tb.corlw * mean[K - 1];
  dfabs[K - 1] = dfabs[K - 1] - corlw;
  slrd = slrd + corlw;
}

// Column c of G, downward: load, body, store.  ta (K, G), tau2
// (K, 4, G).  out: slrd (G), dfabs (K, G), flux (4, G), st4a_mean
// (K, G), st4a_grad (K, G).
template <typename T, int K>
COL_HD void radlw_down_at(int c, int G, const T* ta, const T* tau2,
                          const T* blob, T* out) {
  const LongwaveTab<T, K> tb(blob);
  T t[K], dfabs[K], flux[4], mean[K], grad[K], slrd;
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = ta[(size_t)k * G + c];
  radlw_down_body<T, K>(tb, t, tau2 + c, (size_t)G, slrd, dfabs, flux, mean,
                        grad);
  out[c] = slrd;
  T* o_dfabs = out + (size_t)G;
  T* o_flux = o_dfabs + (size_t)K * G;
  T* o_mean = o_flux + (size_t)4 * G;
  T* o_grad = o_mean + (size_t)K * G;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    o_dfabs[(size_t)k * G + c] = dfabs[k];
    o_mean[(size_t)k * G + c] = mean[k];
    o_grad[(size_t)k * G + c] = grad[k];
  }
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) o_flux[(size_t)jb * G + c] = flux[jb];
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

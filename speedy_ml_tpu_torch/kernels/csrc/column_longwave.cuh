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
// tau2 is read from memory inside the loops (32 values a column, each
// used once a pass); the Planck terms and the absorbed flux stay in
// registers.
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

// Upward pass of one column.  dfabs and flux come in from the downward
// pass (flux as flux_bands) and leave updated.  Out: slr, olr.
template <typename T, int K>
COL_HD void radlw_up_body(const LongwaveTab<T, K>& tb, const T (&ta)[K],
                          T ts, T slrd, T slru_sfc, T (&dfabs)[K],
                          T (&flux)[4], const T (&mean)[K],
                          const T (&grad)[K], const T* tau2, size_t G,
                          T stratc0, T stratc1, T& slr, T& olr) {
  slr = slru_sfc - slrd;
  T f[4];
  fband4(ts, tb.eps1, f);
#pragma unroll
  for (int jb = 0; jb < 4; ++jb)
    flux[jb] = f[jb] * slru_sfc + tb.refsfc * flux[jb];
  dfabs[K - 1] = dfabs[K - 1] + tb.epslw * slru_sfc;
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    fband4(ta[k], tb.eps1, f);
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
      // level 0 takes part in bands 0 and 1 only
      if (k == 0 && jb >= 2) continue;
      const T tau = tau2[(size_t)(k * 4 + jb) * G];
      const T emis = T(1) - tau;
      const T brad = f[jb] * (mean[k] - emis * grad[k]);
      dfabs[k] = dfabs[k] + flux[jb];
      flux[jb] = tau * flux[jb] + emis * brad;
      dfabs[k] = dfabs[k] - flux[jb];
    }
  }
  // stratospheric corrections
  const T corlw1 = tb.dsig[0] * stratc1 * mean[0] + stratc0;
  const T corlw2 = tb.dsig[1] * stratc1 * mean[1];
  dfabs[0] = dfabs[0] - corlw1;
  dfabs[1] = dfabs[1] - corlw2;
  olr = corlw1 + corlw2;
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) olr = olr + flux[jb];
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

// Column c of G, upward.  ts, slrd, slru_sfc (G); dfabs, st4a_mean,
// st4a_grad (K, G); flux_bands (4, G); tau2 (K, 4, G); stratc (2, G).
// out: slr (G), olr (G), dfabs (K, G).
template <typename T, int K>
COL_HD void radlw_up_at(int c, int G, const T* ta, const T* ts,
                        const T* slrd, const T* slru_sfc, const T* dfabs_in,
                        const T* flux_bands, const T* st4a_mean,
                        const T* st4a_grad, const T* tau2, const T* stratc,
                        const T* blob, T* out) {
  const LongwaveTab<T, K> tb(blob);
  T t[K], dfabs[K], flux[4], mean[K], grad[K], slr, olr;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    t[k] = ta[(size_t)k * G + c];
    dfabs[k] = dfabs_in[(size_t)k * G + c];
    mean[k] = st4a_mean[(size_t)k * G + c];
    grad[k] = st4a_grad[(size_t)k * G + c];
  }
#pragma unroll
  for (int jb = 0; jb < 4; ++jb) flux[jb] = flux_bands[(size_t)jb * G + c];
  radlw_up_body<T, K>(tb, t, ts[c], slrd[c], slru_sfc[c], dfabs, flux, mean,
                      grad, tau2 + c, (size_t)G, stratc[c],
                      stratc[(size_t)G + c], slr, olr);
  out[c] = slr;
  out[(size_t)G + c] = olr;
#pragma unroll
  for (int k = 0; k < K; ++k) out[(size_t)(2 + k) * G + c] = dfabs[k];
}

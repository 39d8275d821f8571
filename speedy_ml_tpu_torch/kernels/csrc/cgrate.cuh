// K26 (the cgrate limiter of the eddy kinetic-energy growth rate, then
// the leapfrog of vor and div), for float and double, as CUDA device code
// and as plain C++ (optional_host.cpp compiles this very file for the CPU
// tests).
//
// Replaces (JAX package) speedy_ml_tpu/dycore/model.py:565-585
// (DycoreModel._cgrate, called at :540-542; the reference's cgrate,
// dyn_step.f90:192-276) and the _timint of vor and div after it (:446),
// which XLA fused into the dycore step.
//
// Per field (vor or div) f, its diffused tendency fdt, K levels of mx x nx
// complex coefficients, in the order of the plain version
// (kernels/cgrate.py cgrate_plain), every operation rounded apart:
//   t = (-f) * elm2 (invlap); per coefficient, with mask = (m > 0),
//   pg = (fdt.re t.re + fdt.im t.im) mask and pr = (f.re t.re + f.im t.im)
//   mask; per row (k, m) the sums over n from n = 0 one after another,
//   then per level the sums of the rows from m = 0: grate = -sum pg,
//   rnorm = -sum pr;
//   per level, trig = grate > grmax rnorm and k >= 1 and rnorm > 0, and
//   cd = the largest of (trig ? (0.8 grate) / rnorm : 0);
//   fdt' = fdt - (cd f) mask, then trunct (times trfilt), fnew = f + dt
//   fdt', new1 = oldj + ew1 ((f - 2 oldj) + fnew), new2 = fnew - ew2
//   ((new1 - 2 oldj) + fnew): the field's two new leapfrog levels.
//
// On a mesh (dycore/sharded.py) a shard holds the wavenumbers m0 .. m0 +
// mr - 1: its rows are cgrate_row's with m0 (the mask reads the global m),
// the rows of every shard are gathered in m order, and each shard runs
// cgrate_level over all mx of them and cgrate_step_at on its range, so
// that the sums keep the order above and the result is the whole one's.
#pragma once

#include "column_common.cuh"

COL_HD float cg_div(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}
COL_HD double cg_div(double a, double b) {
#ifdef __CUDA_ARCH__
  return __ddiv_rn(a, b);
#else
  return a / b;
#endif
}

// The masked products of coefficient (m, n) of level k: f and fdt
// interleaved complex (K, mx, nx); elm2 (mx, nx); m0 the first
// wavenumber of the m range the arrays hold (0 for the whole).
template <typename T>
COL_HD void cgrate_products(const T* f, const T* fdt, const T* elm2, int mx,
                            int nx, int m0, int k, int m, int n, T* pg,
                            T* pr) {
  const long long c = ((long long)k * mx + m) * nx + n;
  const T e = elm2[m * nx + n];
  const T fr = f[2 * c], fi = f[2 * c + 1];
  const T tr = gd_mul(-fr, e), ti = gd_mul(-fi, e);
  const T mask = m0 + m > 0 ? T(1) : T(0);
  *pg = gd_mul(gd_add(gd_mul(fdt[2 * c], tr), gd_mul(fdt[2 * c + 1], ti)),
               mask);
  *pr = gd_mul(gd_add(gd_mul(fr, tr), gd_mul(fi, ti)), mask);
}

// Row (k, m): the sums over n, n = 0 first.
template <typename T>
COL_HD void cgrate_row(const T* f, const T* fdt, const T* elm2, int mx,
                       int nx, int m0, int k, int m, T* sg, T* sr) {
  T g, r;
  cgrate_products(f, fdt, elm2, mx, nx, m0, k, m, 0, &g, &r);
  for (int n = 1; n < nx; ++n) {
    T pg, pr;
    cgrate_products(f, fdt, elm2, mx, nx, m0, k, m, n, &pg, &pr);
    g = gd_add(g, pg);
    r = gd_add(r, pr);
  }
  *sg = g;
  *sr = r;
}

// Level k's damping candidate from its row sums rg, rr (mx each): the
// trigger's value (0.8 grate) / rnorm, or 0.
template <typename T>
COL_HD T cgrate_level(const T* rg, const T* rr, int mx, int k, T grmax) {
  T sg = rg[0], sr = rr[0];
  for (int m = 1; m < mx; ++m) {
    sg = gd_add(sg, rg[m]);
    sr = gd_add(sr, rr[m]);
  }
  const T grate = -sg, rnorm = -sr;
  const bool trig = grate > gd_mul(grmax, rnorm) && k >= 1 && rnorm > T(0);
  return trig ? cg_div(gd_mul(T(0.8), grate), rnorm) : T(0);
}

// The largest of the K candidates, level 0 first (torch.max keeps NaN).
template <typename T>
COL_HD T cgrate_cd(const T* cand, int K) {
  T cd = cand[0];
  for (int k = 1; k < K; ++k) {
    const T v = cand[k];
    cd = (v > cd || v != v) ? v : cd;
  }
  return cd;
}

// Real element e (of 2 K mx nx) of the field: the damped tendency and
// the leapfrog.  f: level 0 of the state (old1), fj: level j1 - 1 (oldj);
// trfilt (mx, nx); m0 the first wavenumber of the arrays' m range; writes
// o1[e] (new1) and o2[e] (new2).
template <typename T>
COL_HD void cgrate_step_at(const T* f, const T* fj, const T* fdt,
                           const T* trfilt, int mx, int nx, int m0, T cd,
                           int trunc, T dt, T ew1, T ew2, T* o1, T* o2,
                           long long e) {
  const long long c = e >> 1;
  const int mn = (int)(c % ((long long)mx * nx));
  const int m = mn / nx;
  const T mask = m0 + m > 0 ? T(1) : T(0);
  const T old1 = f[e], oldj = fj[e];
  T d = gd_sub(fdt[e], gd_mul(gd_mul(cd, old1), mask));
  if (trunc) d = gd_mul(d, trfilt[mn]);
  const T fnew = gd_add(old1, gd_mul(dt, d));
  const T two_j = gd_mul(T(2), oldj);
  const T new1 = gd_add(oldj, gd_mul(ew1, gd_add(gd_sub(old1, two_j), fnew)));
  const T new2 = gd_sub(fnew, gd_mul(ew2, gd_add(gd_sub(new1, two_j), fnew)));
  o1[e] = new1;
  o2[e] = new2;
}

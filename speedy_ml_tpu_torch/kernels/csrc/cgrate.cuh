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
// The whole form runs a cluster of kCgCluster blocks a field; rank r of
// the cluster holds the levels r, r + kCgCluster, ... (cg_nlev of them, none
// where K <= r).  Each block's shared memory holds its levels' f and fdt,
// rows padded to cg_fstride reals, elm2 padded to cg_estride, the row sums
// of its levels and the K candidates (CgSmem).
//
// On a mesh (dycore/sharded.py) a shard holds the wavenumbers m0 .. m0 +
// mr - 1: its rows are cgrate_row's with m0 (the mask reads the global m),
// the rows of every shard are gathered in m order, and each shard runs
// cgrate_level over all mx of them and cgrate_step on its range (the mask
// again at the global m), so that the sums keep the order above and the
// result is the whole one's.
#pragma once

#include "column_common.cuh"

constexpr int kCgCluster = 8;   // the blocks of a field's cluster

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

// 1 where the global wavenumber m is an eddy (m > 0), else 0.
template <typename T>
COL_HD T cgrate_mask(int m) {
  return m > 0 ? T(1) : T(0);
}

// The masked products of one coefficient: f = fr + i fi, fdt = dr + i di,
// e its elm2.
template <typename T>
COL_HD void cgrate_products(T fr, T fi, T dr, T di, T e, T mask, T* pg,
                            T* pr) {
  const T tr = gd_mul(-fr, e), ti = gd_mul(-fi, e);
  *pg = gd_mul(gd_add(gd_mul(dr, tr), gd_mul(di, ti)), mask);
  *pr = gd_mul(gd_add(gd_mul(fr, tr), gd_mul(fi, ti)), mask);
}

// One row (k, m): f and fdt its nx interleaved complex coefficients, e its
// nx elm2; the sums over n, n = 0 first.
template <typename T>
COL_HD void cgrate_row(const T* f, const T* fdt, const T* e, int nx, T mask,
                       T* sg, T* sr) {
  T g, r;
  cgrate_products(f[0], f[1], fdt[0], fdt[1], e[0], mask, &g, &r);
  for (int n = 1; n < nx; ++n) {
    T pg, pr;
    cgrate_products(f[2 * n], f[2 * n + 1], fdt[2 * n], fdt[2 * n + 1], e[n],
                    mask, &pg, &pr);
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

// One real element: old1 (level 0 of the state), oldj (level j1 - 1),
// its tendency fdt and trfilt; the damped tendency and the leapfrog.
template <typename T>
COL_HD void cgrate_step(T old1, T oldj, T fdt, T trf, T mask, T cd,
                        int trunc, T dt, T ew1, T ew2, T* new1, T* new2) {
  T d = gd_sub(fdt, gd_mul(gd_mul(cd, old1), mask));
  if (trunc) d = gd_mul(d, trf);
  const T fnew = gd_add(old1, gd_mul(dt, d));
  const T two_j = gd_mul(T(2), oldj);
  const T n1 = gd_add(oldj, gd_mul(ew1, gd_add(gd_sub(old1, two_j), fnew)));
  *new1 = n1;
  *new2 = gd_sub(fnew, gd_mul(ew2, gd_add(gd_sub(n1, two_j), fnew)));
}

// ---------------------------------------------------------------- layout

// The levels of cluster rank r: r, r + kCgCluster, ... < K.
COL_HD int cg_nlev(int K, int r) {
  return r < K ? (K - 1 - r) / kCgCluster + 1 : 0;
}
// The most levels a block holds.
COL_HD int cg_lmax(int K) { return cg_nlev(K, 0); }
// Shared row strides: a row of f or fdt (2 nx reals) and of elm2 (nx),
// one more, so that the threads of a warp, a row each, read 32 banks.
COL_HD int cg_fstride(int nx) { return 2 * nx + 1; }
COL_HD int cg_estride(int nx) { return nx + 1; }

// A block's shared memory: f, fdt (L levels x mx rows x cg_fstride),
// elm2 (mx x cg_estride) and the row sums rg, rr (L x mx), where the
// block sums its own rows (`rows` true), then the candidates (K).
template <typename T>
struct CgSmem {
  T *f, *d, *e, *rg, *rr, *cand;
};

template <typename T>
COL_HD CgSmem<T> cg_smem(T* base, int K, int mx, int nx, bool rows) {
  const int L = cg_lmax(K);
  const long long lv = rows ? (long long)L * mx * cg_fstride(nx) : 0;
  CgSmem<T> s;
  s.f = base;
  s.d = s.f + lv;
  s.e = s.d + lv;
  s.rg = s.e + (rows ? mx * cg_estride(nx) : 0);
  s.rr = s.rg + (rows ? L * mx : 0);
  s.cand = s.rr + (rows ? L * mx : 0);
  return s;
}

// Its size in elements.
COL_HD long long cg_smem_count(int K, int mx, int nx, bool rows) {
  const int L = cg_lmax(K);
  return rows ? 2LL * L * mx * cg_fstride(nx) + (long long)mx * cg_estride(nx)
                    + 2LL * L * mx + K
              : (long long)K;
}

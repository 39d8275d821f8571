// K15: the spectral stacks that feed K6, for float and double, as CUDA
// device code and as plain C++ (the host build of the CPU tests,
// stack_host.cpp, compiles this very file).
//
// Replaces (JAX package) speedy_ml_tpu/core/spectral.py:340-364 uvspec
// and grad, speedy_ml_tpu/dycore/model.py:233 geopotential and the
// stacks that grid_tendencies (:258-280) and GCM._physics_fn
// (speedy_ml_tpu/gcm.py:222-234) hand to the inverse transform.  From
// the spectral state (both leapfrog levels) and the spectral orography
// phis, per coefficient (m, n):
//   the dynamics stack at level jd (6K + 2 fields):
//     [vor, div, t, q (K each) | u cos, v cos (K each), dps/dx, dps/dy];
//   the physics stack at level jp (5K + 1 fields):
//     [t, q, phi (K each), ps | u cos, v cos (K each)].
// u cos and v cos are uvspec's: the n-1 / n+1 neighbours (zero beyond
// the row's ends) and the i m term, killed on the last n row by zrow.
// phi is the hydrostatic sum of geopotential, bottom up, with the
// lapse-rate correction on levels 1 .. K-2 of m = 0.  Either stack may be
// left out (its pointer null).
//
// Every operation is rounded apart (gd_add, gd_sub, gd_mul of
// column_common.cuh), in the order of the plain version
// (kernels/spectral_stack.py), so the two give the same values.  The
// plain version's complex products have three forms, each written out
// here with the terms whose product is an exact zero left away (they
// change at most the sign of a zero):
//   real table r times z:        (r z.x, r z.y);
//   (i g) times z:               (-(g z.y), g z.x);
//   (A - B) + C and (A + B) + C: componentwise, in that order.
// The tables are the plain version's own tensors (float32 on the card),
// so a float scalar such as xgeop1[k] multiplies as the float32 value the
// plain version's complex64 product sees.
//
// The block: one zonal wavenumber m, thread (n, k) on coefficient n of
// level k.  stack_block_load: each thread loads level k of its
// coefficient, writes the stacks' copied fields, and puts vor, div (both
// levels) and t (level jp) and, on level 0, ps in shared memory;
// stack_block_out: each thread forms level k's u cos and v cos from its
// n +- 1 neighbours, phi of level k from the levels below it, and on
// level 0 the gradient of ps.
#pragma once

#include "column_common.cuh"

// coefficients n a block holds (T30: nx = 32)
#define STACK_MAX_N 32

template <typename T>
struct alignas(2 * sizeof(T)) stack_c {
  T x, y;
};
template <typename T>
COL_HD stack_c<T> sc_mk(T x, T y) {
  stack_c<T> r;
  r.x = x;
  r.y = y;
  return r;
}
template <typename T>
COL_HD stack_c<T> sc_add(stack_c<T> a, stack_c<T> b) {
  return sc_mk(gd_add(a.x, b.x), gd_add(a.y, b.y));
}
template <typename T>
COL_HD stack_c<T> sc_sub(stack_c<T> a, stack_c<T> b) {
  return sc_mk(gd_sub(a.x, b.x), gd_sub(a.y, b.y));
}
// a real table r times z
template <typename T>
COL_HD stack_c<T> sc_rmul(T r, stack_c<T> z) {
  return sc_mk(gd_mul(r, z.x), gd_mul(r, z.y));
}
// (i g) times z
template <typename T>
COL_HD stack_c<T> sc_imul(T g, stack_c<T> z) {
  return sc_mk(-gd_mul(g, z.y), gd_mul(g, z.x));
}

// The table blob (kernels/spectral_stack.py stack_blob), in elements:
// uvdx, uvdym, uvdyp, gradym, gradyp (mx * nx each), gradx (mx), zrow
// (nx), xgeop1, xgeop2, geop_corf (K each).
template <typename T, int K>
struct StackTab {
  const T *uvdx, *uvdym, *uvdyp, *gradym, *gradyp, *gradx, *zrow, *x1, *x2,
      *corf;
  COL_HD StackTab(const T* b, int mx, int nx) {
    const size_t MN = (size_t)mx * nx;
    uvdx = b;
    uvdym = uvdx + MN;
    uvdyp = uvdym + MN;
    gradym = uvdyp + MN;
    gradyp = gradym + MN;
    gradx = gradyp + MN;
    zrow = gradx + mx;
    x1 = zrow + nx;
    x2 = x1 + K;
    corf = x2 + K;
  }
};

// The operands: the state vor, div, t (2, K, mx, nx), ps (2, mx, nx), tr
// (2, 1, K, mx, nx), phis (mx, nx); the stacks dyn (6K + 2, mx, nx) at
// level jd and phy (5K + 1, mx, nx) at level jp, either null.
template <typename T>
struct StackIO {
  const stack_c<T> *vor, *div, *t, *ps, *tr, *phis;
  stack_c<T> *dyn, *phy;
  int jd, jp, mx, nx;
};

template <typename T, int K>
struct StackShared {
  stack_c<T> vor_d[K][STACK_MAX_N], div_d[K][STACK_MAX_N];   // level jd
  stack_c<T> vor_p[K][STACK_MAX_N], div_p[K][STACK_MAX_N];   // level jp
  stack_c<T> t_p[K][STACK_MAX_N];
  stack_c<T> ps_d[STACK_MAX_N];
};

// ---- the pieces, in the order of the plain version

// uvspec at one coefficient: vr, vc, vl are vor at n-1, n, n+1 (zero
// beyond the row), dr, dc, dl div.
//   u cos = (uvdym vr - uvdyp vl) + zrow ((i uvdx) dc)
//   v cos = (-uvdym dr + uvdyp dl) + zrow ((i uvdx) vc)
template <typename T>
COL_HD void stack_uv(T uvdx, T uvdym, T uvdyp, T zrow, stack_c<T> vr,
                     stack_c<T> vc, stack_c<T> vl, stack_c<T> dr,
                     stack_c<T> dc, stack_c<T> dl, stack_c<T>& u,
                     stack_c<T>& v) {
  const stack_c<T> zp = sc_rmul(zrow, sc_imul(uvdx, vc));
  const stack_c<T> zc = sc_rmul(zrow, sc_imul(uvdx, dc));
  u = sc_add(sc_sub(sc_rmul(uvdym, vr), sc_rmul(uvdyp, vl)), zc);
  v = sc_add(sc_add(sc_rmul(-uvdym, dr), sc_rmul(uvdyp, dl)), zp);
}

// phi of level k from t of levels k .. K-1 (t[l][n]): the bottom-up sum
// phis + x1[K-1] t[K-1], then for l = K-2 down to k
// (phi + x2[l+1] t[l+1]) + x1[l] t[l].
template <typename T, int K>
COL_HD stack_c<T> stack_phi(const StackTab<T, K>& tb, stack_c<T> phis,
                            const stack_c<T> (&t)[K][STACK_MAX_N], int n,
                            int k) {
  stack_c<T> phi = sc_add(phis, sc_rmul(tb.x1[K - 1], t[K - 1][n]));
  for (int l = K - 2; l >= k; --l)
    phi = sc_add(sc_add(phi, sc_rmul(tb.x2[l + 1], t[l + 1][n])),
                 sc_rmul(tb.x1[l], t[l][n]));
  return phi;
}

// The lapse-rate correction of level k (m = 0, 0 < k < K-1):
// phi + corf[k] (t[k+1] - t[k-1]).
template <typename T>
COL_HD stack_c<T> stack_phi_corr(T corf, stack_c<T> phi, stack_c<T> t_up,
                                 stack_c<T> t_dn) {
  return sc_add(phi, sc_rmul(corf, sc_sub(t_up, t_dn)));
}

// row[i] of a shared row, zero for i outside [0, nx): the shifts'
// zeros at either end of a row.
template <typename T>
COL_HD stack_c<T> stack_at(const stack_c<T>* row, int i, int nx) {
  return (i >= 0 && i < nx) ? row[i] : sc_mk(T(0), T(0));
}

// ---- the block's phases, thread (n, k) of block m

template <typename T, int K>
COL_HD void stack_block_load(const StackIO<T>& io, StackShared<T, K>& sh,
                             int m, int n, int k) {
  const size_t MN = (size_t)io.mx * io.nx;
  const size_t c = (size_t)m * io.nx + n;
  if (io.dyn) {
    const size_t lv = ((size_t)io.jd * K + k) * MN + c;
    const stack_c<T> vor = io.vor[lv], div = io.div[lv];
    sh.vor_d[k][n] = vor;
    sh.div_d[k][n] = div;
    io.dyn[(size_t)k * MN + c] = vor;
    io.dyn[(size_t)(K + k) * MN + c] = div;
    io.dyn[(size_t)(2 * K + k) * MN + c] = io.t[lv];
    io.dyn[(size_t)(3 * K + k) * MN + c] = io.tr[lv];
    if (k == 0) sh.ps_d[n] = io.ps[(size_t)io.jd * MN + c];
  }
  if (io.phy) {
    const size_t lv = ((size_t)io.jp * K + k) * MN + c;
    const stack_c<T> t = io.t[lv];
    sh.vor_p[k][n] = io.vor[lv];
    sh.div_p[k][n] = io.div[lv];
    sh.t_p[k][n] = t;
    io.phy[(size_t)k * MN + c] = t;
    io.phy[(size_t)(K + k) * MN + c] = io.tr[lv];
    if (k == 0)
      io.phy[(size_t)3 * K * MN + c] = io.ps[(size_t)io.jp * MN + c];
  }
}

template <typename T, int K>
COL_HD void stack_block_out(const StackTab<T, K>& tb, const StackIO<T>& io,
                            const StackShared<T, K>& sh, int m, int n,
                            int k) {
  const int nx = io.nx;
  const size_t MN = (size_t)io.mx * nx;
  const size_t c = (size_t)m * nx + n;
  const T uvdx = tb.uvdx[c], uvdym = tb.uvdym[c], uvdyp = tb.uvdyp[c];
  const T zrow = tb.zrow[n];
  stack_c<T> u, v;
  if (io.dyn) {
    stack_uv(uvdx, uvdym, uvdyp, zrow, stack_at(sh.vor_d[k], n - 1, nx),
             sh.vor_d[k][n], stack_at(sh.vor_d[k], n + 1, nx),
             stack_at(sh.div_d[k], n - 1, nx), sh.div_d[k][n],
             stack_at(sh.div_d[k], n + 1, nx), u, v);
    io.dyn[(size_t)(4 * K + k) * MN + c] = u;
    io.dyn[(size_t)(5 * K + k) * MN + c] = v;
    if (k == 0) {
      // grad: (i gradx) ps; -gradym ps[n-1] + gradyp ps[n+1]
      io.dyn[(size_t)6 * K * MN + c] = sc_imul(tb.gradx[m], sh.ps_d[n]);
      io.dyn[(size_t)(6 * K + 1) * MN + c] =
          sc_add(sc_rmul(-tb.gradym[c], stack_at(sh.ps_d, n - 1, nx)),
                 sc_rmul(tb.gradyp[c], stack_at(sh.ps_d, n + 1, nx)));
    }
  }
  if (io.phy) {
    stack_uv(uvdx, uvdym, uvdyp, zrow, stack_at(sh.vor_p[k], n - 1, nx),
             sh.vor_p[k][n], stack_at(sh.vor_p[k], n + 1, nx),
             stack_at(sh.div_p[k], n - 1, nx), sh.div_p[k][n],
             stack_at(sh.div_p[k], n + 1, nx), u, v);
    io.phy[(size_t)(3 * K + 1 + k) * MN + c] = u;
    io.phy[(size_t)(4 * K + 1 + k) * MN + c] = v;
    stack_c<T> phi = stack_phi(tb, io.phis[c], sh.t_p, n, k);
    if (m == 0 && k > 0 && k < K - 1)
      phi = stack_phi_corr(tb.corf[k], phi, sh.t_p[k + 1][n],
                           sh.t_p[k - 1][n]);
    io.phy[(size_t)(2 * K + k) * MN + c] = phi;
  }
}

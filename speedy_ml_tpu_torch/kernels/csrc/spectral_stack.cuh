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
// The lanes: a warp per row (m, level k), lane n on coefficient n (nx <=
// 32; the lanes from nx on load and store nothing).  A lane runs
// three phases:
//   stack_lane_load  every read of the lane, before any operation: level
//                    k of the state at the stacks' levels, ps on level 0,
//                    its table entries, phis and the t values of the
//                    levels its phi sum reads;
//   stack_exchange   the n-1 and n+1 neighbours of vor and div (and, on
//                    level 0, of ps), one value a call of `xch` (the
//                    kernel: __shfl_up_sync / __shfl_down_sync; the host
//                    build: a copy from the neighbouring lane);
//   stack_lane_out   the copied fields, uvspec, grad on level 0 and phi
//                    bottom up with the m = 0 correction, stored.
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
  // the first zonal wavenumber of the operands' rows: row m is the
  // wavenumber m0 + m (a shard's m range, GCM.set_mesh); the tables are
  // the range's
  int m0 = 0;
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

// ---- the lanes: lane n of the warp on row (m, k)

// What a lane reads, all in stack_lane_load.  The state: vor, div, t, tr
// at level jd (vd, dd, td, qd) and vor, div, tr at level jp (vp, dp, qp);
// ps at both levels on level 0; tp[l], t at level jp of level l, for the
// levels l >= k the phi sum reads and, on m = 0, l = k - 1 too.  The
// tables at (m, n) and the (K,) geopotential tables.  A field the lane's
// stacks do not read is left unset, and so is every field of a lane from
// nx on: the exchange hands a value on only from a lane inside the row.
template <typename T, int K>
struct StackLane {
  int m, n, k;
  bool live;  // n < nx: the lane stores
  stack_c<T> vd, dd, td, qd, psd;
  stack_c<T> vp, dp, qp, psp, phis, tp[K];
  T uvdx, uvdym, uvdyp, zrow, gradx, gradym, gradyp, corf;
  T x1[K], x2[K];
};

// The neighbours a lane receives: [0] lane n-1's value, [1] lane n+1's,
// zero beyond the row's ends.
template <typename T>
struct StackNb {
  stack_c<T> vd[2], dd[2], psd[2], vp[2], dp[2];
};

// a[k] for a k known only at run time, without indexing the array by it
// (which would leave it in local memory on the card)
template <typename T, int K>
COL_HD stack_c<T> stack_pick(const stack_c<T> (&a)[K], int k) {
  stack_c<T> r = a[0];
#pragma unroll
  for (int l = 1; l < K; ++l)
    if (l == k) r = a[l];
  return r;
}

template <typename T, int K>
COL_HD void stack_lane_load(StackLane<T, K>& L, const StackIO<T>& io,
                            const StackTab<T, K>& tb, int m, int n, int k) {
  const size_t MN = (size_t)io.mx * io.nx;
  const size_t c = (size_t)m * io.nx + n;
  L.m = m;
  L.n = n;
  L.k = k;
  L.live = n < io.nx;
  if (!L.live) return;
  L.uvdx = tb.uvdx[c];
  L.uvdym = tb.uvdym[c];
  L.uvdyp = tb.uvdyp[c];
  L.zrow = tb.zrow[n];
  if (io.dyn) {
    const size_t lv = ((size_t)io.jd * K + k) * MN + c;
    L.vd = io.vor[lv];
    L.dd = io.div[lv];
    L.td = io.t[lv];
    L.qd = io.tr[lv];
    if (k == 0) {
      L.psd = io.ps[(size_t)io.jd * MN + c];
      L.gradx = tb.gradx[m];
      L.gradym = tb.gradym[c];
      L.gradyp = tb.gradyp[c];
    }
  }
  if (io.phy) {
    const size_t j0 = (size_t)io.jp * K * MN + c;
    L.vp = io.vor[j0 + (size_t)k * MN];
    L.dp = io.div[j0 + (size_t)k * MN];
    L.qp = io.tr[j0 + (size_t)k * MN];
    if (k == 0) L.psp = io.ps[(size_t)io.jp * MN + c];
    L.phis = io.phis[c];
    const int lo = (io.m0 + m == 0 && k > 0) ? k - 1 : k;
#pragma unroll
    for (int l = 0; l < K; ++l)
      if (l >= lo) {
        L.tp[l] = io.t[j0 + (size_t)l * MN];
        L.x1[l] = tb.x1[l];
        L.x2[l] = tb.x2[l];
      }
    L.corf = tb.corf[k];
  }
}

// xch(f, d): lane n + d's value of the field L.*f (d = -1 or +1), called
// by every lane of the warp together.  (On the card xch is a device
// lambda: the pragma keeps nvcc from warning of its host instantiation,
// which is never made.)
#if defined(__CUDACC__) && !defined(__clang__)
#pragma nv_exec_check_disable
#endif
template <typename T, int K, typename X>
COL_HD void stack_exchange(const StackLane<T, K>& L, const StackIO<T>& io,
                           X xch, StackNb<T>& nb) {
  typedef StackLane<T, K> Ln;
  const stack_c<T> z = sc_mk(T(0), T(0));
  const bool lo = L.n > 0, hi = L.n + 1 < io.nx;
  auto pair = [&](stack_c<T> Ln::*f, stack_c<T>(&d)[2]) {
    const stack_c<T> a = xch(f, -1), b = xch(f, 1);
    d[0] = lo ? a : z;
    d[1] = hi ? b : z;
  };
  if (io.dyn) {
    pair(&Ln::vd, nb.vd);
    pair(&Ln::dd, nb.dd);
    if (L.k == 0) pair(&Ln::psd, nb.psd);
  }
  if (io.phy) {
    pair(&Ln::vp, nb.vp);
    pair(&Ln::dp, nb.dp);
  }
}

// phi of the lane's level before the m = 0 correction: phis + x1[K-1]
// t[K-1], then for l = K-2 down to k (phi + x2[l+1] t[l+1]) + x1[l] t[l].
template <typename T, int K>
COL_HD stack_c<T> stack_lane_phi(const StackLane<T, K>& L) {
  stack_c<T> phi = sc_add(L.phis, sc_rmul(L.x1[K - 1], L.tp[K - 1]));
#pragma unroll
  for (int l = K - 2; l >= 0; --l)
    if (l >= L.k)
      phi = sc_add(sc_add(phi, sc_rmul(L.x2[l + 1], L.tp[l + 1])),
                   sc_rmul(L.x1[l], L.tp[l]));
  return phi;
}

template <typename T, int K>
COL_HD void stack_lane_out(const StackLane<T, K>& L, const StackNb<T>& nb,
                           const StackIO<T>& io) {
  if (!L.live) return;
  const int k = L.k;
  const size_t MN = (size_t)io.mx * io.nx;
  const size_t c = (size_t)L.m * io.nx + L.n;
  stack_c<T> u, v;
  if (io.dyn) {
    stack_c<T>* o = io.dyn + c;
    o[(size_t)k * MN] = L.vd;
    o[(size_t)(K + k) * MN] = L.dd;
    o[(size_t)(2 * K + k) * MN] = L.td;
    o[(size_t)(3 * K + k) * MN] = L.qd;
    stack_uv(L.uvdx, L.uvdym, L.uvdyp, L.zrow, nb.vd[0], L.vd, nb.vd[1],
             nb.dd[0], L.dd, nb.dd[1], u, v);
    o[(size_t)(4 * K + k) * MN] = u;
    o[(size_t)(5 * K + k) * MN] = v;
    if (k == 0) {
      // grad: (i gradx) ps; -gradym ps[n-1] + gradyp ps[n+1]
      o[(size_t)6 * K * MN] = sc_imul(L.gradx, L.psd);
      o[(size_t)(6 * K + 1) * MN] = sc_add(sc_rmul(-L.gradym, nb.psd[0]),
                                           sc_rmul(L.gradyp, nb.psd[1]));
    }
  }
  if (io.phy) {
    stack_c<T>* o = io.phy + c;
    o[(size_t)k * MN] = stack_pick(L.tp, k);
    o[(size_t)(K + k) * MN] = L.qp;
    if (k == 0) o[(size_t)3 * K * MN] = L.psp;
    stack_uv(L.uvdx, L.uvdym, L.uvdyp, L.zrow, nb.vp[0], L.vp, nb.vp[1],
             nb.dp[0], L.dp, nb.dp[1], u, v);
    o[(size_t)(3 * K + 1 + k) * MN] = u;
    o[(size_t)(4 * K + 1 + k) * MN] = v;
    stack_c<T> phi = stack_lane_phi(L);
    if (io.m0 + L.m == 0 && k > 0 && k < K - 1)
      phi = stack_phi_corr(L.corf, phi, stack_pick(L.tp, k + 1),
                           stack_pick(L.tp, k - 1));
    o[(size_t)(2 * K + k) * MN] = phi;
  }
}

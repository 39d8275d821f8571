// K7: the grid-point dynamics of one step, for float and double, as CUDA
// device code and as plain C++ (the host build of the CPU tests,
// grid_host.cpp, compiles this very file).
//
// Replaces (JAX package) speedy_ml_tpu/dycore/model.py:258
// grid_tendencies after its inverse transform (:290-350), the physics sum
// of step (:500-503) and the products of to_spectral_tendencies
// (:365-379).  Input gall ((5+R)K + 2, G), R = 1: vor, div, T, q (K
// each), u, v (K each, 1/cos applied), dps/dx, dps/dy.  Per column:
//   vertical means umean, vmean, dmean (sum_k f[k] * dhs[k], level order);
//   puv = (u - umean) px + (v - vmean) py; the half-level sums sigdt,
//   sigm (cumulative, 0 on top); the u/v/T/q tendencies with the vertical
//   advection half-level fluxes (zero at the top and bottom half levels,
//   and for q also on the two half levels below the top);
//   plus the physics tendencies (u, v, t, q; optional).
// Output (1 + 9K, G), the stack K5 transforms:
//   [psfield = -umean px - vmean py; ke, ttend, qtend;
//    utend, -u (T - tref), -u q; vtend, -v (T - tref), -v q].
//
// Every operation is rounded apart (gd_add, gd_sub, gd_mul of
// column_common.cuh: the _rn intrinsics on the device, which are never
// contracted into an FMA; plain operators on the host, compiled with
// -ffp-contract=off), in the order of the plain version
// (kernels/grid_dynamics.py), so the two agree to a few ulps.
//
// The arithmetic is three pieces: the column sums (grid_sums, the only
// serial part), the flux of one half level (grid_flux) and the outputs of
// one level (grid_level).  Two callers use them: grid_column_at, one
// column in a row (the first design, kept for the host build), and the
// grid_block_* phases of the kernel's block, C columns x K levels, thread
// (x, k) on level k of column x, the pieces handing on through shared
// memory.  Both give the same bits: the flux at a half level between two
// levels is formed by the threads of both, with the same operations.
#pragma once

#include "column_common.cuh"

// The table blob (grid_dynamics.column_blob): coriol (nlat), then dhs,
// dhsr, fsgr, tref, tref3 (K each); and the two constants.
template <typename T, int K>
struct GridTab {
  const T *coriol, *dhs, *dhsr, *fsgr, *tref, *tref3;
  T rgas, akap;
  COL_HD GridTab(const T* b, int nlat, T rgas_, T akap_)
      : coriol(b), dhs(b + nlat), dhsr(b + nlat + K),
        fsgr(b + nlat + 2 * K), tref(b + nlat + 3 * K),
        tref3(b + nlat + 4 * K), rgas(rgas_), akap(akap_) {}
};

// The operands: gall (6K + 2, G); the physics tendencies pu, pv, pt, pq
// (K, G each), all null for the dry core; out (1 + 9K, G).
template <typename T>
struct GridIO {
  const T* gall;
  const T *pu, *pv, *pt, *pq;
  int nlon, G;
  T* out;
};

// ---- the pieces, in the order of the plain version

// The column sums: the vertical means, psfield, puv and the half-level
// sums sigdt and sigm (K + 1 each, 0 on top), all in level order.
template <typename T, int K>
COL_HD void grid_sums(const GridTab<T, K>& tb, const T (&u)[K],
                      const T (&v)[K], const T (&dv)[K], T px, T py,
                      T& dmean, T& psfield, T (&puv)[K], T (&sigdt)[K + 1],
                      T (&sigm)[K + 1]) {
  T umean = gd_mul(u[0], tb.dhs[0]), vmean = gd_mul(v[0], tb.dhs[0]);
  dmean = gd_mul(dv[0], tb.dhs[0]);
#pragma unroll
  for (int k = 1; k < K; ++k) {
    umean = gd_add(umean, gd_mul(u[k], tb.dhs[k]));
    vmean = gd_add(vmean, gd_mul(v[k], tb.dhs[k]));
    dmean = gd_add(dmean, gd_mul(dv[k], tb.dhs[k]));
  }
  psfield = gd_sub(gd_mul(-umean, px), gd_mul(vmean, py));
  sigdt[0] = T(0);
  sigm[0] = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    puv[k] = gd_add(gd_mul(gd_sub(u[k], umean), px),
                    gd_mul(gd_sub(v[k], vmean), py));
    sigdt[k + 1] = gd_add(
        sigdt[k], gd_mul(-tb.dhs[k], gd_sub(gd_add(puv[k], dv[k]), dmean)));
    sigm[k + 1] = gd_add(sigm[k], gd_mul(-tb.dhs[k], puv[k]));
  }
}

// The vertical advection fluxes of u, v, T and q at half level j, between
// levels j-1 (the "lo" values) and j (zero at j = 0 and j = K; q's also at
// j = 1, 2).  tgg = T - tref.
template <typename T>
struct GridFlux {
  T u, v, t, q;
};
template <typename T, int K>
COL_HD GridFlux<T> grid_flux(const GridTab<T, K>& tb, int j, T sigdt,
                             T sigm, T u, T u_lo, T v, T v_lo, T tgg,
                             T tgg_lo, T q, T q_lo) {
  GridFlux<T> f;
  if (j == 0 || j == K) {
    f.u = f.v = f.t = f.q = T(0);
    return f;
  }
  f.u = gd_mul(sigdt, gd_sub(u, u_lo));
  f.v = gd_mul(sigdt, gd_sub(v, v_lo));
  f.t = gd_add(gd_mul(sigdt, gd_sub(tgg, tgg_lo)),
               gd_mul(sigm, gd_sub(tb.tref[j], tb.tref[j - 1])));
  f.q = j <= 2 ? T(0) : gd_mul(sigdt, gd_sub(q, q_lo));
  return f;
}

// The nine outputs of one level.
template <typename T>
struct GridLevel {
  T ke, tt, qt, ut, utg, uq, vt, vtg, vq;
};

// Level k from its values, the fluxes above (half level k) and below
// (k + 1), the half-level sums around it and the physics tendencies
// (phys: whether there are any).
template <typename T, int K>
COL_HD GridLevel<T> grid_level(const GridTab<T, K>& tb, int k, T cor, T vor,
                               T dv, T t, T q, T u, T v, T px, T py, T puv,
                               T dmean, T sigdt0, T sigdt1, T sigm0, T sigm1,
                               const GridFlux<T>& a, const GridFlux<T>& b,
                               bool phys, T pu, T pv, T pt, T pq) {
  const T tgg = gd_sub(t, tb.tref[k]);
  const T rpx = gd_mul(tb.rgas, px), rpy = gd_mul(tb.rgas, py);
  const T vabs = gd_add(vor, cor);
  GridLevel<T> o;
  o.ut = gd_sub(gd_sub(gd_mul(v, vabs), gd_mul(tgg, rpx)),
                gd_mul(gd_add(b.u, a.u), tb.dhsr[k]));
  o.vt = gd_sub(gd_sub(gd_mul(-u, vabs), gd_mul(tgg, rpy)),
                gd_mul(gd_add(b.v, a.v), tb.dhsr[k]));
  T tt = gd_sub(gd_mul(tgg, dv), gd_mul(gd_add(b.t, a.t), tb.dhsr[k]));
  tt = gd_add(tt, gd_mul(gd_mul(tb.fsgr[k], tgg), gd_add(sigdt1, sigdt0)));
  tt = gd_add(tt, gd_mul(tb.tref3[k], gd_add(sigm1, sigm0)));
  tt = gd_add(tt, gd_mul(tb.akap, gd_sub(gd_mul(t, puv), gd_mul(tgg, dmean))));
  o.tt = tt;
  o.qt = gd_sub(gd_mul(q, dv), gd_mul(gd_add(b.q, a.q), tb.dhsr[k]));
  if (phys) {
    o.ut = gd_add(o.ut, pu);
    o.vt = gd_add(o.vt, pv);
    o.tt = gd_add(o.tt, pt);
    o.qt = gd_add(o.qt, pq);
  }
  o.ke = gd_mul(T(0.5), gd_add(gd_mul(u, u), gd_mul(v, v)));
  o.utg = gd_mul(-u, tgg);
  o.uq = gd_mul(-u, q);
  o.vtg = gd_mul(-v, tgg);
  o.vq = gd_mul(-v, q);
  return o;
}

template <typename T, int K>
COL_HD void grid_store(const GridIO<T>& io, int k, int c,
                       const GridLevel<T>& o) {
  const size_t G = io.G, i = (size_t)k * G + c;
  T* out = io.out + G;   // past psfield
  out[(size_t)(0 * K) * G + i] = o.ke;
  out[(size_t)(1 * K) * G + i] = o.tt;
  out[(size_t)(2 * K) * G + i] = o.qt;
  out[(size_t)(3 * K) * G + i] = o.ut;
  out[(size_t)(4 * K) * G + i] = o.utg;
  out[(size_t)(5 * K) * G + i] = o.uq;
  out[(size_t)(6 * K) * G + i] = o.vt;
  out[(size_t)(7 * K) * G + i] = o.vtg;
  out[(size_t)(8 * K) * G + i] = o.vq;
}

// Column c, the pieces in a row (the first design: every level in
// registers, each half level's flux formed once).
template <typename T, int K>
COL_HD void grid_column_at(const GridTab<T, K>& tb, const GridIO<T>& io,
                           int c) {
  const size_t G = io.G;
  T vor[K], dv[K], t[K], q[K], u[K], v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    vor[k] = io.gall[(size_t)(0 * K + k) * G + c];
    dv[k] = io.gall[(size_t)(1 * K + k) * G + c];
    t[k] = io.gall[(size_t)(2 * K + k) * G + c];
    q[k] = io.gall[(size_t)(3 * K + k) * G + c];
    u[k] = io.gall[(size_t)(4 * K + k) * G + c];
    v[k] = io.gall[(size_t)(5 * K + k) * G + c];
  }
  const T px = io.gall[(size_t)(6 * K) * G + c];
  const T py = io.gall[(size_t)(6 * K + 1) * G + c];
  const T cor = tb.coriol[c / io.nlon];
  T dmean, psfield, puv[K], sigdt[K + 1], sigm[K + 1], tgg[K];
  grid_sums(tb, u, v, dv, px, py, dmean, psfield, puv, sigdt, sigm);
#pragma unroll
  for (int k = 0; k < K; ++k) tgg[k] = gd_sub(t[k], tb.tref[k]);
  GridFlux<T> f[K + 1];
#pragma unroll
  for (int j = 0; j <= K; ++j) {
    const int lo = j > 0 ? j - 1 : 0, hi = j < K ? j : K - 1;
    f[j] = grid_flux(tb, j, sigdt[j], sigm[j], u[hi], u[lo], v[hi], v[lo],
                     tgg[hi], tgg[lo], q[hi], q[lo]);
  }
  io.out[c] = psfield;
  const bool phys = io.pu != nullptr;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t i = (size_t)k * G + c;
    grid_store<T, K>(
        io, k, c,
        grid_level(tb, k, cor, vor[k], dv[k], t[k], q[k], u[k], v[k], px, py,
                   puv[k], dmean, sigdt[k], sigdt[k + 1], sigm[k],
                   sigm[k + 1], f[k], f[k + 1], phys,
                   phys ? io.pu[i] : T(0), phys ? io.pv[i] : T(0),
                   phys ? io.pt[i] : T(0), phys ? io.pq[i] : T(0)));
  }
}

// ---- K7's block: C neighbouring columns (threadIdx.x) x K levels
// (threadIdx.y).  What one phase hands to the next lies in GridShared
// (the levels a neighbour or level 0 reads, the column sums) or, for a
// thread's own level, in GridReg, its registers; each grid_block_*
// function is what thread (x, k) of the block does between two barriers
// (x: the column in the block, c: the column in the grid).

template <typename T, int K, int C>
struct GridShared {
  T dv[K][C], t[K][C], q[K][C], u[K][C], v[K][C];  // load -> sums, level
  T px[C], py[C];
  T puv[K][C], sigdt[K + 1][C], sigm[K + 1][C];     // sums -> level
  T dmean[C];
};

// What thread (x, k) keeps from the load to the level phase: level k of
// the column, and its physics tendencies.
template <typename T>
struct GridReg {
  T vor, dv, t, q, u, v, pu, pv, pt, pq;
};

// Phase 1, every level: level k of the six fields, into registers and
// (all but vor) shared memory; the level's physics tendencies, loaded now
// and used in phase 3; level 0 also px and py.
template <typename T, int K, int C>
COL_HD void grid_block_load(const GridIO<T>& io, GridShared<T, K, C>& sh,
                            GridReg<T>& r, int c, int x, int k) {
  if (c >= io.G) return;
  const size_t G = io.G, i = (size_t)k * G + c;
  const T* g = io.gall;
  r.vor = g[(size_t)(0 * K) * G + i];
  r.dv = g[(size_t)(1 * K) * G + i];
  r.t = g[(size_t)(2 * K) * G + i];
  r.q = g[(size_t)(3 * K) * G + i];
  r.u = g[(size_t)(4 * K) * G + i];
  r.v = g[(size_t)(5 * K) * G + i];
  const bool phys = io.pu != nullptr;
  r.pu = phys ? io.pu[i] : T(0);
  r.pv = phys ? io.pv[i] : T(0);
  r.pt = phys ? io.pt[i] : T(0);
  r.pq = phys ? io.pq[i] : T(0);
  if (k == 0) {
    sh.px[x] = g[(size_t)(6 * K) * G + c];
    sh.py[x] = g[(size_t)(6 * K + 1) * G + c];
  }
  sh.dv[k][x] = r.dv;
  sh.t[k][x] = r.t;
  sh.q[k][x] = r.q;
  sh.u[k][x] = r.u;
  sh.v[k][x] = r.v;
}

// Phase 2, level 0 only: the sums of column x; psfield stored.
template <typename T, int K, int C>
COL_HD void grid_block_sums(const GridTab<T, K>& tb, const GridIO<T>& io,
                            GridShared<T, K, C>& sh, int c, int x) {
  if (c >= io.G) return;
  T u[K], v[K], dv[K], dmean, psfield, puv[K], sigdt[K + 1], sigm[K + 1];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    u[k] = sh.u[k][x];
    v[k] = sh.v[k][x];
    dv[k] = sh.dv[k][x];
  }
  grid_sums(tb, u, v, dv, sh.px[x], sh.py[x], dmean, psfield, puv, sigdt,
            sigm);
  io.out[c] = psfield;
#pragma unroll
  for (int k = 0; k < K; ++k) sh.puv[k][x] = puv[k];
#pragma unroll
  for (int j = 1; j <= K; ++j) {
    sh.sigdt[j][x] = sigdt[j];
    sh.sigm[j][x] = sigm[j];
  }
  sh.dmean[x] = dmean;
}

// Phase 3, every level: the fluxes at half levels k and k + 1 and the
// outputs of level k, stored.
template <typename T, int K, int C>
COL_HD void grid_block_level(const GridTab<T, K>& tb, const GridIO<T>& io,
                             const GridShared<T, K, C>& sh,
                             const GridReg<T>& r, int c, int x, int k) {
  if (c >= io.G) return;
  const T tgg = gd_sub(r.t, tb.tref[k]);
  const T zero = T(0);
  // half level k, between levels k-1 and k (none above the top level)
  GridFlux<T> a = {zero, zero, zero, zero};
  if (k > 0)
    a = grid_flux(tb, k, sh.sigdt[k][x], sh.sigm[k][x], r.u,
                  sh.u[k - 1][x], r.v, sh.v[k - 1][x], tgg,
                  gd_sub(sh.t[k - 1][x], tb.tref[k - 1]), r.q,
                  sh.q[k - 1][x]);
  // half level k + 1, between levels k and k+1 (none below the bottom)
  GridFlux<T> b = {zero, zero, zero, zero};
  if (k < K - 1)
    b = grid_flux(tb, k + 1, sh.sigdt[k + 1][x], sh.sigm[k + 1][x],
                  sh.u[k + 1][x], r.u, sh.v[k + 1][x], r.v,
                  gd_sub(sh.t[k + 1][x], tb.tref[k + 1]), tgg,
                  sh.q[k + 1][x], r.q);
  const T sigdt0 = k > 0 ? sh.sigdt[k][x] : zero;
  const T sigm0 = k > 0 ? sh.sigm[k][x] : zero;
  grid_store<T, K>(
      io, k, c,
      grid_level(tb, k, tb.coriol[c / io.nlon], r.vor, r.dv, r.t, r.q, r.u,
                 r.v, sh.px[x], sh.py[x], sh.puv[k][x], sh.dmean[x], sigdt0,
                 sh.sigdt[k + 1][x], sigm0, sh.sigm[k + 1][x], a, b,
                 io.pu != nullptr, r.pu, r.pv, r.pt, r.pq));
}

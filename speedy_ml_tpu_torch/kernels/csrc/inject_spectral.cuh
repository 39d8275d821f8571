// K18: the injection's spectral glue, for float and double, as CUDA
// device code and as plain C++ (glue_host.cpp compiles this very file for
// the CPU tests).
//
// Replaces (JAX package) the spectral part of
// speedy_ml_tpu/hybrid/model.py:404-434 inject_to_speedy (vdspec's vds,
// spectral.py:307-349; the five trunct; uv_grid's uvspec, :351-387; and
// the stacks).  From K5's analysis of [t, q (K each), logp | u cos,
// v cos (K each)] (u and v already times 1/cos), per coefficient (m, n):
//   vor = trunct((vddym u[n-1] - vddyp u[n+1]) + zrow ((i gradx) v[n]))
//   div = trunct((-vddym v[n-1] + vddyp v[n+1]) + zrow ((i gradx) u[n]))
//   t_s, q_s, ps_s = trunct of the analysed t, q, logp
// and from the truncated vor, div the uvspec of spectral_stack.cuh.  Out:
// both leapfrog levels of the SpectralState (vor, div, t, ps, tr), and
// the stack [t_s, q_s | u cos, v cos] (4K fields, 1/cos from field 2K on)
// that K6 takes back to the grid for the gate.
//
// Every operation is rounded apart in the plain version's order with the
// complex products written as spectral_stack.cuh writes them (the terms
// whose product is an exact zero left away); trunct is the product by the
// 0/1 mask trfilt, kept as a product so that a NaN stays a NaN.
//
// The block: one zonal wavenumber m, thread (n, k) on coefficient n of
// level k.  inject_block_load: the analysed u cos and v cos of the row
// into shared memory, t, q, logp truncated and stored; inject_block_vds:
// vor and div from the n +- 1 neighbours, truncated, stored, and kept in
// shared memory; inject_block_uv: u cos and v cos of the truncated vor
// and div from their neighbours.
#pragma once

#include "spectral_stack.cuh"

// The table blob (kernels/inject_spectral.py inject_blob), in elements:
// uvdx, uvdym, uvdyp, vddym, vddyp, trfilt (mx * nx each), gradx (mx),
// zrow (nx).
template <typename T>
struct InjTab {
  const T *uvdx, *uvdym, *uvdyp, *vddym, *vddyp, *trfilt, *gradx, *zrow;
  COL_HD InjTab(const T* b, int mx, int nx) {
    const size_t MN = (size_t)mx * nx;
    uvdx = b;
    uvdym = uvdx + MN;
    uvdyp = uvdym + MN;
    vddym = uvdyp + MN;
    vddyp = vddym + MN;
    trfilt = vddyp + MN;
    gradx = trfilt + MN;
    zrow = gradx + mx;
  }
};

// spec (4K + 1, mx, nx): K5's output; the state vor, div, t (2, K, mx,
// nx), ps (2, mx, nx), tr (2, 1, K, mx, nx); stk (4K, mx, nx).
template <typename T>
struct InjIO {
  const stack_c<T>* spec;
  stack_c<T> *vor, *div, *t, *ps, *tr, *stk;
  int mx, nx;
};

template <typename T, int K>
struct InjShared {
  stack_c<T> u[K][STACK_MAX_N], v[K][STACK_MAX_N];
  stack_c<T> vor[K][STACK_MAX_N], div[K][STACK_MAX_N];
};

template <typename T>
COL_HD stack_c<T> inj_trunc(T trfilt, stack_c<T> z) {
  return sc_rmul(trfilt, z);
}

// value z of level k at (m, n) into both leapfrog levels of a state
// field of K levels
template <typename T>
COL_HD void inj_both(stack_c<T>* f, int K, int k, size_t MN, size_t c,
                     stack_c<T> z) {
  f[(size_t)k * MN + c] = z;
  f[((size_t)K + k) * MN + c] = z;
}

template <typename T, int K>
COL_HD void inject_block_load(const InjTab<T>& tb, const InjIO<T>& io,
                              InjShared<T, K>& sh, int m, int n, int k) {
  const size_t MN = (size_t)io.mx * io.nx;
  const size_t c = (size_t)m * io.nx + n;
  sh.u[k][n] = io.spec[(size_t)(2 * K + 1 + k) * MN + c];
  sh.v[k][n] = io.spec[(size_t)(3 * K + 1 + k) * MN + c];
  const T tf = tb.trfilt[c];
  const stack_c<T> t_s = inj_trunc(tf, io.spec[(size_t)k * MN + c]);
  const stack_c<T> q_s = inj_trunc(tf, io.spec[(size_t)(K + k) * MN + c]);
  inj_both(io.t, K, k, MN, c, t_s);
  inj_both(io.tr, K, k, MN, c, q_s);
  io.stk[(size_t)k * MN + c] = t_s;
  io.stk[(size_t)(K + k) * MN + c] = q_s;
  if (k == 0)
    inj_both(io.ps, 1, 0, MN, c,
             inj_trunc(tf, io.spec[(size_t)(2 * K) * MN + c]));
}

template <typename T, int K>
COL_HD void inject_block_vds(const InjTab<T>& tb, const InjIO<T>& io,
                             InjShared<T, K>& sh, int m, int n, int k) {
  const int nx = io.nx;
  const size_t MN = (size_t)io.mx * nx;
  const size_t c = (size_t)m * nx + n;
  const T g = tb.gradx[m], z = tb.zrow[n], tf = tb.trfilt[c];
  const T ym = tb.vddym[c], yp = tb.vddyp[c];
  const stack_c<T> zp = sc_rmul(z, sc_imul(g, sh.u[k][n]));
  const stack_c<T> zc = sc_rmul(z, sc_imul(g, sh.v[k][n]));
  const stack_c<T> vor = inj_trunc(
      tf, sc_add(sc_sub(sc_rmul(ym, stack_at(sh.u[k], n - 1, nx)),
                        sc_rmul(yp, stack_at(sh.u[k], n + 1, nx))),
                 zc));
  const stack_c<T> div = inj_trunc(
      tf, sc_add(sc_add(sc_rmul(-ym, stack_at(sh.v[k], n - 1, nx)),
                        sc_rmul(yp, stack_at(sh.v[k], n + 1, nx))),
                 zp));
  inj_both(io.vor, K, k, MN, c, vor);
  inj_both(io.div, K, k, MN, c, div);
  sh.vor[k][n] = vor;
  sh.div[k][n] = div;
}

template <typename T, int K>
COL_HD void inject_block_uv(const InjTab<T>& tb, const InjIO<T>& io,
                            const InjShared<T, K>& sh, int m, int n,
                            int k) {
  const int nx = io.nx;
  const size_t MN = (size_t)io.mx * nx;
  const size_t c = (size_t)m * nx + n;
  stack_c<T> u, v;
  stack_uv(tb.uvdx[c], tb.uvdym[c], tb.uvdyp[c], tb.zrow[n],
           stack_at(sh.vor[k], n - 1, nx), sh.vor[k][n],
           stack_at(sh.vor[k], n + 1, nx), stack_at(sh.div[k], n - 1, nx),
           sh.div[k][n], stack_at(sh.div[k], n + 1, nx), u, v);
  io.stk[(size_t)(2 * K + k) * MN + c] = u;
  io.stk[(size_t)(3 * K + k) * MN + c] = v;
}

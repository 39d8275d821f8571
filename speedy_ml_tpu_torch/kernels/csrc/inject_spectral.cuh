// K18's arithmetic, the injection's spectral glue, for float and double,
// as CUDA device code and as plain C++ (glue_host.cpp and sht_host.cpp
// compile this very file for the CPU tests); and K6_inject, phase 0 of
// the injection's synthesis launch that computes it (sht_synthesis.cu).
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
// The first design (K18, a launch of its own in an earlier version, kept
// as the host tests' reference): a block per zonal wavenumber m, thread (n, k)
// on coefficient n of level k.  inject_block_load: the analysed u cos and
// v cos of the row into shared memory, t, q, logp truncated and stored;
// inject_block_vds: vor and div from the n +- 1 neighbours, truncated,
// stored, and kept in shared memory; inject_block_uv: u cos and v cos of
// the truncated vor and div from their neighbours.
//
// K6_inject (float only, at the end of this file): the stack never goes
// to device memory.  A block of K6's synthesis (2 fields x lp latitude
// pairs, sht.cuh) issues the copies of its Legendre rows and dft_inv, and
// while they land forms its fields' coefficients straight into K6's
// coefficient buffer: a warp per row m, lane n on coefficient n of each
// field, reading K5's rows and the tables from device memory (the n +- 1
// neighbours of vor and div by shuffles); the blocks of latitude group 0
// store leapfrog level 0 of the state, those of group 1 level 1.  Then
// K6's Legendre and DFT phases.
#pragma once

#include "sht.cuh"
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

// vds and trunct at one coefficient: ul, uc, ur are the analysed u cos
// at n-1, n, n+1 (zero beyond the row), vl, vc, vr v cos; g = gradx[m],
// z = zrow[n], tf = trfilt, ym, yp = vddym, vddyp at (m, n).
template <typename T>
COL_HD void inj_vds(T g, T z, T tf, T ym, T yp, stack_c<T> ul, stack_c<T> uc,
                    stack_c<T> ur, stack_c<T> vl, stack_c<T> vc,
                    stack_c<T> vr, stack_c<T>& vor, stack_c<T>& div) {
  const stack_c<T> zp = sc_rmul(z, sc_imul(g, uc));
  const stack_c<T> zc = sc_rmul(z, sc_imul(g, vc));
  vor = inj_trunc(tf, sc_add(sc_sub(sc_rmul(ym, ul), sc_rmul(yp, ur)), zc));
  div = inj_trunc(tf, sc_add(sc_add(sc_rmul(-ym, vl), sc_rmul(yp, vr)), zp));
}

template <typename T, int K>
COL_HD void inject_block_vds(const InjTab<T>& tb, const InjIO<T>& io,
                             InjShared<T, K>& sh, int m, int n, int k) {
  const int nx = io.nx;
  const size_t MN = (size_t)io.mx * nx;
  const size_t c = (size_t)m * nx + n;
  stack_c<T> vor, div;
  inj_vds(tb.gradx[m], tb.zrow[n], tb.trfilt[c], tb.vddym[c], tb.vddyp[c],
          stack_at(sh.u[k], n - 1, nx), sh.u[k][n],
          stack_at(sh.u[k], n + 1, nx), stack_at(sh.v[k], n - 1, nx),
          sh.v[k][n], stack_at(sh.v[k], n + 1, nx), vor, div);
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

// ------------------------------------------------ K6_inject (float only)

// The fused launch's operands beside K6's (ShtSynArgs, whose spec it does
// not read; B = 4K fields, ncos = 2K): K5's output spec (4K + 1, mx, nx),
// the table blob (InjTab), the state vor, div, t (2, K, mx, nx), ps (2,
// mx, nx), tr (2, 1, K, mx, nx).
struct InjSynArgs {
  const stack_c<float>* spec;
  const float* blob;
  stack_c<float> *vor, *div, *t, *ps, *tr;
  int K;
};

// the threads of a K6_inject block: its coefficient phase spreads the
// rows m over 16 warps (two rows a warp at T30), and its launch bounds
// leave a thread up to 128 registers
#define SHT_INJ_THREADS 512

// K6's tile at B fields (sht_syn_choose: 2 fields a block and the fewest
// latitude pairs that keep the grid within one block per SM), with
// SHT_INJ_THREADS threads: every phase strides over the block's threads.
static inline ShtSynTile sht_inj_choose(int B, int nlat, int nlon, int mx,
                                        int nx, int sms, size_t smem_max) {
  ShtSynTile tl = sht_syn_choose(B, nlat, nlon, mx, nx, sms, smem_max);
  tl.threads = SHT_INJ_THREADS;
  return tl;
}

// Field f of the stack [t, q | u cos, v cos]: its kind (0 t, 1 q, 2 u cos,
// 3 v cos) is f / K, its level f % K.  The K5 rows it reads: t and q their
// own (f), u cos and v cos the analysed u cos (2K + 1 + k) and v cos
// (3K + 1 + k) of their level k; rb = -1 for none.
SHT_HD void inj_rows(int f, int K, int* ra, int* rb) {
  const int kind = f / K, k = f - kind * K;
  *ra = kind < 2 ? f : 2 * K + 1 + k;
  *rb = kind < 2 ? -1 : 3 * K + 1 + k;
}

// What a block works out once for each of its fields (at most two, all t
// or q fields or all u cos or v cos fields: the stack's u cos part starts
// at the even field 2K), held as scalars (an array indexed by the field
// would go to local memory): the K5 rows it reads (ra: its own or its
// level's analysed u cos; rb: that level's analysed v cos, or logp for
// field 0 of a block that stores the state), where its state goes (st:
// the first leapfrog level the block stores of the state's field, nlev
// levels lstride apart; psd: ps, mn apart), a u cos field (uc); and the
// tables.
struct InjBlk {
  int nf, mn, nlev;
  bool uv, ps, uc0, uc1;
  size_t lstride;
  const stack_c<float>*ra0, *rb0, *ra1, *rb1;
  stack_c<float>*st0, *st1, *psd;
  const float *trfilt, *uvdx, *uvdym, *uvdyp, *vddym, *vddyp, *gradx, *zrow;
};

// The state's levels that block b stores: with two latitude groups or
// more, group 0 stores level 0 and group 1 level 1, so that two groups of
// blocks share the stores; with one group, both.
SHT_HD InjBlk inj_blk(const ShtSynArgs& a, const InjSynArgs& ia,
                      const ShtSynBlock& b, int lp) {
  const size_t mn = (size_t)a.mx * a.nx;
  const int groups = (a.nlat / 2 + lp - 1) / lp, g = b.j0 / lp;
  const int lev0 = groups < 2 || g > 1 ? 0 : g;
  InjBlk B;
  B.nf = b.nf;
  B.mn = (int)mn;
  B.nlev = groups < 2 ? 2 : (g < 2 ? 1 : 0);
  B.lstride = (size_t)ia.K * mn;
  B.uv = b.f0 >= 2 * ia.K;
  B.ps = b.f0 == 0 && B.nlev > 0;
  B.psd = ia.ps + (size_t)lev0 * mn;
  for (int fl = 0; fl < 2; ++fl) {
    const int f = b.f0 + (fl < b.nf ? fl : 0);
    const int kind = f / ia.K, k = f - kind * ia.K;
    int ra, rb;
    inj_rows(f, ia.K, &ra, &rb);
    if (fl == 0 && B.ps) rb = 2 * ia.K;
    stack_c<float>* dst = kind == 0   ? ia.t
                          : kind == 1 ? ia.tr
                          : kind == 2 ? ia.vor
                                      : ia.div;
    dst += ((size_t)lev0 * ia.K + k) * mn;
    const stack_c<float>* pa = ia.spec + ra * mn;
    const stack_c<float>* pb = ia.spec + (rb >= 0 ? rb : ra) * mn;
    if (fl == 0) {
      B.ra0 = pa, B.rb0 = pb, B.st0 = dst, B.uc0 = kind == 2;
    } else {
      B.ra1 = pa, B.rb1 = pb, B.st1 = dst, B.uc1 = kind == 2;
    }
  }
  const InjTab<float> tb(ia.blob, a.mx, a.nx);
  B.trfilt = tb.trfilt;
  B.uvdx = tb.uvdx;
  B.uvdym = tb.uvdym;
  B.uvdyp = tb.uvdyp;
  B.vddym = tb.vddym;
  B.vddyp = tb.vddyp;
  B.gradx = tb.gradx;
  B.zrow = tb.zrow;
  return B;
}

// The block's coefficients: a warp a row m, lane n on coefficient n of
// each of the block's fields, reading K5's rows and the tables from
// device memory (L2) while the Legendre rows and dft_inv land.  A lane
// from nx on works on coefficient nx - 1 and stores nothing.

// the coefficient of field fl at (m, n) into K6's buffer s.v (row fl mx +
// m), and st into the state's levels
SHT_HD void inj_store(const InjBlk& B, const ShtSynArgs& a,
                      const ShtSynSmem& s, int fl, int m, int n,
                      stack_c<float> v, stack_c<float> st) {
  float* o = s.v + (fl * a.mx + m) * s.vs + 2 * n;
  o[0] = v.x;
  o[1] = v.y;
  stack_c<float>* d = (fl ? B.st1 : B.st0) + m * a.nx + n;
  for (int j = 0; j < B.nlev; ++j) d[j * B.lstride] = st;
}

// A t or q row: the truncated coefficients into s.v and the state, and on
// field 0 of a block that stores the state ps.
SHT_HD void inj_tq_lane(const InjBlk& B, const ShtSynArgs& a,
                        const ShtSynSmem& s, int m, int n) {
  const int nx = a.nx;
  if (n >= nx) return;
  const int c = m * nx + n;
  const float tf = B.trfilt[c];
  SHT_UNROLL(unroll)
  for (int fl = 0; fl < 2; ++fl)
    if (fl < B.nf) {
      const stack_c<float> v = inj_trunc(tf, (fl ? B.ra1 : B.ra0)[c]);
      inj_store(B, a, s, fl, m, n, v, v);
    }
  if (B.ps) {
    const stack_c<float> p = inj_trunc(tf, B.rb0[c]);
    for (int j = 0; j < B.nlev; ++j) B.psd[j * B.mn + c] = p;
  }
}

// A u cos or v cos row, lane n: what inj_uv_load works out before the
// exchange (vor and div of each field's level, the tables of uvspec), and
// the neighbours of vor and div the exchange hands it.
struct InjLane {
  stack_c<float> vor[2], div[2];
  float uvdx, uvdym, uvdyp, zrow;
};
struct InjNb {
  // [field][0]: lane n-1's, [field][1]: lane n+1's
  stack_c<float> vor[2][2], div[2][2];
};

SHT_HD void inj_uv_load(InjLane& L, const InjBlk& B, const ShtSynArgs& a,
                        int m, int n) {
  const int nx = a.nx;
  const int nn = n < nx ? n : nx - 1, c = m * nx + nn;
  L.uvdx = B.uvdx[c];
  L.uvdym = B.uvdym[c];
  L.uvdyp = B.uvdyp[c];
  L.zrow = B.zrow[nn];
  const float g = B.gradx[m], tf = B.trfilt[c];
  const float ym = B.vddym[c], yp = B.vddyp[c];
  SHT_UNROLL(unroll)
  for (int fl = 0; fl < 2; ++fl) {
    L.vor[fl] = L.div[fl] = sc_mk(0.f, 0.f);
    if (fl < B.nf) {
      const stack_c<float>* ru = (fl ? B.ra1 : B.ra0) + m * nx;
      const stack_c<float>* rv = (fl ? B.rb1 : B.rb0) + m * nx;
      inj_vds(g, L.zrow, tf, ym, yp, stack_at(ru, nn - 1, nx), ru[nn],
              stack_at(ru, nn + 1, nx), stack_at(rv, nn - 1, nx), rv[nn],
              stack_at(rv, nn + 1, nx), L.vor[fl], L.div[fl]);
    }
  }
}

// xch(v, fl, d): lane n + d's vor[fl] (v = 0) or div[fl] (v = 1), d = -1
// or +1, called by every lane of the warp together.  (On the card xch is
// a device lambda: the pragma keeps nvcc from warning of its host
// instantiation, which is never made.)
#if defined(__CUDACC__) && !defined(__clang__)
#pragma nv_exec_check_disable
#endif
template <typename X>
SHT_HD void inj_uv_exchange(const InjBlk& B, int nx, int n, X xch,
                            InjNb& nb) {
  const stack_c<float> z = sc_mk(0.f, 0.f);
  const bool lo = n > 0, hi = n + 1 < nx;
  SHT_UNROLL(unroll)
  for (int fl = 0; fl < 2; ++fl)
    if (fl < B.nf) {
      const stack_c<float> vl = xch(0, fl, -1), vr = xch(0, fl, 1);
      const stack_c<float> dl = xch(1, fl, -1), dr = xch(1, fl, 1);
      nb.vor[fl][0] = lo ? vl : z;
      nb.vor[fl][1] = hi ? vr : z;
      nb.div[fl][0] = lo ? dl : z;
      nb.div[fl][1] = hi ? dr : z;
    }
}

// The u cos or v cos coefficients into s.v, and vor (u cos) or div (v
// cos) into the state.
SHT_HD void inj_uv_out(const InjLane& L, const InjNb& nb, const InjBlk& B,
                       const ShtSynArgs& a, const ShtSynSmem& s, int m,
                       int n) {
  if (n >= a.nx) return;
  SHT_UNROLL(unroll)
  for (int fl = 0; fl < 2; ++fl)
    if (fl < B.nf) {
      stack_c<float> u, w;
      stack_uv(L.uvdx, L.uvdym, L.uvdyp, L.zrow, nb.vor[fl][0], L.vor[fl],
               nb.vor[fl][1], nb.div[fl][0], L.div[fl], nb.div[fl][1], u, w);
      const bool uc = fl ? B.uc1 : B.uc0;
      inj_store(B, a, s, fl, m, n, uc ? u : w, uc ? L.vor[fl] : L.div[fl]);
    }
}

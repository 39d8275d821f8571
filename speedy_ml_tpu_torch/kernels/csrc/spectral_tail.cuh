// The arithmetic of K8 (spectral_tail.cu), shared with its host build
// (tail_host.cpp, which the CPU tests compile with g++ and hold against a
// naive per-coefficient loop and the plain PyTorch version), for float
// and double.
//
// Layout: a group of TAIL_GROUP = 8 lanes per spectral coefficient (m, n),
// lane k doing level k (at K = 5 or 7 the spare lanes repeat level K-1
// and store nothing).  A lane runs the phases below in order; between
// them the group exchanges one value per level (the kernel with
// __shfl_sync inside the group, the host build by copying), and every
// lane receives the K values of its group as an array g[K]:
//   tail_load      the lane's reads of the operands: level k's
//                  tendencies from the analysed stack A, the state, row k
//                  of xj -> gather div and t at level j4 (dv, ts);
//   tail_vertical  dmeanc, the sigma-dot scan, dumk, the geopotential
//                  scan from the top, sptend of level k -> gather tdt;
//   tail_ye        (implicit) ye, yf of level k -> gather yf;
//   tail_xj        (implicit) row k of xj[l] times yf -> gather divdt;
//   tail_finish    (implicit) psdt, the xc mix; the diffusion, the drag,
//                  the extra del^2 of level 0, trunct, the leapfrog and
//                  the Robert-Asselin-Williams filter, the stores.
// Every sum over levels is taken by each lane over the gathered values in
// the order of the first design (one thread per coefficient, all levels
// in registers), so a lane's result is that design's, operation for
// operation; the per-coefficient values (psdt, dmeanc) come out the same
// on every lane of the group.
//
// The semi-implicit inverse xj depends only on the total wavenumber l =
// m + n: the blob holds it once per l (lmax rows of K x TAIL_XJ_ROW, each
// row padded to 8 elements and 16-byte aligned, so that a lane reads its
// row k as two 16-byte loads), zero at l = 0.
#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#define TAIL_HD __host__ __device__ __forceinline__
#else
#define TAIL_HD inline
#endif

#define TAIL_GROUP 8     // lanes a coefficient; K <= TAIL_GROUP
#define TAIL_XJ_ROW 8    // elements a row of the per-l xj table

template <typename T>
struct alignas(2 * sizeof(T)) tail_c {
  T x, y;
};
template <typename T>
TAIL_HD tail_c<T> tail_mk(T x, T y) {
  tail_c<T> r;
  r.x = x;
  r.y = y;
  return r;
}
template <typename T>
TAIL_HD tail_c<T> operator+(tail_c<T> a, tail_c<T> b) {
  return tail_mk(a.x + b.x, a.y + b.y);
}
template <typename T>
TAIL_HD tail_c<T> operator-(tail_c<T> a, tail_c<T> b) {
  return tail_mk(a.x - b.x, a.y - b.y);
}
template <typename T>
TAIL_HD tail_c<T> operator*(T s, tail_c<T> a) {
  return tail_mk(s * a.x, s * a.y);
}
// i * g * a: (0 + i g)(a.x + i a.y)
template <typename T>
TAIL_HD tail_c<T> tail_itimes(T g, tail_c<T> a) {
  return tail_mk(-g * a.y, g * a.x);
}
// g[i] for an index known only at run time, as selects over an unrolled
// loop (a register array indexed by a variable would go to local memory)
template <typename T, int K>
TAIL_HD tail_c<T> tail_pick(const tail_c<T> (&g)[K], int i) {
  tail_c<T> r = g[0];
#pragma unroll
  for (int l = 1; l < K; ++l)
    if (l == i) r = g[l];
  return r;
}

// Offsets in the table blob (kernels/spectral_tail.py tail_blob), in
// elements: 12 (K,) tables, xc and xd (K, K); gradx (mx,), zrow (nx,);
// 11 (mx, nx) tables; padding to a multiple of 4; xj (lmax, K,
// TAIL_XJ_ROW) with lmax = mx + nx - 2.
TAIL_HD size_t tail_xj_offset(int K, int mx, int nx) {
  const size_t o = (size_t)12 * K + 2 * K * K + mx + nx + (size_t)11 * mx * nx;
  return (o + 3) / 4 * 4;
}
TAIL_HD size_t tail_blob_size(int K, int mx, int nx) {
  return tail_xj_offset(K, mx, nx) +
         (size_t)(mx + nx - 2) * K * TAIL_XJ_ROW;
}

template <typename T, int K>
struct TailTab {
  const T *dhs, *dhsr, *xgeop1, *xgeop2, *corf, *tcorv, *qcorv, *tref,
      *tref1, *tref2, *tref3, *dhsx, *xc, *xd;
  const T *gradx, *zrow;
  const T *vddym, *vddyp, *el2, *trfilt, *dmp, *dmpd, *dmps, *elz, *dmp1,
      *dmp1d, *dmp1s;
  const T* xj;
  int lmax;
  // m0: the wavenumber of row 0 (a shard's m range, GCM.set_mesh); its
  // blob holds xj up to l = m0 + mx + nx - 2
  TAIL_HD TailTab(const T* blob, int mx, int nx, int m0 = 0) {
    dhs = blob;
    dhsr = dhs + K;
    xgeop1 = dhsr + K;
    xgeop2 = xgeop1 + K;
    corf = xgeop2 + K;
    tcorv = corf + K;
    qcorv = tcorv + K;
    tref = qcorv + K;
    tref1 = tref + K;
    tref2 = tref1 + K;
    tref3 = tref2 + K;
    dhsx = tref3 + K;
    xc = dhsx + K;
    xd = xc + K * K;
    const size_t MN = (size_t)mx * nx;
    gradx = blob + 12 * K + 2 * K * K;
    zrow = gradx + mx;
    vddym = zrow + nx;
    vddyp = vddym + MN;
    el2 = vddyp + MN;
    trfilt = el2 + MN;
    dmp = trfilt + MN;
    dmpd = dmp + MN;
    dmps = dmpd + MN;
    elz = dmps + MN;
    dmp1 = elz + MN;
    dmp1d = dmp1 + MN;
    dmp1s = dmp1d + MN;
    xj = blob + tail_xj_offset(K, mx, nx);
    lmax = m0 + mx + nx - 2;
  }
};

// Row k of the inverse at (m, n), as the first design's per-(m, n) copy
// held it: xj[clip(l, 1, lmax) - 1] with l = m + n, and zero at l = 0.
template <typename T, int K>
TAIL_HD void tail_xj_row(const TailTab<T, K>& tb, int m, int n, int k,
                         T (&r)[K]) {
  const int l = m + n;
  if (l == 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) r[i] = T(0);
    return;
  }
  const T* row =
      tb.xj + ((size_t)((l < tb.lmax ? l : tb.lmax) - 1) * K + k) *
                  TAIL_XJ_ROW;
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(row)[0];
    const float4 b = reinterpret_cast<const float4*>(row)[1];
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < K; ++i) r[i] = v[i];
  } else
#endif
  {
#pragma unroll
    for (int i = 0; i < K; ++i) r[i] = row[i];
  }
}

// The kernel's operands: A (1 + 9K, mx, nx); vor/div/t (2, K, mx, nx);
// ps (2, mx, nx); tr (2, 1, K, mx, nx); phis/tcorh/qcorh (mx, nx), tcorh
// and qcorh may be null; outputs shaped as the state.
template <typename T>
struct TailIO {
  const tail_c<T>*A, *vor, *div, *tem, *ps, *tr, *phis, *tcorh, *qcorh;
  tail_c<T>*o_vor, *o_div, *o_t, *o_ps, *o_tr;
  int mx, nx, j1, j4, implicit, trunc;
  T dt, ew1, ew2, sdrag, rgas;
  // the first zonal wavenumber of the operands' rows: row m is the
  // wavenumber m0 + m (a shard's m range); the tables are the range's
  int m0 = 0;
};

// The operands from the launch's untyped pointers (host code).
template <typename T>
inline TailIO<T> tail_io(int mx, int nx, const void* A, const void* vor,
                         const void* div, const void* tem, const void* ps,
                         const void* tr, const void* phis, const void* tcorh,
                         const void* qcorh, int j1, int j4, int implicit,
                         int trunc, T dt, T ew1, T ew2, T sdrag, T rgas,
                         void* o_vor, void* o_div, void* o_t, void* o_ps,
                         void* o_tr) {
  typedef const tail_c<T>* In;
  typedef tail_c<T>* Out;
  TailIO<T> io;
  io.A = (In)A;
  io.vor = (In)vor;
  io.div = (In)div;
  io.tem = (In)tem;
  io.ps = (In)ps;
  io.tr = (In)tr;
  io.phis = (In)phis;
  io.tcorh = (In)tcorh;
  io.qcorh = (In)qcorh;
  io.o_vor = (Out)o_vor;
  io.o_div = (Out)o_div;
  io.o_t = (Out)o_t;
  io.o_ps = (Out)o_ps;
  io.o_tr = (Out)o_tr;
  io.mx = mx;
  io.nx = nx;
  io.j1 = j1;
  io.j4 = j4;
  io.implicit = implicit;
  io.trunc = trunc;
  io.dt = dt;
  io.ew1 = ew1;
  io.ew2 = ew2;
  io.sdrag = sdrag;
  io.rgas = rgas;
  return io;
}

// What a lane carries from one phase to the next.  tail_load reads the
// operands and the state the later phases use, so that those reads wait
// for no exchange and no store; the tables (the (K,) and (mx, nx) ones)
// are read in the phase that uses them.
template <typename T, int K>
struct TailLane {
  int idx, m, n, k;  // coefficient, its (m0 + m, n), the lane's level
  bool store;        // false on a spare lane
  tail_c<T> vordt, divdt, tdt, qdt, psdt, pss, dv, ts, yf;
  // the state at level k (vor, div, t, tr; ps), leapfrog levels 0 and
  // j1 - 1; phis and the orographic corrections at (m, n)
  tail_c<T> old1[4], oldj[4], ps1, psj, phis, tc, qc;
  T xj[K];  // row k of the inverse at l = m + n
};

template <typename T, int K>
TAIL_HD void tail_load(TailLane<T, K>& L, const TailIO<T>& io,
                       const TailTab<T, K>& tb, int idx, int lane) {
  const int mx = io.mx, nx = io.nx, MN = mx * nx;
  const int m = idx / nx, n = idx - m * nx;
  const int k = lane < K ? lane : K - 1;
  L.idx = idx;
  L.m = io.m0 + m;
  L.n = n;
  L.k = k;
  L.store = lane < K;
  const T ym = tb.vddym[idx], yp = tb.vddyp[idx], gz = tb.gradx[m] * tb.zrow[n];
  const T l2 = tb.el2[idx];
  const tail_c<T> zero = tail_mk(T(0), T(0));
  auto at = [&](int f, int nn) -> tail_c<T> {
    if (nn < 0 || nn >= nx) return zero;
    return io.A[((size_t)f * mx + m) * nx + nn];
  };
  const int o_s = 1, o_u = 1 + 3 * K, o_v = 1 + 6 * K;
  const tail_c<T> uc = at(o_u + k, n), vc = at(o_v + k, n);
  L.vordt = (ym * at(o_u + k, n - 1) - yp * at(o_u + k, n + 1)) +
            tail_itimes(gz, vc);
  L.divdt = (yp * at(o_v + k, n + 1) - ym * at(o_v + k, n - 1)) +
            tail_itimes(gz, uc);
  L.divdt = L.divdt + l2 * at(o_s + k, n);
  L.tdt = ((yp * at(o_v + K + k, n + 1) - ym * at(o_v + K + k, n - 1)) +
           tail_itimes(gz, at(o_u + K + k, n))) +
          at(o_s + K + k, n);
  L.qdt = ((yp * at(o_v + 2 * K + k, n + 1) -
            ym * at(o_v + 2 * K + k, n - 1)) +
           tail_itimes(gz, at(o_u + 2 * K + k, n))) +
          at(o_s + 2 * K + k, n);
  L.psdt = L.m == 0 && n == 0 ? zero : at(0, n);
  L.dv = io.div[((size_t)io.j4 * K + k) * MN + idx];
  L.ts = io.tem[((size_t)io.j4 * K + k) * MN + idx];
  L.pss = io.ps[(size_t)io.j4 * MN + idx];
  const size_t off = (size_t)k * MN + idx, lj = (size_t)(io.j1 - 1) * K * MN;
  const tail_c<T>* f[4] = {io.vor, io.div, io.tem, io.tr};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    L.old1[i] = f[i][off];
    L.oldj[i] = f[i][lj + off];
  }
  L.ps1 = io.ps[idx];
  L.psj = io.ps[(size_t)(io.j1 - 1) * MN + idx];
  L.phis = io.phis[idx];
  L.tc = io.tcorh ? io.tcorh[idx] : zero;
  L.qc = io.qcorh ? io.qcorh[idx] : zero;
  tail_xj_row(tb, L.m, n, k, L.xj);
}

// sptend: dv, ts are the group's div and t at level j4.
template <typename T, int K>
TAIL_HD void tail_vertical(TailLane<T, K>& L, const TailIO<T>& io,
                           const TailTab<T, K>& tb,
                           const tail_c<T> (&dv)[K],
                           const tail_c<T> (&ts)[K]) {
  const int k = L.k;
  const tail_c<T> zero = tail_mk(T(0), T(0));
  tail_c<T> dmeanc = tb.dhs[0] * dv[0];
#pragma unroll
  for (int l = 1; l < K; ++l) dmeanc = dmeanc + tb.dhs[l] * dv[l];
  L.psdt = L.m == 0 && L.n == 0 ? zero : L.psdt - dmeanc;
  // sigma-dot on half levels k and k+1 (0 at the top and the bottom)
  tail_c<T> s = zero, sk = zero, sk1 = zero;
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    s = s + (-tb.dhs[j]) * (dv[j] - dmeanc);
    if (j + 1 == k) sk = s;
    if (j + 1 == k + 1) sk1 = s;
  }
  const tail_c<T> dk = k == 0 ? zero : (tb.tref[k] - tb.tref[k - 1]) * sk;
  const tail_c<T> dk1 =
      k == K - 1 ? zero : (tb.tref[k + 1] - tb.tref[k]) * sk1;
  L.tdt = ((L.tdt - tb.dhsr[k] * (dk1 + dk)) + tb.tref3[k] * (sk1 + sk)) -
          tb.tref2[k] * dmeanc;
  // the geopotential, integrated from the bottom level up
  tail_c<T> p = L.phis + tb.xgeop1[K - 1] * ts[K - 1];
  tail_c<T> phik = p;
#pragma unroll
  for (int j = K - 2; j >= 0; --j) {
    p = (p + tb.xgeop2[j + 1] * ts[j + 1]) + tb.xgeop1[j] * ts[j];
    if (j == k) phik = p;
  }
  if (L.m == 0 && k >= 1 && k <= K - 2)
    phik = phik + tb.corf[k] * (tail_pick(ts, k + 1) - tail_pick(ts, k - 1));
  L.divdt = L.divdt + tb.el2[L.idx] * (phik + (io.rgas * tb.tref[k]) * L.pss);
}

// The semi-implicit correction, first half: tdt is the group's.
template <typename T, int K>
TAIL_HD void tail_ye(TailLane<T, K>& L, const TailTab<T, K>& tb,
                     const tail_c<T> (&tdt)[K]) {
  const int k = L.k;
  const T* xd = tb.xd + k * K;
  tail_c<T> ye = xd[0] * tdt[0];
#pragma unroll
  for (int l = 1; l < K; ++l) ye = ye + xd[l] * tdt[l];
  ye = ye + tb.tref1[k] * L.psdt;
  L.yf = L.divdt + tb.elz[L.idx] * ye;
}

// Row k of xj[l] times the group's yf.
template <typename T, int K>
TAIL_HD void tail_xj(TailLane<T, K>& L, const tail_c<T> (&yf)[K]) {
  tail_c<T> d = L.xj[0] * yf[0];
#pragma unroll
  for (int l = 1; l < K; ++l) d = d + L.xj[l] * yf[l];
  L.divdt = d;
}

// dn: the group's corrected divdt (read only when io.implicit).  CG (the
// tendency form, cgrate_on): vor's and div's diffused tendencies are
// stored in level 0 of their outputs in place of their leapfrog, which K26
// (cgrate.cuh) runs after the limiter; the other fields as always.
template <typename T, int K, bool CG = false>
TAIL_HD void tail_finish(TailLane<T, K>& L, const TailIO<T>& io,
                         const TailTab<T, K>& tb,
                         const tail_c<T> (&dn)[K]) {
  const int k = L.k, idx = L.idx;
  const size_t MN = (size_t)io.mx * io.nx;
  if (io.implicit) {
    tail_c<T> s = tb.dhsx[0] * dn[0];
#pragma unroll
    for (int l = 1; l < K; ++l) s = s + tb.dhsx[l] * dn[l];
    L.psdt = L.psdt - s;
    const T* xc = tb.xc + k * K;
    tail_c<T> d = xc[0] * dn[0];
#pragma unroll
    for (int l = 1; l < K; ++l) d = d + xc[l] * dn[l];
    L.tdt = L.tdt + d;
  }
  // horizontal diffusion, drag, top-level del^2 (level-0 state)
  const T d_v = tb.dmp[idx], d_d = tb.dmpd[idx], d_s = tb.dmps[idx];
  const T f_v = tb.dmp1[idx], f_d = tb.dmp1d[idx], f_s = tb.dmp1s[idx];
  const tail_c<T> vor0 = L.old1[0], div0 = L.old1[1];
  tail_c<T> ctmp = L.old1[2];
  if (io.tcorh) ctmp = ctmp + tb.tcorv[k] * L.tc;
  tail_c<T> qtmp = L.old1[3];
  if (io.qcorh) qtmp = qtmp + tb.qcorv[k] * L.qc;
  tail_c<T> fdt[4] = {f_v * (L.vordt - d_v * vor0),
                      f_d * (L.divdt - d_d * div0),
                      f_v * (L.tdt - d_v * ctmp),
                      f_d * (L.qdt - d_d * qtmp)};
  if (k == 0) {
    if (L.m == 0) {
      fdt[0] = fdt[0] - io.sdrag * vor0;
      fdt[1] = fdt[1] - io.sdrag * div0;
    }
    fdt[0] = f_s * (fdt[0] - d_s * vor0);
    fdt[1] = f_s * (fdt[1] - d_s * div0);
    fdt[2] = f_s * (fdt[2] - d_s * ctmp);
  }
  if (!L.store) return;
  // trunct + leapfrog + Robert-Asselin-Williams filter
  const T tf = io.trunc ? tb.trfilt[idx] : T(1);
  auto step = [&](tail_c<T> old1, tail_c<T> oldj, tail_c<T>* o, size_t at,
                  size_t level, tail_c<T> dt_f) {
    if (io.trunc) dt_f = tf * dt_f;
    const tail_c<T> fnew = old1 + io.dt * dt_f;
    const tail_c<T> new1 =
        oldj + io.ew1 * ((old1 - T(2) * oldj) + fnew);
    const tail_c<T> new2 = fnew - io.ew2 * ((new1 - T(2) * oldj) + fnew);
    o[at] = new1;
    o[level + at] = new2;
  };
  const size_t lev = (size_t)K * MN;  // one leapfrog level of a 3-D field
  tail_c<T>* out[4] = {io.o_vor, io.o_div, io.o_t, io.o_tr};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (CG && i < 2)
      out[i][k * MN + idx] = fdt[i];
    else
      step(L.old1[i], L.oldj[i], out[i], k * MN + idx, lev, fdt[i]);
  }
  if (k == 0) step(L.ps1, L.psj, io.o_ps, idx, MN, L.psdt);
}

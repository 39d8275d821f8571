// Host build of K8's arithmetic (spectral_tail.cuh): the lane groups of
// the CUDA kernel written out as loops on the CPU, the exchanges inside a
// group as copies, beside a naive loop in the first design's order (one
// coefficient at a time, every level in arrays, the inverse read from the
// per-(m, n) table xj_g).  It is not part of the kernel library; the CPU
// tests compile it with a host C++ compiler
//   g++ -O2 -ffp-contract=off -shared -fPIC tail_host.cpp -o lib.so
// and hold the lane groups against the naive loop bit for bit and the
// double build against the plain PyTorch version.  The entry points take
// the launch's arguments less the device and the stream (the scalars as
// double, cast to the element type), and return 0, or 1 for a K that is
// not compiled.

#include "spectral_tail.cuh"

namespace {

// Every group of the kernel, its lanes as a loop.  `lanes`: how many of
// the group's levels an exchange reads (K; fewer leaves the others zero,
// a fault the tests must see).
template <typename T, int K>
void groups(const TailIO<T>& io, const T* blob, int lanes) {
  const TailTab<T, K> tb(blob, io.mx, io.nx);
  const tail_c<T> zero = tail_mk(T(0), T(0));
  TailLane<T, K> L[TAIL_GROUP];
  tail_c<T> g[K], h[K];
  auto gather = [&](tail_c<T> TailLane<T, K>::*f, tail_c<T>(&out)[K]) {
    for (int l = 0; l < K; ++l) out[l] = l < lanes ? L[l].*f : zero;
  };
  for (int idx = 0; idx < io.mx * io.nx; ++idx) {
    for (int ln = 0; ln < TAIL_GROUP; ++ln) tail_load(L[ln], io, tb, idx, ln);
    gather(&TailLane<T, K>::dv, g);
    gather(&TailLane<T, K>::ts, h);
    for (auto& x : L) tail_vertical(x, io, tb, g, h);
    if (io.implicit) {
      gather(&TailLane<T, K>::tdt, g);
      for (auto& x : L) tail_ye(x, tb, g);
      gather(&TailLane<T, K>::yf, g);
      for (auto& x : L) tail_xj(x, g);
      gather(&TailLane<T, K>::divdt, g);
    }
    for (auto& x : L) tail_finish(x, io, tb, g);
  }
}

// The first design, one coefficient at a time (spectral_tail.cu before
// the lane groups), reading xj_g (mx, nx, K, K).  reverse: sum the xd,
// xj and xc mixes from the last level down, a fault the tests must see.
template <typename T, int K>
void naive(const TailIO<T>& io, const T* blob, const T* xj_g, int reverse) {
  typedef tail_c<T> c2;
  const TailTab<T, K> tb(blob, io.mx, io.nx);
  const int mx = io.mx, nx = io.nx, MN = mx * nx;
  const c2 zero = tail_mk(T(0), T(0));
  auto mix = [&](const T* w, const c2 (&v)[K]) {
    c2 d = reverse ? w[K - 1] * v[K - 1] : w[0] * v[0];
    for (int i = 1; i < K; ++i) {
      const int l = reverse ? K - 1 - i : i;
      d = d + w[l] * v[l];
    }
    return d;
  };
  for (int idx = 0; idx < MN; ++idx) {
    const int m = idx / nx, n = idx - m * nx;
    const T ym = tb.vddym[idx], yp = tb.vddyp[idx], gx = tb.gradx[m],
            z = tb.zrow[n], l2 = tb.el2[idx];
    auto at = [&](int f, int nn) -> c2 {
      if (nn < 0 || nn >= nx) return zero;
      return io.A[((size_t)f * mx + m) * nx + nn];
    };
    const int o_s = 1, o_u = 1 + 3 * K, o_v = 1 + 6 * K;
    c2 vordt[K], divdt[K], tdt[K], qdt[K];
    for (int k = 0; k < K; ++k) {
      const c2 uc = at(o_u + k, n), vc = at(o_v + k, n);
      vordt[k] = (ym * at(o_u + k, n - 1) - yp * at(o_u + k, n + 1)) +
                 tail_itimes(gx * z, vc);
      divdt[k] = (yp * at(o_v + k, n + 1) - ym * at(o_v + k, n - 1)) +
                 tail_itimes(gx * z, uc);
      divdt[k] = divdt[k] + l2 * at(o_s + k, n);
      tdt[k] = ((yp * at(o_v + K + k, n + 1) - ym * at(o_v + K + k, n - 1)) +
                tail_itimes(gx * z, at(o_u + K + k, n))) +
               at(o_s + K + k, n);
      qdt[k] = ((yp * at(o_v + 2 * K + k, n + 1) -
                 ym * at(o_v + 2 * K + k, n - 1)) +
                tail_itimes(gx * z, at(o_u + 2 * K + k, n))) +
               at(o_s + 2 * K + k, n);
    }
    c2 psdt = idx == 0 ? zero : at(0, n);
    // sptend at level j4
    c2 dvs[K], ts[K];
    for (int k = 0; k < K; ++k) {
      dvs[k] = io.div[((size_t)io.j4 * K + k) * MN + idx];
      ts[k] = io.tem[((size_t)io.j4 * K + k) * MN + idx];
    }
    const c2 pss = io.ps[(size_t)io.j4 * MN + idx];
    c2 dmeanc = tb.dhs[0] * dvs[0];
    for (int k = 1; k < K; ++k) dmeanc = dmeanc + tb.dhs[k] * dvs[k];
    psdt = idx == 0 ? zero : psdt - dmeanc;
    c2 sig[K + 1];
    sig[0] = zero;
    sig[K] = zero;
    for (int k = 0; k < K - 1; ++k)
      sig[k + 1] = sig[k] + (-tb.dhs[k]) * (dvs[k] - dmeanc);
    c2 dumk[K + 1];
    dumk[0] = zero;
    dumk[K] = zero;
    for (int j = 1; j < K; ++j)
      dumk[j] = (tb.tref[j] - tb.tref[j - 1]) * sig[j];
    for (int k = 0; k < K; ++k)
      tdt[k] = ((tdt[k] - tb.dhsr[k] * (dumk[k + 1] + dumk[k])) +
                tb.tref3[k] * (sig[k + 1] + sig[k])) -
               tb.tref2[k] * dmeanc;
    c2 phi[K];
    phi[K - 1] = io.phis[idx] + tb.xgeop1[K - 1] * ts[K - 1];
    for (int k = K - 2; k >= 0; --k)
      phi[k] = (phi[k + 1] + tb.xgeop2[k + 1] * ts[k + 1]) +
               tb.xgeop1[k] * ts[k];
    if (m == 0)
      for (int k = 1; k < K - 1; ++k)
        phi[k] = phi[k] + tb.corf[k] * (ts[k + 1] - ts[k - 1]);
    for (int k = 0; k < K; ++k)
      divdt[k] = divdt[k] + l2 * (phi[k] + (io.rgas * tb.tref[k]) * pss);
    // semi-implicit correction
    if (io.implicit) {
      const T ez = tb.elz[idx];
      const T* xj = xj_g + (size_t)idx * K * K;
      c2 yf[K];
      for (int k = 0; k < K; ++k) {
        c2 ye = mix(tb.xd + k * K, tdt);
        ye = ye + tb.tref1[k] * psdt;
        yf[k] = divdt[k] + ez * ye;
      }
      for (int k = 0; k < K; ++k) divdt[k] = mix(xj + k * K, yf);
      c2 s = tb.dhsx[0] * divdt[0];
      for (int k = 1; k < K; ++k) s = s + tb.dhsx[k] * divdt[k];
      psdt = psdt - s;
      for (int k = 0; k < K; ++k) tdt[k] = tdt[k] + mix(tb.xc + k * K, divdt);
    }
    // horizontal diffusion, drag, top-level del^2
    const T d_v = tb.dmp[idx], d_d = tb.dmpd[idx], d_s = tb.dmps[idx];
    const T f_v = tb.dmp1[idx], f_d = tb.dmp1d[idx], f_s = tb.dmp1s[idx];
    const c2 tc = io.tcorh ? io.tcorh[idx] : zero;
    const c2 qc = io.qcorh ? io.qcorh[idx] : zero;
    c2 vor0[K], div0[K], ctmp[K];
    for (int k = 0; k < K; ++k) {
      vor0[k] = io.vor[(size_t)k * MN + idx];
      div0[k] = io.div[(size_t)k * MN + idx];
      ctmp[k] = io.tem[(size_t)k * MN + idx];
      if (io.tcorh) ctmp[k] = ctmp[k] + tb.tcorv[k] * tc;
      vordt[k] = f_v * (vordt[k] - d_v * vor0[k]);
      divdt[k] = f_d * (divdt[k] - d_d * div0[k]);
      tdt[k] = f_v * (tdt[k] - d_v * ctmp[k]);
      c2 qtmp = io.tr[(size_t)k * MN + idx];
      if (io.qcorh) qtmp = qtmp + tb.qcorv[k] * qc;
      qdt[k] = f_d * (qdt[k] - d_d * qtmp);
    }
    if (m == 0) {
      vordt[0] = vordt[0] - io.sdrag * vor0[0];
      divdt[0] = divdt[0] - io.sdrag * div0[0];
    }
    vordt[0] = f_s * (vordt[0] - d_s * vor0[0]);
    divdt[0] = f_s * (divdt[0] - d_s * div0[0]);
    tdt[0] = f_s * (tdt[0] - d_s * ctmp[0]);
    // trunct + leapfrog + Robert-Asselin-Williams filter
    const T tf = io.trunc ? tb.trfilt[idx] : T(1);
    const size_t lev = (size_t)K * MN;
    auto step = [&](const c2* f, c2* o, size_t off, size_t level, c2 fdt) {
      if (io.trunc) fdt = tf * fdt;
      const c2 old1 = f[off + idx];
      const c2 oldj = f[(size_t)(io.j1 - 1) * level + off + idx];
      const c2 fnew = old1 + io.dt * fdt;
      const c2 new1 = oldj + io.ew1 * ((old1 - T(2) * oldj) + fnew);
      const c2 new2 = fnew - io.ew2 * ((new1 - T(2) * oldj) + fnew);
      o[off + idx] = new1;
      o[level + off + idx] = new2;
    };
    for (int k = 0; k < K; ++k) {
      const size_t off = (size_t)k * MN;
      step(io.vor, io.o_vor, off, lev, vordt[k]);
      step(io.div, io.o_div, off, lev, divdt[k]);
      step(io.tem, io.o_t, off, lev, tdt[k]);
      step(io.tr, io.o_tr, off, lev, qdt[k]);
    }
    step(io.ps, io.o_ps, 0, (size_t)MN, psdt);
  }
}

}  // namespace

#define TAIL_DISPATCH(CALL)            \
  switch (K) {                         \
    case 5:                            \
      if (is_double) CALL(double, 5)   \
      else CALL(float, 5)              \
      break;                           \
    case 7:                            \
      if (is_double) CALL(double, 7)   \
      else CALL(float, 7)              \
      break;                           \
    case 8:                            \
      if (is_double) CALL(double, 8)   \
      else CALL(float, 8)              \
      break;                           \
    default:                           \
      return 1;                        \
  }

#define TAIL_IO(T)                                                       \
  tail_io<T>(mx, nx, A, vor, div, tem, ps, tr, phis, tcorh, qcorh, j1, j4, \
             implicit, trunc, (T)dt, (T)ew1, (T)ew2, (T)sdrag, (T)rgas,    \
             o_vor, o_div, o_t, o_ps, o_tr)

extern "C" long long tail_blob_size_host(int K, int mx, int nx) {
  return (long long)tail_blob_size(K, mx, nx);
}

extern "C" int spectral_tail_host(
    int K, int is_double, int mx, int nx, const void* A, const void* vor,
    const void* div, const void* tem, const void* ps, const void* tr,
    const void* phis, const void* tcorh, const void* qcorh, const void* blob,
    int j1, int j4, int implicit, int trunc, double dt, double ew1,
    double ew2, double sdrag, double rgas, void* o_vor, void* o_div,
    void* o_t, void* o_ps, void* o_tr, int lanes) {
#define CALL(T, KK) \
  { groups<T, KK>(TAIL_IO(T), (const T*)blob, lanes); }
  TAIL_DISPATCH(CALL)
#undef CALL
  return 0;
}

extern "C" int spectral_tail_naive(
    int K, int is_double, int mx, int nx, const void* A, const void* vor,
    const void* div, const void* tem, const void* ps, const void* tr,
    const void* phis, const void* tcorh, const void* qcorh, const void* blob,
    int j1, int j4, int implicit, int trunc, double dt, double ew1,
    double ew2, double sdrag, double rgas, void* o_vor, void* o_div,
    void* o_t, void* o_ps, void* o_tr, const void* xj_g, int reverse) {
#define CALL(T, KK) \
  { naive<T, KK>(TAIL_IO(T), (const T*)blob, (const T*)xj_g, reverse); }
  TAIL_DISPATCH(CALL)
#undef CALL
  return 0;
}

// The inverse each lane reads at every (m, n): out (mx, nx, K, K), row k
// of (m, n) as lane k of the group reads it.
extern "C" int tail_xj_lookup_host(int K, int is_double, const void* blob,
                                   int mx, int nx, void* out) {
#define CALL(T, KK)                                                   \
  {                                                                   \
    const TailTab<T, KK> tb((const T*)blob, mx, nx);                  \
    T* o = (T*)out;                                                   \
    for (int m = 0; m < mx; ++m)                                      \
      for (int n = 0; n < nx; ++n)                                    \
        for (int k = 0; k < KK; ++k) {                                \
          T r[KK];                                                    \
          tail_xj_row(tb, m, n, k, r);                                \
          for (int l = 0; l < KK; ++l)                                \
            o[(((size_t)m * nx + n) * KK + k) * KK + l] = r[l];       \
        }                                                             \
  }
  TAIL_DISPATCH(CALL)
#undef CALL
  return 0;
}

// The arithmetic of K24 (sppt.cuh), K25 (rdf.cuh) and K26 (cgrate.cuh)
// for the host: the very headers the kernels include, compiled with g++
// (-O2 -ffp-contract=off, so that every operation rounds apart as the
// _rn intrinsics do on the card) into a small shared library that the CPU
// tests (tests/test_torch_optional_physics.py, and for the mesh forms of
// K25 and K26 tests/test_torch_mesh_loop.py) load with ctypes and hold
// against the plain versions.  Each entry point runs the kernel's phases
// in the kernel's order, its blocks one after another and a block's
// threads as loops; a block's shared memory starts as NaN, so that a read
// of something never written shows.  K25's and K26's kernels run clusters
// of blocks that exchange sums through each other's shared memory: here
// a cluster's blocks each keep their own shared memory (NaN at the start,
// the exchanged arrays included), all of them run the phases before the
// cluster barrier, then all of them the phases after it.  The entry points
// of K25 and K26 take an `order`: 0 runs the blocks (and the clusters)
// first to last, 1 last to first, so that a block that read what another
// block writes, on the wrong side of a barrier, shows as a difference
// between the two orders.

#include <math.h>
#include <stdlib.h>

#include <vector>

#include "cgrate.cuh"
#include "rdf.cuh"
#include "sppt.cuh"

template <typename T>
static int ar1(int K, long long MN, const void* s, const void* eta,
               const void* sigma, double phi, double clip, void* out) {
  const long long n = 2LL * K * MN;
  for (long long e = 0; e < n; ++e)
    sppt_ar1_at((const T*)s, (const T*)eta, (const T*)sigma, (T)phi, (T)clip,
                (T*)out, e, MN);
  return 0;
}

extern "C" int sppt_ar1_host(int is_double, int K, long long MN,
                             const void* s, const void* eta,
                             const void* sigma, double phi, double clip,
                             void* out) {
  return is_double ? ar1<double>(K, MN, s, eta, sigma, phi, clip, out)
                   : ar1<float>(K, MN, s, eta, sigma, phi, clip, out);
}

template <typename T>
static int perturb(int K, long long G, const void* pattern, const void* mu,
                   void* const* tends) {
  T* t[4];
  for (int i = 0; i < 4; ++i) t[i] = (T*)tends[i];
  for (int k = 0; k < K; ++k)
    for (long long g = 0; g < G; ++g)
      sppt_perturb_at((const T*)pattern, (const T*)mu, t, k, G, g);
  return 0;
}

extern "C" int sppt_perturb_host(int is_double, int K, long long G,
                                 const void* pattern, const void* mu,
                                 void* const* tends) {
  return is_double ? perturb<double>(K, G, pattern, mu, tends)
                   : perturb<float>(K, G, pattern, mu, tends);
}

// The b-th block to run of n, in `order` (0 first to last, 1 last to
// first).
static int nth(int b, int n, int order) { return order ? n - 1 - b : b; }

// The kernels' staging: rows x cols contiguous into rows ds apart.
template <typename T>
static void stage_rows(T* dst, int ds, const T* src, int rows, int cols) {
  for (int i = 0; i < rows * cols; ++i)
    dst[(i / cols) * ds + i % cols] = src[i];
}

template <typename T>
static std::vector<T> nans(long long n) {
  return std::vector<T>((size_t)n, (T)NAN);
}

// ------------------------------------------------------------------ K25

template <typename T>
struct RdfH {
  T* tt;
  const T *h, *v_in, *ttm, *tt_rsw, *dfabs, *rps, *grdscp, *w, *sums;
  T* v_out;
  int K, nlat, nlon, p0, nb, rows;
};

// rdf.cu rdf_stage
template <typename T>
static void rdf_stage_h(const RdfH<T>& io, int k, int r0, int n, T* x0,
                        T* x1) {
  const int nlon = io.nlon, S = rdf_stride(nlon);
  const long long at = ((long long)k * io.rows + r0) * nlon;
  stage_rows(x0, S, io.ttm + at, n, nlon);
  const T gs = io.grdscp[k];
  for (int i = 0; i < n * nlon; ++i)
    x1[(i / nlon) * S + i % nlon] =
        rdf_heat(io.tt_rsw[at + i], io.dfabs[at + i],
                 io.rps[(long long)r0 * nlon + i], gs);
}

// rdf.cu rdf_smooth, rdf_write_v, rdf_add_rows
template <typename T>
static void rdf_smooth_h(T* v, T* s, int nlat) {
  for (int j = 0; j < 2 * nlat; ++j)
    s[j] = rdf_smooth_at(v + (j / nlat) * nlat, nlat, j % nlat);
  for (int j = 0; j < 2 * nlat; ++j)
    v[j] = rdf_smooth_at(s + (j / nlat) * nlat, nlat, j % nlat);
}

template <typename T>
static void rdf_write_v_h(const RdfH<T>& io, int k, const T* v) {
  for (int j = 0; j < 2 * io.nlat; ++j)
    io.v_out[((long long)(j / io.nlat) * io.nlat + j % io.nlat) * io.K + k] =
        v[j];
}

template <typename T>
static void rdf_add_rows_h(const RdfH<T>& io, int k, int r0, int n,
                           const T* v) {
  for (int p = 0; p < n * io.nlon; ++p) {
    const int r = r0 + p / io.nlon;
    rdf_add_at(io.h, v, v + io.nlat, io.tt, k, io.rows, io.nlon, r,
               p % io.nlon, rdf_band_lat(r, io.p0, io.nb, io.nlat));
  }
}

// rdf_cluster_kernel: a cluster a level, kRdfCluster blocks
template <typename T>
static void rdf_cluster_h(const RdfH<T>& io, int order) {
  const int nlat = io.nlat, S = rdf_stride(io.nlon);
  const int rc = rdf_chunk_rows(nlat);
  for (int kk = 0; kk < io.K; ++kk) {
    const int k = nth(kk, io.K, order);
    std::vector<std::vector<T>> sm(kRdfCluster);
    for (auto& b : sm) b = nans<T>(4LL * nlat + 2LL * rc * S);
    // v (2 nlat), s (2 nlat), x0 and x1 (rc x S) of block c
    auto v = [&](int c) { return sm[c].data(); };
    for (int b = 0; b < kRdfCluster; ++b) {   // before cluster.sync()
      const int c = nth(b, kRdfCluster, order);
      int r0, n;
      rdf_chunk(nlat, c, &r0, &n);
      T* x0 = v(c) + 4 * nlat;
      T* x1 = x0 + rc * S;
      rdf_stage_h(io, k, r0, n, x0, x1);
      for (int i = 0; i < 2 * n; ++i) {
        const int mode = i / n, r = i % n;
        const T val = rdf_row_sum((mode ? x1 : x0) + r * S, io.nlon,
                                  io.w[mode * io.K + k]);
        for (int dst = 0; dst < kRdfCluster; ++dst)
          v(dst)[mode * nlat + r0 + r] = val;
      }
    }
    for (int b = 0; b < kRdfCluster; ++b) {   // after it
      const int c = nth(b, kRdfCluster, order);
      int r0, n;
      rdf_chunk(nlat, c, &r0, &n);
      rdf_smooth_h(v(c), v(c) + 2 * nlat, nlat);
      if (c == 0) rdf_write_v_h(io, k, v(c));
      rdf_add_rows_h(io, k, r0, n, v(c));
    }
  }
}

// rdf_add_kernel: a block a (level, chunk)
template <typename T>
static void rdf_add_h(const RdfH<T>& io, int order) {
  const int nlat = io.nlat, ch = rdf_chunks(io.rows);
  for (int b = 0; b < io.K * ch; ++b) {
    const int blk = nth(b, io.K * ch, order), k = blk / ch, c = blk % ch;
    std::vector<T> sm = nans<T>(4LL * nlat);
    T* v = sm.data();
    int r0, n;
    rdf_chunk(io.rows, c, &r0, &n);
    if (io.sums) {
      for (int j = 0; j < 2 * nlat; ++j)
        v[j] = io.sums[((long long)(j / nlat) * io.K + k) * nlat + j % nlat];
      rdf_smooth_h(v, v + 2 * nlat, nlat);
      if (c == 0) rdf_write_v_h(io, k, v);
    } else {
      for (int i = 0; i < 2 * n; ++i) {
        const int mode = i / n;
        const int jv = rdf_band_lat(r0 + i % n, io.p0, io.nb, nlat);
        v[mode * nlat + jv] =
            io.v_in[((long long)mode * nlat + jv) * io.K + k];
      }
    }
    rdf_add_rows_h(io, k, r0, n, v);
  }
}

// rdf_sums_kernel: a block a (level, chunk), the sums into v_out
template <typename T>
static void rdf_sums_h(const RdfH<T>& io, int order) {
  const int S = rdf_stride(io.nlon), rc = rdf_chunk_rows(io.rows);
  const int ch = rdf_chunks(io.rows);
  for (int b = 0; b < io.K * ch; ++b) {
    const int blk = nth(b, io.K * ch, order), k = blk / ch, c = blk % ch;
    std::vector<T> sm = nans<T>(2LL * rc * S);
    T* x0 = sm.data();
    T* x1 = x0 + rc * S;
    int r0, n;
    rdf_chunk(io.rows, c, &r0, &n);
    rdf_stage_h(io, k, r0, n, x0, x1);
    for (int i = 0; i < 2 * n; ++i) {
      const int mode = i / n, r = i % n;
      io.v_out[((long long)mode * io.K + k) * io.rows + r0 + r] =
          rdf_row_sum((mode ? x1 : x0) + r * S, io.nlon,
                      io.w[mode * io.K + k]);
    }
  }
}

template <typename T>
static RdfH<T> rdf_io(int K, int nlat, int nlon, int p0, int nb, int rows,
                      void* tt, const void* h, const void* v_in,
                      const void* ttm, const void* tt_rsw, const void* dfabs,
                      const void* rps, const void* grdscp, const void* w,
                      const void* sums, void* v_out) {
  RdfH<T> io;
  io.tt = (T*)tt;
  io.h = (const T*)h;
  io.v_in = (const T*)v_in;
  io.ttm = (const T*)ttm;
  io.tt_rsw = (const T*)tt_rsw;
  io.dfabs = (const T*)dfabs;
  io.rps = (const T*)rps;
  io.grdscp = (const T*)grdscp;
  io.w = (const T*)w;
  io.sums = (const T*)sums;
  io.v_out = (T*)v_out;
  io.K = K;
  io.nlat = nlat;
  io.nlon = nlon;
  io.p0 = p0;
  io.nb = nb;
  io.rows = rows;
  return io;
}

// rdf_launch's form: the shortwave form (xs) or the other.
template <typename T>
static int rdf_h(int K, int nlat, int nlon, int xs, void* tt, const void* h,
                 const void* v_in, const void* ttm, const void* tt_rsw,
                 const void* dfabs, const void* rps, const void* grdscp,
                 const void* w, void* v_out, int order) {
  const RdfH<T> io = rdf_io<T>(K, nlat, nlon, 0, nlat / 2, 2 * (nlat / 2),
                               tt, h, v_in, ttm, tt_rsw, dfabs, rps, grdscp,
                               w, nullptr, v_out);
  if (xs)
    rdf_cluster_h(io, order);
  else
    rdf_add_h(io, order);
  return 0;
}

extern "C" int rdf_host(int is_double, int K, int nlat, int nlon, int xs,
                        void* tt, const void* h, const void* v_in,
                        const void* ttm, const void* tt_rsw,
                        const void* dfabs, const void* rps,
                        const void* grdscp, const void* w, void* v_out,
                        int order) {
  return is_double ? rdf_h<double>(K, nlat, nlon, xs, tt, h, v_in, ttm,
                                   tt_rsw, dfabs, rps, grdscp, w, v_out,
                                   order)
                   : rdf_h<float>(K, nlat, nlon, xs, tt, h, v_in, ttm,
                                  tt_rsw, dfabs, rps, grdscp, w, v_out,
                                  order);
}

// rdf_band_launch's form: the band of pairs p0 .. p0 + nb - 1 from the
// gathered sums (2, K, nlat) (xs) or the carried randfv.
template <typename T>
static int rdf_band_h(int K, int nlat, int nlon, int p0, int nb, int xs,
                      void* tt, const void* h, const void* v_in,
                      const void* sums, void* v_out, int order) {
  rdf_add_h(rdf_io<T>(K, nlat, nlon, p0, nb, 2 * nb, tt, h, v_in, nullptr,
                      nullptr, nullptr, nullptr, nullptr, nullptr,
                      xs ? sums : nullptr, xs ? v_out : nullptr),
            order);
  return 0;
}

extern "C" int rdf_band_host(int is_double, int K, int nlat, int nlon,
                             int p0, int nb, int xs, void* tt, const void* h,
                             const void* v_in, const void* sums,
                             void* v_out, int order) {
  return is_double ? rdf_band_h<double>(K, nlat, nlon, p0, nb, xs, tt, h,
                                        v_in, sums, v_out, order)
                   : rdf_band_h<float>(K, nlat, nlon, p0, nb, xs, tt, h,
                                       v_in, sums, v_out, order);
}

// rdf_sums_launch's form: a band's weighted zonal sums (2, K, rows).
template <typename T>
static int rdf_sums_hh(int K, int rows, int nlon, const void* ttm,
                       const void* tt_rsw, const void* dfabs, const void* rps,
                       const void* grdscp, const void* w, void* out,
                       int order) {
  rdf_sums_h(rdf_io<T>(K, rows, nlon, 0, 0, rows, nullptr, nullptr, nullptr,
                       ttm, tt_rsw, dfabs, rps, grdscp, w, nullptr, out),
             order);
  return 0;
}

extern "C" int rdf_sums_host(int is_double, int K, int rows, int nlon,
                             const void* ttm, const void* tt_rsw,
                             const void* dfabs, const void* rps,
                             const void* grdscp, const void* w, void* out,
                             int order) {
  return is_double ? rdf_sums_hh<double>(K, rows, nlon, ttm, tt_rsw, dfabs,
                                         rps, grdscp, w, out, order)
                   : rdf_sums_hh<float>(K, rows, nlon, ttm, tt_rsw, dfabs,
                                        rps, grdscp, w, out, order);
}

// ------------------------------------------------------------------ K26

// cgrate_kernel (the whole form, 0): a cluster a field, kCgCluster
// blocks; cgrate_rows_kernel (form 1) and cgrate_range_kernel (form 2): a
// block a (field, level).
template <typename T>
static int cg_h(int form, int K, int mx, int mr, int nx, int m0,
                const void* const* f_, const void* const* fj_,
                const void* elm2_, const void* trfilt_, void* const* o_,
                void* rows_, int trunc, double dt_, double ew1_,
                double ew2_, double grmax_, int order) {
  const T* elm2 = (const T*)elm2_;
  const T* trfilt = (const T*)trfilt_;
  T* rows = (T*)rows_;
  const T dt = (T)dt_, ew1 = (T)ew1_, ew2 = (T)ew2_, grmax = (T)grmax_;
  const int FS = cg_fstride(nx), ES = cg_estride(nx);
  const long long lvl = 2LL * mr * nx;
  if (form == 1) {
    for (int b = 0; b < 2 * K; ++b) {
      const int blk = nth(b, 2 * K, order), fld = blk / K, k = blk % K;
      std::vector<T> raw = nans<T>(cg_smem_count(1, mr, nx, true));
      const CgSmem<T> sm = cg_smem(raw.data(), 1, mr, nx, true);
      stage_rows(sm.f, FS, (const T*)f_[fld] + k * lvl, mr, 2 * nx);
      stage_rows(sm.d, FS, (const T*)o_[fld] + k * lvl, mr, 2 * nx);
      stage_rows(sm.e, ES, elm2, mr, nx);
      T* rg = rows + ((long long)2 * fld * K + k) * mr;
      for (int m = 0; m < mr; ++m)
        cgrate_row(sm.f + m * FS, sm.d + m * FS, sm.e + m * ES, nx,
                   cgrate_mask<T>(m0 + m), rg + m,
                   rg + (long long)K * mr + m);
    }
    return 0;
  }
  if (form == 2) {
    for (int b = 0; b < 2 * K; ++b) {
      const int blk = nth(b, 2 * K, order), fld = blk / K, k = blk % K;
      std::vector<T> cand = nans<T>(K);
      const T* g = rows + (long long)2 * fld * K * mx;
      for (int i = 0; i < K; ++i)
        cand[i] = cgrate_level(g + (long long)i * mx,
                               g + (long long)(K + i) * mx, mx, i, grmax);
      const T cd = cgrate_cd(cand.data(), K);
      const T* f = (const T*)f_[fld] + k * lvl;
      const T* fj = (const T*)fj_[fld] + k * lvl;
      T* o1 = (T*)o_[fld] + k * lvl;
      T* o2 = o1 + K * lvl;
      for (int e = 0; e < (int)lvl; ++e) {
        const int mn = e >> 1, m = mn / nx;
        cgrate_step(f[e], fj[e], o1[e], trfilt[mn], cgrate_mask<T>(m0 + m),
                    cd, trunc, dt, ew1, ew2, &o1[e], &o2[e]);
      }
    }
    return 0;
  }
  for (int ff = 0; ff < 2; ++ff) {
    const int fld = nth(ff, 2, order);
    const T* f = (const T*)f_[fld];
    const T* fj = (const T*)fj_[fld];
    T* o1 = (T*)o_[fld];
    T* o2 = o1 + K * lvl;
    std::vector<std::vector<T>> raw(kCgCluster);
    std::vector<CgSmem<T>> sm(kCgCluster);
    for (int r = 0; r < kCgCluster; ++r) {
      raw[r] = nans<T>(cg_smem_count(K, mx, nx, true));
      sm[r] = cg_smem(raw[r].data(), K, mx, nx, true);
    }
    for (int b = 0; b < kCgCluster; ++b) {   // before cluster.sync()
      const int r = nth(b, kCgCluster, order), nl = cg_nlev(K, r);
      const CgSmem<T>& s = sm[r];
      for (int l = 0; l < nl; ++l) {
        const long long k = r + l * kCgCluster;
        stage_rows(s.f + l * mx * FS, FS, f + k * lvl, mx, 2 * nx);
        stage_rows(s.d + l * mx * FS, FS, o1 + k * lvl, mx, 2 * nx);
      }
      if (nl) stage_rows(s.e, ES, elm2, mx, nx);
      for (int i = 0; i < nl * mx; ++i)
        cgrate_row(s.f + i * FS, s.d + i * FS, s.e + (i % mx) * ES, nx,
                   cgrate_mask<T>(i % mx), s.rg + i, s.rr + i);
      for (int i = 0; i < nl * kCgCluster; ++i) {
        const int l = i / kCgCluster, dst = i % kCgCluster;
        const int k = r + l * kCgCluster;
        sm[dst].cand[k] =
            cgrate_level(s.rg + l * mx, s.rr + l * mx, mx, k, grmax);
      }
    }
    for (int b = 0; b < kCgCluster; ++b) {   // after it
      const int r = nth(b, kCgCluster, order), nl = cg_nlev(K, r);
      const CgSmem<T>& s = sm[r];
      const T cd = cgrate_cd(s.cand, K);
      for (int l = 0; l < nl; ++l) {
        const long long at = (r + (long long)l * kCgCluster) * lvl;
        for (int e = 0; e < (int)lvl; ++e) {
          const int mn = e >> 1, m = mn / nx;
          const int x = (l * mx + m) * FS + (e - 2 * m * nx);
          cgrate_step(s.f[x], fj[at + e], s.d[x], trfilt[mn],
                      cgrate_mask<T>(m), cd, trunc, dt, ew1, ew2,
                      &o1[at + e], &o2[at + e]);
        }
      }
    }
  }
  return 0;
}

extern "C" int cgrate_host(int is_double, int K, int mx, int nx,
                           const void* const* f, const void* const* fj,
                           const void* elm2, const void* trfilt,
                           void* const* o, int trunc, double dt, double ew1,
                           double ew2, double grmax, int order) {
  return is_double ? cg_h<double>(0, K, mx, mx, nx, 0, f, fj, elm2, trfilt,
                                  o, nullptr, trunc, dt, ew1, ew2, grmax,
                                  order)
                   : cg_h<float>(0, K, mx, mx, nx, 0, f, fj, elm2, trfilt, o,
                                 nullptr, trunc, dt, ew1, ew2, grmax, order);
}

// cgrate_rows_launch's form: the rows (2, 2, K, mr) of the m range m0 ..
extern "C" int cgrate_rows_host(int is_double, int K, int mr, int nx, int m0,
                                const void* const* f, void* const* o,
                                const void* elm2, void* rows, int order) {
  return is_double ? cg_h<double>(1, K, mr, mr, nx, m0, f, nullptr, elm2,
                                  nullptr, o, rows, 0, 0, 0, 0, 0, order)
                   : cg_h<float>(1, K, mr, mr, nx, m0, f, nullptr, elm2,
                                 nullptr, o, rows, 0, 0, 0, 0, 0, order);
}

// cgrate_range_launch's form: the range m0 .. m0 + mr - 1 stepped from the
// gathered rows (2, 2, K, mx).
extern "C" int cgrate_range_host(int is_double, int K, int mx, int mr,
                                 int nx, int m0, const void* const* f,
                                 const void* const* fj, const void* rows,
                                 const void* trfilt, void* const* o,
                                 int trunc, double dt, double ew1,
                                 double ew2, double grmax, int order) {
  return is_double
             ? cg_h<double>(2, K, mx, mr, nx, m0, f, fj, nullptr, trfilt, o,
                            (void*)rows, trunc, dt, ew1, ew2, grmax, order)
             : cg_h<float>(2, K, mx, mr, nx, m0, f, fj, nullptr, trfilt, o,
                           (void*)rows, trunc, dt, ew1, ew2, grmax, order);
}

// The arithmetic of K24 (sppt.cuh), K25 (rdf.cuh) and K26 (cgrate.cuh)
// for the host: the very headers the kernels include, compiled with g++
// (-O2 -ffp-contract=off, so that every operation rounds apart as the
// _rn intrinsics do on the card) into a small shared library that the CPU
// tests (tests/test_torch_optional_physics.py, and for the mesh forms of
// K25 and K26 tests/test_torch_mesh_loop.py) load with ctypes and hold
// against the plain versions.  Each entry point runs the kernel's phases
// in the kernel's order, its blocks one after another and a block's
// threads as loops; a block's shared memory starts as NaN, so that a read
// of something never written shows.

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

template <typename T>
static int rdf_h(int K, int nlat, int nlon, int xs, void* tt_, const void* h,
                 const void* v_in_, const void* ttm, const void* tt_rsw,
                 const void* dfabs, const void* rps, const void* grdscp,
                 const void* w, const void* sums_, void* v_out_, int p0,
                 int nb) {
  T* tt = (T*)tt_;
  const T* v_in = (const T*)v_in_;
  const T* sums = (const T*)sums_;
  T* v_out = (T*)v_out_;
  const int rows = 2 * nb;
  for (int k = 0; k < K; ++k) {
    std::vector<T> v(4 * (size_t)nlat, (T)NAN);
    T* v0 = v.data();
    T* v1 = v0 + nlat;
    T* s = v0 + 2 * nlat;
    if (xs) {
      if (sums) {
        for (int j = 0; j < 2 * nlat; ++j)
          v0[j] = sums[((long long)(j / nlat) * K + k) * nlat + j % nlat];
      } else {
        for (int j = 0; j < nlat; ++j)
          rdf_zonal((const T*)ttm, (const T*)tt_rsw, (const T*)dfabs,
                    (const T*)rps, (const T*)grdscp, (const T*)w, K, k, nlat,
                    nlon, j, v0, v1);
      }
      for (int pass = 0; pass < 2; ++pass) {
        for (int j = 0; j < 2 * nlat; ++j)
          s[j] = rdf_smooth_at(v0 + (j / nlat) * nlat, nlat, j % nlat);
        for (int j = 0; j < 2 * nlat; ++j) v0[j] = s[j];
      }
      for (int j = 0; j < 2 * nlat; ++j)
        v_out[((long long)(j / nlat) * nlat + j % nlat) * K + k] = v0[j];
    } else {
      for (int j = 0; j < 2 * nlat; ++j)
        v0[j] = v_in[((long long)(j / nlat) * nlat + j % nlat) * K + k];
    }
    for (int p = 0; p < rows * nlon; ++p)
      rdf_add_at((const T*)h, v0, v1, tt, k, rows, nlon, p / nlon, p % nlon,
                 rdf_band_lat(p / nlon, p0, nb, nlat));
  }
  return 0;
}

extern "C" int rdf_host(int is_double, int K, int nlat, int nlon, int xs,
                        void* tt, const void* h, const void* v_in,
                        const void* ttm, const void* tt_rsw,
                        const void* dfabs, const void* rps,
                        const void* grdscp, const void* w, void* v_out) {
  return is_double ? rdf_h<double>(K, nlat, nlon, xs, tt, h, v_in, ttm,
                                   tt_rsw, dfabs, rps, grdscp, w, nullptr,
                                   v_out, 0, nlat / 2)
                   : rdf_h<float>(K, nlat, nlon, xs, tt, h, v_in, ttm,
                                  tt_rsw, dfabs, rps, grdscp, w, nullptr,
                                  v_out, 0, nlat / 2);
}

// rdf_band_launch's form: the band of pairs p0 .. p0 + nb - 1 from the
// gathered sums (2, K, nlat).
extern "C" int rdf_band_host(int is_double, int K, int nlat, int nlon,
                             int p0, int nb, int xs, void* tt, const void* h,
                             const void* v_in, const void* sums,
                             void* v_out) {
  return is_double ? rdf_h<double>(K, nlat, nlon, xs, tt, h, v_in, nullptr,
                                   nullptr, nullptr, nullptr, nullptr,
                                   nullptr, sums, v_out, p0, nb)
                   : rdf_h<float>(K, nlat, nlon, xs, tt, h, v_in, nullptr,
                                  nullptr, nullptr, nullptr, nullptr,
                                  nullptr, sums, v_out, p0, nb);
}

template <typename T>
static int rdf_sums_h(int K, int rows, int nlon, const void* ttm,
                      const void* tt_rsw, const void* dfabs, const void* rps,
                      const void* grdscp, const void* w, void* out_) {
  T* out = (T*)out_;
  for (int k = 0; k < K; ++k)
    for (int j = 0; j < rows; ++j)
      rdf_zonal((const T*)ttm, (const T*)tt_rsw, (const T*)dfabs,
                (const T*)rps, (const T*)grdscp, (const T*)w, K, k, rows,
                nlon, j, out + (long long)k * rows,
                out + ((long long)K + k) * rows);
  return 0;
}

// rdf_sums_launch's form: a band's weighted zonal sums (2, K, rows).
extern "C" int rdf_sums_host(int is_double, int K, int rows, int nlon,
                             const void* ttm, const void* tt_rsw,
                             const void* dfabs, const void* rps,
                             const void* grdscp, const void* w, void* out) {
  return is_double ? rdf_sums_h<double>(K, rows, nlon, ttm, tt_rsw, dfabs,
                                        rps, grdscp, w, out)
                   : rdf_sums_h<float>(K, rows, nlon, ttm, tt_rsw, dfabs,
                                       rps, grdscp, w, out);
}

// K26's forms (0 whole, 1 rows, 2 range: cgrate.cu), the blocks (a field
// each) one after the other and a block's threads as loops.
template <typename T>
static int cg_h(int form, int K, int mx, int mr, int nx, int m0,
                const void* const* f, const void* const* fj, const void* elm2,
                const void* trfilt, void* const* o, void* rows_, int trunc,
                double dt, double ew1, double ew2, double grmax) {
  T* rows = (T*)rows_;
  for (int fld = 0; fld < 2; ++fld) {
    const T* ff = (const T*)f[fld];
    T* o1 = (T*)o[fld];
    const T* fdt = o1;
    if (form == 1) {
      T* rg = rows + (long long)(2 * fld) * K * mr;
      for (int r = 0; r < K * mr; ++r)
        cgrate_row(ff, fdt, (const T*)elm2, mr, nx, m0, r / mr, r % mr,
                   rg + r, rg + (long long)K * mr + r);
      continue;
    }
    std::vector<T> rg(2 * (size_t)K * mx + K, (T)NAN);
    T* rr = rg.data() + K * mx;
    T* cand = rr + K * mx;
    if (form == 0) {
      for (int r = 0; r < K * mx; ++r)
        cgrate_row(ff, fdt, (const T*)elm2, mx, nx, 0, r / mx, r % mx,
                   rg.data() + r, rr + r);
    } else {
      const T* g = rows + (long long)(2 * fld) * K * mx;
      for (int r = 0; r < K * mx; ++r) {
        rg[r] = g[r];
        rr[r] = g[(long long)K * mx + r];
      }
    }
    for (int k = 0; k < K; ++k)
      cand[k] = cgrate_level(rg.data() + k * mx, rr + k * mx, mx, k,
                             (T)grmax);
    const T cd = cgrate_cd(cand, K);
    const long long n = 2LL * K * mr * nx;
    for (long long e = 0; e < n; ++e)
      cgrate_step_at(ff, (const T*)fj[fld], fdt, (const T*)trfilt, mr, nx,
                     m0, cd, trunc, (T)dt, (T)ew1, (T)ew2, o1, o1 + n, e);
  }
  return 0;
}

extern "C" int cgrate_host(int is_double, int K, int mx, int nx,
                           const void* const* f, const void* const* fj,
                           const void* elm2, const void* trfilt,
                           void* const* o, int trunc, double dt, double ew1,
                           double ew2, double grmax) {
  return is_double ? cg_h<double>(0, K, mx, mx, nx, 0, f, fj, elm2, trfilt,
                                  o, nullptr, trunc, dt, ew1, ew2, grmax)
                   : cg_h<float>(0, K, mx, mx, nx, 0, f, fj, elm2, trfilt, o,
                                 nullptr, trunc, dt, ew1, ew2, grmax);
}

// cgrate_rows_launch's form: the rows (2, 2, K, mr) of the m range m0 ..
extern "C" int cgrate_rows_host(int is_double, int K, int mr, int nx, int m0,
                                const void* const* f, void* const* o,
                                const void* elm2, void* rows) {
  return is_double ? cg_h<double>(1, K, mr, mr, nx, m0, f, nullptr, elm2,
                                  nullptr, o, rows, 0, 0, 0, 0, 0)
                   : cg_h<float>(1, K, mr, mr, nx, m0, f, nullptr, elm2,
                                 nullptr, o, rows, 0, 0, 0, 0, 0);
}

// cgrate_range_launch's form: the range m0 .. m0 + mr - 1 stepped from the
// gathered rows (2, 2, K, mx).
extern "C" int cgrate_range_host(int is_double, int K, int mx, int mr,
                                 int nx, int m0, const void* const* f,
                                 const void* const* fj, const void* rows,
                                 const void* trfilt, void* const* o,
                                 int trunc, double dt, double ew1,
                                 double ew2, double grmax) {
  return is_double
             ? cg_h<double>(2, K, mx, mr, nx, m0, f, fj, nullptr, trfilt, o,
                            (void*)rows, trunc, dt, ew1, ew2, grmax)
             : cg_h<float>(2, K, mx, mr, nx, m0, f, fj, nullptr, trfilt, o,
                           (void*)rows, trunc, dt, ew1, ew2, grmax);
}

// The arithmetic of K24 (sppt.cuh), K25 (rdf.cuh) and K26 (cgrate.cuh)
// for the host: the very headers the kernels include, compiled with g++
// (-O2 -ffp-contract=off, so that every operation rounds apart as the
// _rn intrinsics do on the card) into a small shared library that the CPU
// tests (tests/test_torch_optional_physics.py) load with ctypes and hold
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
                 const void* w, void* v_out_) {
  T* tt = (T*)tt_;
  const T* v_in = (const T*)v_in_;
  T* v_out = (T*)v_out_;
  for (int k = 0; k < K; ++k) {
    std::vector<T> v(4 * (size_t)nlat, (T)NAN);
    T* v0 = v.data();
    T* v1 = v0 + nlat;
    T* s = v0 + 2 * nlat;
    if (xs) {
      for (int j = 0; j < nlat; ++j)
        rdf_zonal((const T*)ttm, (const T*)tt_rsw, (const T*)dfabs,
                  (const T*)rps, (const T*)grdscp, (const T*)w, K, k, nlat,
                  nlon, j, v0, v1);
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
    for (int p = 0; p < nlat * nlon; ++p)
      rdf_add_at((const T*)h, v0, v1, tt, k, nlat, nlon, p / nlon, p % nlon);
  }
  return 0;
}

extern "C" int rdf_host(int is_double, int K, int nlat, int nlon, int xs,
                        void* tt, const void* h, const void* v_in,
                        const void* ttm, const void* tt_rsw,
                        const void* dfabs, const void* rps,
                        const void* grdscp, const void* w, void* v_out) {
  return is_double ? rdf_h<double>(K, nlat, nlon, xs, tt, h, v_in, ttm,
                                   tt_rsw, dfabs, rps, grdscp, w, v_out)
                   : rdf_h<float>(K, nlat, nlon, xs, tt, h, v_in, ttm,
                                  tt_rsw, dfabs, rps, grdscp, w, v_out);
}

template <typename T>
static int cg_h(int K, int mx, int nx, const void* const* f,
                const void* const* fj, const void* elm2, const void* trfilt,
                void* const* o, int trunc, double dt, double ew1, double ew2,
                double grmax) {
  for (int fld = 0; fld < 2; ++fld) {
    std::vector<T> rg(2 * (size_t)K * mx + K, (T)NAN);
    T* rr = rg.data() + K * mx;
    T* cand = rr + K * mx;
    const T* ff = (const T*)f[fld];
    T* o1 = (T*)o[fld];
    const T* fdt = o1;
    for (int r = 0; r < K * mx; ++r)
      cgrate_row(ff, fdt, (const T*)elm2, mx, nx, r / mx, r % mx,
                 rg.data() + r, rr + r);
    for (int k = 0; k < K; ++k)
      cand[k] = cgrate_level(rg.data() + k * mx, rr + k * mx, mx, k,
                             (T)grmax);
    const T cd = cgrate_cd(cand, K);
    const long long n = 2LL * K * mx * nx;
    for (long long e = 0; e < n; ++e)
      cgrate_step_at(ff, (const T*)fj[fld], fdt, (const T*)trfilt, mx, nx, cd,
                     trunc, (T)dt, (T)ew1, (T)ew2, o1, o1 + n, e);
  }
  return 0;
}

extern "C" int cgrate_host(int is_double, int K, int mx, int nx,
                           const void* const* f, const void* const* fj,
                           const void* elm2, const void* trfilt,
                           void* const* o, int trunc, double dt, double ew1,
                           double ew2, double grmax) {
  return is_double ? cg_h<double>(K, mx, nx, f, fj, elm2, trfilt, o, trunc,
                                  dt, ew1, ew2, grmax)
                   : cg_h<float>(K, mx, nx, f, fj, elm2, trfilt, o, trunc,
                                 dt, ew1, ew2, grmax);
}

// The arithmetic of K6 (sht_synthesis.cu) and K5 (sht_analysis.cu), shared
// with their host build (sht_host.cpp, which the CPU tests compile with g++
// and hold against a naive loop and the plain PyTorch versions): the tile
// each launch picks, the block's shared-memory layout, and what one thread
// of a block does in each phase.  The kernels call these functions with
// (threadIdx.x, blockDim.x); the host build runs every thread of every
// block as loops, so an index error in a tile shows without a card.
//
// Every output is summed in the order of the kernels' first design (one
// block per field and latitude pair or wavenumber group, one thread per
// output), so the results are bit-identical to it:
//   K6  the even and odd Legendre sums in ascending n (fmaf), folded as
//       even - odd (south) and even + odd (north); then the inverse DFT
//       in ascending m, two fmaf per term (re * w.x, then -im * w.y);
//       fields from ncos on times cosgr[lat] (one rounded product);
//   K5  fields from n0 on times pre[lat] (rounded), the zonal DFT in
//       ascending longitude (fmaf), the fold (north +- south) * wt[j]
//       (each operation rounded), then the Legendre sum in ascending j.
// Tiling and vector loads change no output's order.  Plain f32 FFMA only:
// no TF32 (reduced-precision transforms blow the T30 run up after ~20
// days) and no tensor cores, wgmma or TMA: a call is 15-45 MFLOP and 1-2
// MB, far below what those units are for.
//
// What limits these kernels is latency and instruction count, not bytes
// or FLOPs, so the layout serves 16-byte accesses: the block stages its
// operands by 16-byte cp.async (8 bytes for dft_fwd's columns, whose rows
// of mx = 31 are not 16-byte aligned), rows padded to a stride of an odd
// number of 16-byte words (sht_pad4), so that 8 threads reading 128 bits
// from 8 rows hit 8 different bank groups; the inner loops load 4 values
// per instruction.  They need nx and nlon multiples of 4 and 16-byte
// aligned operands (K6's output: 8-byte; the launches return
// cudaErrorInvalidValue otherwise).

#pragma once

#include <math.h>
#include <stddef.h>
#include <string.h>

#ifdef __CUDACC__
#define SHT_HD __host__ __device__ __forceinline__
#define SHT_UNROLL(n) _Pragma(#n)
typedef float2 sht_c;
typedef float4 sht_v4;
#else
#define SHT_HD inline
#define SHT_UNROLL(n)
struct sht_c {
  float x, y;
};
struct sht_v4 {
  float x, y, z, w;
};
#endif

#define SHT_MAX_THREADS 1024

SHT_HD float sht_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
SHT_HD float sht_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
SHT_HD float sht_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
// 16 bytes at p (16-byte aligned) in one access
SHT_HD sht_v4 sht_ld4(const float* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const float4*>(p);
#else
  sht_v4 v;
  memcpy(&v, p, sizeof v);
  return v;
#endif
}
SHT_HD void sht_st4(float* p, sht_v4 v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<float4*>(p) = v;
#else
  memcpy(p, &v, sizeof v);
#endif
}

static inline int sht_cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// A row stride (in floats) of at least n: a whole number of 16-byte words,
// and an odd one.
SHT_HD int sht_pad4(int n) {
  const int w = (n + 3) / 4;
  return 4 * (w % 2 ? w : w + 1);
}

// Threads of a block: enough for the larger phase, whole warps, at least
// 128 (more threads issue the staging copies sooner).
static inline int sht_threads(int work) {
  int t = (work + 31) / 32 * 32;
  return t < 128 ? 128 : (t > SHT_MAX_THREADS ? SHT_MAX_THREADS : t);
}

// True where the kernels' layout holds for an operand: `bytes`-aligned.
SHT_HD bool sht_aligned(const void* p, unsigned bytes) {
  return ((size_t)p & (bytes - 1)) == 0;
}

// Copies a block of rows x width elements: (r, c) from src[r * sstride +
// c] to dst[r * dstride + c], thread t of T taking the elements t, t + T,
// ... in row-major order, with no division in the loop.  cp(d, s) copies
// one element (a float, a complex or a 16-byte word) global -> shared.
template <class Copy, class E>
SHT_HD void sht_stage_rows(const Copy& cp, E* dst, int dstride, const E* src,
                           size_t sstride, int rows, int width, int t, int T) {
  const int dr = T / width, dc = T - dr * width;
  int r = t / width, c = t - r * width;
  while (r < rows) {
    cp(dst + (size_t)r * dstride + c, src + r * sstride + c);
    c += dc;
    r += dr;
    if (c >= width) {
      c -= width;
      ++r;
    }
  }
}

// ------------------------------------------------------------------ K6

struct ShtSynArgs {
  const sht_c* spec;      // (B, mx, nx)
  const sht_c* dft_inv;   // (mx, nlon)
  const float* cpol_g;    // (nlat/2, mx, nx)
  const float* cosgr;     // (nlat,)
  int ncos, B, nlat, nlon, mx, nx;
  float* out;             // (B, nlat, nlon)
};

// A block owns ft fields x lp latitude pairs; grid = field tiles x pair
// tiles, field tile fastest.
struct ShtSynTile {
  int ft, lp, threads, blocks;
};

// Shared memory of a block (strides in floats):
//   v   (ft * mx rows of nx complex, stride vs = sht_pad4(2 nx)) the
//       fields' coefficients;
//   w   (mx, nlon) complex, dft_inv;
//   fm  (ft * lp * 2 rows of mx complex, stride fs = 2 mx rounded up to
//       a multiple of 4) the Fourier rows, south then north, of each
//       (field, pair);
//   cp  (lp * mx rows of nx, stride cs = sht_pad4(nx)) the Legendre rows.
struct ShtSynSmem {
  float *v, *w, *fm, *cp;
  int vs, fs, cs;
};

SHT_HD ShtSynSmem sht_syn_carve(void* base, int ft, int lp, int mx, int nx,
                                int nlon) {
  ShtSynSmem s;
  s.vs = sht_pad4(2 * nx);
  s.fs = 2 * (mx + (mx & 1));
  s.cs = sht_pad4(nx);
  s.v = (float*)base;
  s.w = s.v + (size_t)ft * mx * s.vs;
  s.fm = s.w + (size_t)2 * mx * nlon;
  s.cp = s.fm + (size_t)ft * lp * 2 * s.fs;
  return s;
}

SHT_HD size_t sht_syn_smem_bytes(int ft, int lp, int mx, int nx, int nlon) {
  const ShtSynSmem s = sht_syn_carve(0, ft, lp, mx, nx, nlon);
  return (size_t)(s.cp + (size_t)lp * mx * s.cs - s.v) * sizeof(float);
}

// The tile of one launch: 2 fields a block (1 for a single field) and the
// fewest latitude pairs that keep the grid within one block per SM.  On
// an H100 this was the fastest of all tiles up to 8 x 8 at each stack
// size of the coupled cycle (50, 41, 32 and 33 fields).
static inline ShtSynTile sht_syn_choose(int B, int nlat, int nlon, int mx,
                                        int nx, int sms, size_t smem_max) {
  const int iy = nlat / 2;
  ShtSynTile tl;
  tl.ft = B < 2 ? B : 2;
  tl.lp = 1;
  while (tl.lp < iy &&
         (long long)sht_cdiv(B, tl.ft) * sht_cdiv(iy, tl.lp) > sms &&
         sht_syn_smem_bytes(tl.ft, tl.lp + 1, mx, nx, nlon) <= smem_max)
    ++tl.lp;
  const int items = tl.ft * tl.lp * mx, tiles = tl.ft * tl.lp * nlon / 2;
  tl.threads = sht_threads(items > tiles ? items : tiles);
  tl.blocks = sht_cdiv(B, tl.ft) * sht_cdiv(iy, tl.lp);
  return tl;
}

struct ShtSynBlock {
  int f0, nf, j0, np;   // first field, fields; first pair, pairs
};

SHT_HD ShtSynBlock sht_syn_block(const ShtSynArgs& a, int ft, int lp,
                                 int blk) {
  const int nft = (a.B + ft - 1) / ft;
  ShtSynBlock b;
  b.f0 = (blk % nft) * ft;
  b.j0 = (blk / nft) * lp;
  b.nf = a.B - b.f0 < ft ? a.B - b.f0 : ft;
  b.np = a.nlat / 2 - b.j0 < lp ? a.nlat / 2 - b.j0 : lp;
  return b;
}

// Phase 0: the block's Legendre rows, in 16-byte words, one (pair, m)
// row at a time.
template <class Copy>
SHT_HD void sht_syn_stage_legendre(const Copy& cp, const ShtSynArgs& a,
                                   const ShtSynSmem& s, const ShtSynBlock& b,
                                   int t, int T) {
  const size_t mn = (size_t)a.mx * a.nx;
  sht_stage_rows(cp, (sht_v4*)s.cp, s.cs / 4,
                 (const sht_v4*)(a.cpol_g + b.j0 * mn), a.nx / 4,
                 b.np * a.mx, a.nx / 4, t, T);
}

// Phase 0, staged as one group: the block's coefficients and Legendre
// rows, in 16-byte words, one (field or pair, m) row at a time.
template <class Copy>
SHT_HD void sht_syn_stage_coef(const Copy& cp, const ShtSynArgs& a,
                               const ShtSynSmem& s, const ShtSynBlock& b,
                               int t, int T) {
  const size_t mn = (size_t)a.mx * a.nx;
  sht_stage_rows(cp, (sht_v4*)s.v, s.vs / 4,
                 (const sht_v4*)(a.spec + b.f0 * mn), a.nx / 2, b.nf * a.mx,
                 a.nx / 2, t, T);
  sht_syn_stage_legendre(cp, a, s, b, t, T);
}

// Phase 0, staged as a second group that lands during phase 1: dft_inv.
template <class Copy>
SHT_HD void sht_syn_stage_dft(const Copy& cp, const ShtSynArgs& a,
                              const ShtSynSmem& s, int t, int T) {
  const int words = a.mx * a.nlon / 2;
  sht_stage_rows(cp, (sht_v4*)s.w, words, (const sht_v4*)a.dft_inv, words, 1,
                 words, t, T);
}

// Phase 1: thread t's Legendre items (field, pair, m), m fastest; 4
// values of n per load.
SHT_HD void sht_syn_legendre(const ShtSynArgs& a, const ShtSynSmem& s,
                             const ShtSynBlock& b, int ft, int lp, int t,
                             int T) {
  const int mx = a.mx, nx = a.nx;
  for (int i = t; i < ft * lp * mx; i += T) {
    const int m = i % mx, r = i / mx, fl = r % ft, pl = r / ft;
    if (fl >= b.nf || pl >= b.np) continue;
    const float* c = s.cp + (size_t)(pl * mx + m) * s.cs;
    const float* v = s.v + (size_t)(fl * mx + m) * s.vs;
    float er = 0.f, ei = 0.f, orr = 0.f, oi = 0.f;
    SHT_UNROLL(unroll 2)
    for (int n = 0; n < nx; n += 4) {
      const sht_v4 c4 = sht_ld4(c + n);
      const sht_v4 va = sht_ld4(v + 2 * n);       // v[n], v[n + 1]
      const sht_v4 vb = sht_ld4(v + 2 * n + 4);   // v[n + 2], v[n + 3]
      er = fmaf(c4.x, va.x, er);
      ei = fmaf(c4.x, va.y, ei);
      orr = fmaf(c4.y, va.z, orr);
      oi = fmaf(c4.y, va.w, oi);
      er = fmaf(c4.z, vb.x, er);
      ei = fmaf(c4.z, vb.y, ei);
      orr = fmaf(c4.w, vb.z, orr);
      oi = fmaf(c4.w, vb.w, oi);
    }
    float* o = s.fm + (size_t)(pl * ft + fl) * 2 * s.fs;
    o[2 * m] = er - orr;
    o[2 * m + 1] = ei - oi;
    o[s.fs + 2 * m] = er + orr;
    o[s.fs + 2 * m + 1] = ei + oi;
  }
}

// One term m of the inverse DFT for longitudes x0, x0 + 1 (w = dft_inv[m,
// x0], dft_inv[m, x0 + 1]) of the south (p) and north (q) rows; g holds
// south x0, x0 + 1, north x0, x0 + 1.
SHT_HD void sht_syn_term(float px, float py, float qx, float qy, sht_v4 w,
                         float* g) {
  g[0] = fmaf(px, w.x, g[0]);
  g[0] = fmaf(-py, w.y, g[0]);
  g[1] = fmaf(px, w.z, g[1]);
  g[1] = fmaf(-py, w.w, g[1]);
  g[2] = fmaf(qx, w.x, g[2]);
  g[2] = fmaf(-qy, w.y, g[2]);
  g[3] = fmaf(qx, w.z, g[3]);
  g[3] = fmaf(-qy, w.w, g[3]);
}

// Phase 2: thread t's DFT tiles, each the south and north rows of one
// (field, pair) at the longitudes x0 = 2 gx and x0 + 1: one 16-byte load
// of dft_inv and, for two m at a time, one of each Fourier row feed 16
// products; each row's two outputs are stored as one 8-byte word.  count, if not null, is incremented at every output written
// (the host's check).
SHT_HD void sht_syn_dft(const ShtSynArgs& a, const ShtSynSmem& s,
                        const ShtSynBlock& b, int ft, int lp, int t, int T,
                        int* count) {
  const int mx = a.mx, nlon = a.nlon, nlat = a.nlat, xg = nlon / 2;
  for (int i = t; i < ft * lp * xg; i += T) {
    const int gx = i % xg, r = i / xg, fl = r % ft, pl = r / ft;
    if (fl >= b.nf || pl >= b.np) continue;
    const int x0 = 2 * gx;
    const float* fsr = s.fm + (size_t)(pl * ft + fl) * 2 * s.fs;
    const float* fnr = fsr + s.fs;
    const float* w = s.w + 2 * x0;
    float g[4] = {0.f, 0.f, 0.f, 0.f};
    int m = 0;
    SHT_UNROLL(unroll 2)
    for (; m + 1 < mx; m += 2) {
      const sht_v4 p = sht_ld4(fsr + 2 * m), q = sht_ld4(fnr + 2 * m);
      sht_syn_term(p.x, p.y, q.x, q.y, sht_ld4(w + (size_t)m * 2 * nlon), g);
      sht_syn_term(p.z, p.w, q.z, q.w,
                   sht_ld4(w + (size_t)(m + 1) * 2 * nlon), g);
    }
    if (m < mx)
      sht_syn_term(fsr[2 * m], fsr[2 * m + 1], fnr[2 * m], fnr[2 * m + 1],
                   sht_ld4(w + (size_t)m * 2 * nlon), g);
    const int bf = b.f0 + fl, j = b.j0 + pl, jn = nlat - 1 - j;
    if (bf >= a.ncos) {
      g[0] = sht_mul(g[0], a.cosgr[j]);
      g[1] = sht_mul(g[1], a.cosgr[j]);
      g[2] = sht_mul(g[2], a.cosgr[jn]);
      g[3] = sht_mul(g[3], a.cosgr[jn]);
    }
    const size_t os = ((size_t)bf * nlat + j) * nlon + x0;
    const size_t on = ((size_t)bf * nlat + jn) * nlon + x0;
    *(sht_c*)(a.out + os) = sht_c{g[0], g[1]};
    *(sht_c*)(a.out + on) = sht_c{g[2], g[3]};
    if (count) {
      ++count[os];
      ++count[os + 1];
      ++count[on];
      ++count[on + 1];
    }
  }
}

// ------------------------------------------------------------------ K5

struct ShtAnaArgs {
  const float* grid;      // (B, nlat, nlon)
  const sht_c* dft_fwd;   // (nlon, mx)
  const float* wt;        // (nlat/2,)
  const float* cpol_s;    // (nlat/2, mx, nx)
  const float* pre;       // (nlat,) or null
  int n0, B, nlat, nlon, mx, nx;
  sht_c* out;             // (B, mx, nx)
};

// A block owns one field x mg wavenumbers (mg even); grid = fields x
// wavenumber groups, field fastest.
struct ShtAnaTile {
  int mg, threads, blocks;
};

// Shared memory of a block (strides in floats):
//   w     (nlon, mg) complex, dft_fwd's columns of the group;
//   fold  (mg, even/odd, nlat/2) complex, the folded sums;
//   f     (nlat rows of nlon, stride fs = sht_pad4(nlon)) the field;
//   cp    (nlat/2, mg, nx) the group's Legendre rows;
//   pre   (nlat,) the 1/cos factors.
struct ShtAnaSmem {
  float *w, *fold, *f, *cp, *pre;
  int fs;
};

SHT_HD ShtAnaSmem sht_ana_carve(void* base, int mg, int nlat, int nlon,
                                int nx) {
  ShtAnaSmem s;
  const int iy = nlat / 2;
  s.fs = sht_pad4(nlon);
  s.w = (float*)base;
  s.fold = s.w + (size_t)2 * nlon * mg;
  s.f = s.fold + (size_t)mg * 2 * 2 * iy;
  s.cp = s.f + (size_t)nlat * s.fs;
  s.pre = s.cp + (size_t)iy * mg * nx;
  return s;
}

SHT_HD size_t sht_ana_smem_bytes(int mg, int nlat, int nlon, int nx) {
  const ShtAnaSmem s = sht_ana_carve(0, mg, nlat, nlon, nx);
  return (size_t)(s.pre + nlat - s.w) * sizeof(float);
}

// The tile of one launch: one field a block and the fewest wavenumbers
// (an even number, at least 4) that keep the grid within one block per
// SM, at most 8.  On an H100 this was the fastest of all tiles up to 8
// fields x 8 groups a block at 33 and 2 fields, and within 5% of it at 73
// fields (8 wavenumbers, 292 blocks).
static inline ShtAnaTile sht_ana_choose(int B, int nlat, int mx, int nx,
                                        int sms) {
  const int iy = nlat / 2, even_mx = mx + (mx & 1);
  ShtAnaTile tl;
  tl.mg = even_mx < 4 ? even_mx : 4;
  while (tl.mg < 8 && tl.mg < even_mx &&
         (long long)B * sht_cdiv(mx, tl.mg) > sms)
    tl.mg += 2;
  const int items = tl.mg * nx / 4, tiles = iy * tl.mg / 2;
  tl.threads = sht_threads(items > tiles ? items : tiles);
  tl.blocks = B * sht_cdiv(mx, tl.mg);
  return tl;
}

struct ShtAnaBlock {
  int f, m0, nm;   // the field; first wavenumber, count
};

SHT_HD ShtAnaBlock sht_ana_block(const ShtAnaArgs& a, int mg, int blk) {
  ShtAnaBlock b;
  b.f = blk % a.B;
  b.m0 = (blk / a.B) * mg;
  b.nm = a.mx - b.m0 < mg ? a.mx - b.m0 : mg;
  return b;
}

// Phase 0, first group: the block's field (16-byte words), its columns
// of dft_fwd (complex elements) and pre.
template <class Copy>
SHT_HD void sht_ana_stage_grid(const Copy& cp, const ShtAnaArgs& a,
                               const ShtAnaSmem& s, const ShtAnaBlock& b,
                               int mg, int t, int T) {
  const int q = a.nlon / 4;
  sht_stage_rows(cp, (sht_v4*)s.f, s.fs / 4,
                 (const sht_v4*)(a.grid + (size_t)b.f * a.nlat * a.nlon), q,
                 a.nlat, q, t, T);
  sht_stage_rows(cp, (sht_c*)s.w, mg, a.dft_fwd + b.m0, a.mx, a.nlon, b.nm, t,
                 T);
  if (a.pre) sht_stage_rows(cp, s.pre, a.nlat, a.pre, a.nlat, 1, a.nlat, t, T);
}

// Phase 0, second group, landing during phase 1: the Legendre rows of
// the group's wavenumbers (16-byte words).
template <class Copy>
SHT_HD void sht_ana_stage_legendre(const Copy& cp, const ShtAnaArgs& a,
                                   const ShtAnaSmem& s, const ShtAnaBlock& b,
                                   int mg, int t, int T) {
  const int q = a.nx / 4;
  sht_stage_rows(cp, (sht_v4*)s.cp, mg * q,
                 (const sht_v4*)(a.cpol_s + (size_t)b.m0 * a.nx),
                 (size_t)a.mx * q, a.nlat / 2, b.nm * q, t, T);
}

// One longitude of the zonal DFT for wavenumbers mm, mm + 1 (w =
// dft_fwd[x, m0 + mm], dft_fwd[x, m0 + mm + 1]) of the south (p) and
// north (q) rows: acc holds south re, im of mm, of mm + 1, then north.
SHT_HD void sht_ana_term(float p, float q, sht_v4 w, float* acc) {
  acc[0] = fmaf(p, w.x, acc[0]);
  acc[1] = fmaf(p, w.y, acc[1]);
  acc[2] = fmaf(p, w.z, acc[2]);
  acc[3] = fmaf(p, w.w, acc[3]);
  acc[4] = fmaf(q, w.x, acc[4]);
  acc[5] = fmaf(q, w.y, acc[5]);
  acc[6] = fmaf(q, w.z, acc[6]);
  acc[7] = fmaf(q, w.w, acc[7]);
}

// The south (rs) and north (rn) rows' DFT at two wavenumbers (w: dft_fwd's
// column pair, row stride 2 mg floats) into acc; SCALE multiplies each row
// value by ps / pn first (a field from n0 on), rounded as the plain
// version's grid * pre.  Per 4 longitudes, one 16-byte load of each row
// and four of dft_fwd feed 32 products.
template <bool SCALE>
SHT_HD void sht_ana_rows(const float* rs, const float* rn, const float* w,
                         int mg, int nlon, float ps, float pn, float* acc) {
  SHT_UNROLL(unroll 2)
  for (int x = 0; x < nlon; x += 4) {
    sht_v4 p = sht_ld4(rs + x), q = sht_ld4(rn + x);
    if (SCALE) {
      p.x = sht_mul(p.x, ps);
      p.y = sht_mul(p.y, ps);
      p.z = sht_mul(p.z, ps);
      p.w = sht_mul(p.w, ps);
      q.x = sht_mul(q.x, pn);
      q.y = sht_mul(q.y, pn);
      q.z = sht_mul(q.z, pn);
      q.w = sht_mul(q.w, pn);
    }
    sht_ana_term(p.x, q.x, sht_ld4(w + (size_t)(x + 0) * 2 * mg), acc);
    sht_ana_term(p.y, q.y, sht_ld4(w + (size_t)(x + 1) * 2 * mg), acc);
    sht_ana_term(p.z, q.z, sht_ld4(w + (size_t)(x + 2) * 2 * mg), acc);
    sht_ana_term(p.w, q.w, sht_ld4(w + (size_t)(x + 3) * 2 * mg), acc);
  }
}

// Phase 1: thread t's DFT tiles, each one latitude pair at the
// wavenumbers mm = 2 gm, 2 gm + 1 (sht_ana_rows); then the fold with the
// Gaussian weight in registers.
SHT_HD void sht_ana_dft(const ShtAnaArgs& a, const ShtAnaSmem& s,
                        const ShtAnaBlock& b, int mg, int t, int T) {
  const int nlat = a.nlat, nlon = a.nlon, iy = nlat / 2, mq = mg / 2;
  for (int i = t; i < iy * mq; i += T) {
    const int gm = i % mq, j = i / mq;
    if (2 * gm >= b.nm) continue;
    const int jn = nlat - 1 - j;
    const float* rs = s.f + (size_t)j * s.fs;
    const float* rn = s.f + (size_t)jn * s.fs;
    const float* w = s.w + 4 * gm;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (a.pre && b.f >= a.n0)
      sht_ana_rows<true>(rs, rn, w, mg, nlon, s.pre[j], s.pre[jn], acc);
    else
      sht_ana_rows<false>(rs, rn, w, mg, nlon, 1.f, 1.f, acc);
    const float wj = a.wt[j];
    for (int k = 0; k < 2 && 2 * gm + k < b.nm; ++k) {
      const float sr = acc[2 * k], si = acc[2 * k + 1];
      const float nr = acc[4 + 2 * k], ni = acc[5 + 2 * k];
      float* o = s.fold + (size_t)(2 * gm + k) * 4 * iy;
      o[2 * j] = sht_mul(sht_add(nr, sr), wj);
      o[2 * j + 1] = sht_mul(sht_add(ni, si), wj);
      o[2 * iy + 2 * j] = sht_mul(sht_sub(nr, sr), wj);
      o[2 * iy + 2 * j + 1] = sht_mul(sht_sub(ni, si), wj);
    }
  }
}

// Phase 2: thread t's outputs (m, n .. n + 3), n fastest: the
// Legendre sums over the latitude pairs, even n on the sum and odd n on
// the difference; one 16-byte load of the Legendre row per pair.  count
// as in sht_syn_dft.
SHT_HD void sht_ana_legendre(const ShtAnaArgs& a, const ShtAnaSmem& s,
                             const ShtAnaBlock& b, int mg, int t, int T,
                             int* count) {
  const int nx = a.nx, iy = a.nlat / 2, q = nx / 4;
  for (int i = t; i < mg * q; i += T) {
    const int h = i % q, mm = i / q;
    if (mm >= b.nm) continue;
    const float* sv = s.fold + (size_t)mm * 4 * iy;
    const float* dv = sv + 2 * iy;
    const float* c = s.cp + (size_t)mm * nx + 4 * h;
    sht_v4 lo = {0.f, 0.f, 0.f, 0.f}, hi = {0.f, 0.f, 0.f, 0.f};
    SHT_UNROLL(unroll 4)
    for (int j = 0; j < iy; ++j) {
      const sht_v4 cj = sht_ld4(c + (size_t)j * mg * nx);
      const float sr = sv[2 * j], si = sv[2 * j + 1];
      const float dr = dv[2 * j], di = dv[2 * j + 1];
      lo.x = fmaf(cj.x, sr, lo.x);   // n even
      lo.y = fmaf(cj.x, si, lo.y);
      lo.z = fmaf(cj.y, dr, lo.z);   // n + 1 odd
      lo.w = fmaf(cj.y, di, lo.w);
      hi.x = fmaf(cj.z, sr, hi.x);
      hi.y = fmaf(cj.z, si, hi.y);
      hi.z = fmaf(cj.w, dr, hi.z);
      hi.w = fmaf(cj.w, di, hi.w);
    }
    const size_t o = ((size_t)b.f * a.mx + b.m0 + mm) * nx + 4 * h;
    sht_st4((float*)(a.out + o), lo);
    sht_st4((float*)(a.out + o) + 4, hi);
    if (count)
      for (int k = 0; k < 4; ++k) ++count[o + k];
  }
}

#ifdef __CUDACC__
// ------------------------------------------------- the kernels' side only

// Global -> shared copies of one element by cp.async (4, 8 or 16 bytes;
// the host build copies directly); sht_async_commit closes a group,
// sht_async_wait<N> waits until at most N groups are in flight.
struct ShtAsyncCopy {
  __host__ __device__ __forceinline__ void operator()(
      float* d, const float* s) const {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(d)),
                 "l"(s)
                 : "memory");
#endif
  }
  __host__ __device__ __forceinline__ void operator()(
      sht_c* d, const sht_c* s) const {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(d)),
                 "l"(s)
                 : "memory");
#endif
  }
  __host__ __device__ __forceinline__ void operator()(
      sht_v4* d, const sht_v4* s) const {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(d)),
                 "l"(s)
                 : "memory");
#endif
  }
};
__device__ __forceinline__ void sht_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void sht_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The SM count and the opt-in shared memory of a block on `device`, read
// once per process and device.
static inline cudaError_t sht_device_limits(int device, int* sms,
                                            size_t* smem_max) {
  static int cached_sms[64], cached_smem[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (cached_sms[device] == 0) {
    int s = 0, m = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &m, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return err;
    cached_smem[device] = m;
    cached_sms[device] = s;
  }
  *sms = cached_sms[device];
  *smem_max = (size_t)cached_smem[device];
  return cudaSuccess;
}

// Raises a kernel's dynamic shared-memory limit to `bytes` where that is
// above the default 48 KB and above what was set before (per device).
static inline cudaError_t sht_smem_limit(const void* kernel, int device,
                                         size_t bytes, int* set_before) {
  if (bytes <= 48 * 1024 || (int)bytes <= set_before[device]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) set_before[device] = (int)bytes;
  return err;
}
#endif

// Host build of K6's and K5's arithmetic (sht.cuh) and of K6_inject's
// phase 0 (inject_spectral.cuh): the code the CUDA kernels run, with
// every thread of every block written out as loops on the CPU (K6_inject's
// warps lane by lane in phase order, the exchange of neighbours as
// copies), beside a naive loop in the first designs' order.  It is not
// part of the kernel library; the CPU tests compile it with a host C++
// compiler
//   g++ -O2 -ffp-contract=off -shared -fPIC sht_host.cpp -o lib.so
// and hold the tiled result against the naive one bit for bit and against
// the plain PyTorch versions, so that an error in a tile, the layout or
// the tile choice shows without a card.

#include <stdlib.h>
#include <string.h>

#include <vector>

#include "inject_spectral.cuh"
#include "sht.cuh"

namespace {

struct HostCopy {
  void operator()(float* d, const float* s) const { *d = *s; }
  void operator()(sht_c* d, const sht_c* s) const { *d = *s; }
  void operator()(sht_v4* d, const sht_v4* s) const { *d = *s; }
};

// A block's shared memory, every byte NaN, so that reading what was
// never staged poisons the outputs.
struct HostSmem {
  std::vector<double> buf;
  explicit HostSmem(size_t bytes) : buf(bytes / sizeof(double) + 2) {}
  void* reset() {
    memset(buf.data(), 0xff, buf.size() * sizeof(double));
    return buf.data();
  }
};

sht_c sht_make(float x, float y) {
  sht_c c;
  c.x = x;
  c.y = y;
  return c;
}

}  // namespace

// The launch's arguments less the device and the stream, plus the SM
// count and shared-memory limit that pick the tile, and count (B, nlat,
// nlon) ints that every written output increments.  tile gets (ft, lp,
// threads, blocks).
extern "C" int sht_synthesis_host(const void* spec, const void* dft_inv,
                                  const void* cpol_g, const void* cosgr,
                                  int ncos, int B, int nlat, int nlon, int mx,
                                  int nx, void* out, int* count, int sms,
                                  long long smem_max, int* tile) {
  const ShtSynTile tl =
      sht_syn_choose(B, nlat, nlon, mx, nx, sms, (size_t)smem_max);
  const size_t bytes = sht_syn_smem_bytes(tl.ft, tl.lp, mx, nx, nlon);
  if (tl.blocks <= 0 || bytes > (size_t)smem_max) return 1;
  tile[0] = tl.ft;
  tile[1] = tl.lp;
  tile[2] = tl.threads;
  tile[3] = tl.blocks;
  const ShtSynArgs a = {(const sht_c*)spec, (const sht_c*)dft_inv,
                        (const float*)cpol_g, (const float*)cosgr,
                        ncos, B, nlat, nlon, mx, nx, (float*)out};
  HostSmem mem(bytes);
  const HostCopy cp;
  const int T = tl.threads;
  for (int blk = 0; blk < tl.blocks; ++blk) {
    const ShtSynSmem s =
        sht_syn_carve(mem.reset(), tl.ft, tl.lp, mx, nx, nlon);
    const ShtSynBlock b = sht_syn_block(a, tl.ft, tl.lp, blk);
    for (int t = 0; t < T; ++t) sht_syn_stage_coef(cp, a, s, b, t, T);
    for (int t = 0; t < T; ++t) sht_syn_stage_dft(cp, a, s, t, T);
    for (int t = 0; t < T; ++t) sht_syn_legendre(a, s, b, tl.ft, tl.lp, t, T);
    for (int t = 0; t < T; ++t)
      sht_syn_dft(a, s, b, tl.ft, tl.lp, t, T, count);
  }
  return 0;
}

// K6_inject: K's state and the grid (4K, nlat, nlon) of [t, q | u, v]
// from K5's output spec (4K + 1, mx, nx) and the blob (inject_blob),
// with K6's tables as above; count and tile as there.  1 for an nx that
// the kernel does not take.
extern "C" int inject_synthesis_host(int K, const void* spec,
                                     const void* blob, const void* dft_inv,
                                     const void* cpol_g, const void* cosgr,
                                     int nlat, int nlon, int mx, int nx,
                                     void* vor, void* div, void* tem,
                                     void* ps, void* tr, void* out,
                                     int* count, int sms, long long smem_max,
                                     int* tile) {
  const int B = 4 * K;
  if (K <= 0 || nx > 32) return 1;
  const ShtSynTile tl =
      sht_inj_choose(B, nlat, nlon, mx, nx, sms, (size_t)smem_max);
  const size_t bytes = sht_syn_smem_bytes(tl.ft, tl.lp, mx, nx, nlon);
  if (tl.blocks <= 0 || bytes > (size_t)smem_max) return 1;
  tile[0] = tl.ft;
  tile[1] = tl.lp;
  tile[2] = tl.threads;
  tile[3] = tl.blocks;
  const ShtSynArgs a = {nullptr, (const sht_c*)dft_inv, (const float*)cpol_g,
                        (const float*)cosgr, 2 * K, B, nlat, nlon, mx, nx,
                        (float*)out};
  const InjSynArgs ia = {(const stack_c<float>*)spec, (const float*)blob,
                         (stack_c<float>*)vor, (stack_c<float>*)div,
                         (stack_c<float>*)tem, (stack_c<float>*)ps,
                         (stack_c<float>*)tr, K};
  HostSmem mem(bytes);
  const HostCopy cp;
  const int T = tl.threads, W = T / 32;
  std::vector<InjLane> L(32);
  std::vector<InjNb> nb(32);
  for (int blk = 0; blk < tl.blocks; ++blk) {
    const ShtSynSmem s =
        sht_syn_carve(mem.reset(), tl.ft, tl.lp, mx, nx, nlon);
    const ShtSynBlock b = sht_syn_block(a, tl.ft, tl.lp, blk);
    const InjBlk B = inj_blk(a, ia, b, tl.lp);
    for (int t = 0; t < T; ++t) sht_syn_stage_legendre(cp, a, s, b, t, T);
    for (int t = 0; t < T; ++t) sht_syn_stage_dft(cp, a, s, t, T);
    for (int w = 0; w < W; ++w)
      for (int m = w; m < mx; m += W) {
        if (!B.uv) {
          for (int n = 0; n < 32; ++n) inj_tq_lane(B, a, s, m, n);
          continue;
        }
        memset(L.data(), 0xff, L.size() * sizeof(InjLane));
        memset(nb.data(), 0xff, nb.size() * sizeof(InjNb));
        for (int n = 0; n < 32; ++n) inj_uv_load(L[n], B, a, m, n);
        for (int n = 0; n < 32; ++n) {
          // a shuffle outside the warp returns the lane's own value
          auto xch = [&](int v, int fl, int d) {
            const int j = (n + d >= 0 && n + d < 32) ? n + d : n;
            return v ? L[j].div[fl] : L[j].vor[fl];
          };
          inj_uv_exchange(B, nx, n, xch, nb[n]);
        }
        for (int n = 0; n < 32; ++n) inj_uv_out(L[n], nb[n], B, a, s, m, n);
      }
    for (int t = 0; t < T; ++t)
      sht_syn_legendre(a, s, b, tl.ft, tl.lp, t, T);
    for (int t = 0; t < T; ++t)
      sht_syn_dft(a, s, b, tl.ft, tl.lp, t, T, count);
  }
  return 0;
}

// K6 as its first design summed, one (latitude pair, field) at a time.
extern "C" void sht_synthesis_naive(const void* spec_, const void* dft_inv_,
                                    const void* cpol_g_, const void* cosgr_,
                                    int ncos, int B, int nlat, int nlon,
                                    int mx, int nx, void* out_) {
  const sht_c* spec = (const sht_c*)spec_;
  const sht_c* dft_inv = (const sht_c*)dft_inv_;
  const float* cpol_g = (const float*)cpol_g_;
  const float* cosgr = (const float*)cosgr_;
  float* out = (float*)out_;
  std::vector<sht_c> fs(mx), fn(mx);
  for (int b = 0; b < B; ++b) {
    for (int j = 0; j < nlat / 2; ++j) {
      const sht_c* v = spec + (size_t)b * mx * nx;
      for (int m = 0; m < mx; ++m) {
        const float* c = cpol_g + ((size_t)j * mx + m) * nx;
        const sht_c* vm = v + m * nx;
        float er = 0.f, ei = 0.f, orr = 0.f, oi = 0.f;
        for (int n = 0; n < nx; n += 2) {
          er = fmaf(c[n], vm[n].x, er);
          ei = fmaf(c[n], vm[n].y, ei);
          if (n + 1 < nx) {
            orr = fmaf(c[n + 1], vm[n + 1].x, orr);
            oi = fmaf(c[n + 1], vm[n + 1].y, oi);
          }
        }
        fs[m] = sht_make(er - orr, ei - oi);
        fn[m] = sht_make(er + orr, ei + oi);
      }
      const int jn = nlat - 1 - j;
      const bool scale = b >= ncos;
      for (int x = 0; x < nlon; ++x) {
        float gs = 0.f, gn = 0.f;
        for (int m = 0; m < mx; ++m) {
          const sht_c w = dft_inv[m * nlon + x];
          gs = fmaf(fs[m].x, w.x, gs);
          gs = fmaf(-fs[m].y, w.y, gs);
          gn = fmaf(fn[m].x, w.x, gn);
          gn = fmaf(-fn[m].y, w.y, gn);
        }
        if (scale) {
          gs = gs * cosgr[j];
          gn = gn * cosgr[jn];
        }
        out[((size_t)b * nlat + j) * nlon + x] = gs;
        out[((size_t)b * nlat + jn) * nlon + x] = gn;
      }
    }
  }
}

// As sht_synthesis_host; pre may be null; count (B, mx, nx) ints; tile
// gets (1, mg, threads, blocks): one field a block.
extern "C" int sht_analysis_host(const void* grid, const void* dft_fwd,
                                 const void* wt, const void* cpol_s,
                                 const void* pre, int n0, int B, int nlat,
                                 int nlon, int mx, int nx, void* out,
                                 int* count, int sms, long long smem_max,
                                 int* tile) {
  const ShtAnaTile tl =
      sht_ana_choose(B, nlat, mx, nx, sms);
  const size_t bytes = sht_ana_smem_bytes(tl.mg, nlat, nlon, nx);
  if (tl.blocks <= 0 || bytes > (size_t)smem_max) return 1;
  tile[0] = 1;
  tile[1] = tl.mg;
  tile[2] = tl.threads;
  tile[3] = tl.blocks;
  const ShtAnaArgs a = {(const float*)grid, (const sht_c*)dft_fwd,
                        (const float*)wt, (const float*)cpol_s,
                        (const float*)pre, n0, B, nlat, nlon, mx, nx,
                        (sht_c*)out};
  HostSmem mem(bytes);
  const HostCopy cp;
  const int T = tl.threads;
  for (int blk = 0; blk < tl.blocks; ++blk) {
    const ShtAnaSmem s = sht_ana_carve(mem.reset(), tl.mg, nlat, nlon, nx);
    const ShtAnaBlock b = sht_ana_block(a, tl.mg, blk);
    for (int t = 0; t < T; ++t) sht_ana_stage_grid(cp, a, s, b, tl.mg, t, T);
    for (int t = 0; t < T; ++t)
      sht_ana_stage_legendre(cp, a, s, b, tl.mg, t, T);
    for (int t = 0; t < T; ++t) sht_ana_dft(a, s, b, tl.mg, t, T);
    for (int t = 0; t < T; ++t)
      sht_ana_legendre(a, s, b, tl.mg, t, T, count);
  }
  return 0;
}

// K5 as its first design summed, one field at a time.
extern "C" void sht_analysis_naive(const void* grid_, const void* dft_fwd_,
                                   const void* wt_, const void* cpol_s_,
                                   const void* pre_, int n0, int B, int nlat,
                                   int nlon, int mx, int nx, void* out_) {
  const float* grid = (const float*)grid_;
  const sht_c* dft_fwd = (const sht_c*)dft_fwd_;
  const float* wt = (const float*)wt_;
  const float* cpol_s = (const float*)cpol_s_;
  const float* pre = (const float*)pre_;
  sht_c* out = (sht_c*)out_;
  std::vector<float> f((size_t)nlat * nlon);
  std::vector<sht_c> fm((size_t)mx * nlat);
  const int iy = nlat / 2;
  for (int b = 0; b < B; ++b) {
    const float* src = grid + (size_t)b * nlat * nlon;
    const bool scale = pre != nullptr && b >= n0;
    for (int i = 0; i < nlat * nlon; ++i) {
      const int j = i / nlon;
      f[i] = scale ? src[i] * pre[j] : src[i];
    }
    for (int j = 0; j < nlat; ++j) {
      for (int m = 0; m < mx; ++m) {
        float re = 0.f, im = 0.f;
        for (int i = 0; i < nlon; ++i) {
          const sht_c c = dft_fwd[(size_t)i * mx + m];
          re = fmaf(f[j * nlon + i], c.x, re);
          im = fmaf(f[j * nlon + i], c.y, im);
        }
        fm[m * nlat + j] = sht_make(re, im);
      }
    }
    for (int m = 0; m < mx; ++m) {
      for (int n = 0; n < nx; ++n) {
        const bool even = (n & 1) == 0;
        const sht_c* g = fm.data() + m * nlat;
        float re = 0.f, im = 0.f;
        for (int j = 0; j < iy; ++j) {
          const sht_c s = g[j];
          const sht_c nn = g[nlat - 1 - j];
          const float w = wt[j];
          const float ar = (even ? nn.x + s.x : nn.x - s.x) * w;
          const float ai = (even ? nn.y + s.y : nn.y - s.y) * w;
          const float c = cpol_s[((size_t)j * mx + m) * nx + n];
          re = fmaf(c, ar, re);
          im = fmaf(c, ai, im);
        }
        out[((size_t)b * mx + m) * nx + n] = sht_make(re, im);
      }
    }
  }
}

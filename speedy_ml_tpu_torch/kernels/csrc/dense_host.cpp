// Host build of K2's and K14's arithmetic (readout.cuh, gram_update.cuh):
// the code the CUDA kernels run, with the warp and the thread blocks
// written out as loops on the CPU (K2's with its store into the assembled
// grid, and its components form).  It is not part of the kernel library;
// the CPU tests compile it with a host C++ compiler
//   g++ -O2 -ffp-contract=off -shared -fPIC dense_host.cpp -o lib.so
// and hold it against the plain PyTorch versions, so that an error in the
// row split of K2 or in the panel and the tile lists of K14 shows without
// a card.

#include <math.h>

#include "gram_update.cuh"
#include "readout.cuh"

// ----------------------------------------------------------------- K2

// The rows [o0, o_end) of region r, as one block's warps take them
// (warp w on rows o0 + w, o0 + w + RO_WARPS, ...), each stored by lane 0
// The butterfly of the warp's lane values (__shfl_xor_sync)
static void ro_butterfly(float* v) {
  float w[RO_LANES];
  for (int off = RO_LANES / 2; off > 0; off >>= 1) {
    for (int l = 0; l < RO_LANES; ++l) w[l] = v[l] + v[l ^ off];
    for (int l = 0; l < RO_LANES; ++l) v[l] = w[l];
  }
}

template <int ES, bool VEC, bool COMP>
static void readout_rows(const unsigned char* wout, const float* aug, int r,
                         int O, int S, int A, int o0, int o_end,
                         const float* out_mean, const float* out_std,
                         float* out, const RoScatter& sc,
                         const RoParts& pt) {
  for (int warp = 0; warp < RO_WARPS; ++warp)
    for (int o = o0 + warp; o < o_end; o += RO_WARPS) {
      const long long k = (long long)r * O + o;
      const unsigned char* row = wout + (size_t)k * A * ES;
      if (COMP) {
        float p[RO_LANES], m[RO_LANES];
        for (int l = 0; l < RO_LANES; ++l)
          ro_lane_dot2<ES, VEC>(row, aug, A, S, l, p[l], m[l]);
        ro_butterfly(p);
        ro_butterfly(m);
        const float acc = p[0] + m[0];
        ro_store_parts(out_std ? ro_unstd(acc, out_std[k], out_mean[k])
                               : acc,
                       p[0], m[0], k, out, sc, pt);
        continue;
      }
      float v[RO_LANES];
      for (int l = 0; l < RO_LANES; ++l)
        v[l] = ro_lane_dot<ES, VEC>(row, aug, A, l);
      ro_butterfly(v);
      ro_store(out_std ? ro_unstd(v[0], out_std[k], out_mean[k]) : v[0], k,
               out, sc);
    }
}

// The blocks (region r, tile t of tile_rows rows), each building its aug
template <int ES, bool COMP>
static int readout_es(const void* wout, const float* x, const float* lm,
                      const float* out_mean, const float* out_std, int R,
                      int O, int S, int n, int tile_rows, float* out,
                      const RoScatter& sc, const RoParts& pt) {
  const int A = S + n;
  const bool vec = ro_vector_ok(wout, A, ES);
  // aug as the kernel keeps it in shared memory: 16-byte aligned
  float* buf = new float[A + 4];
  float* aug = (float*)(((uintptr_t)buf + 15) & ~(uintptr_t)15);
  for (int r = 0; r < R; ++r)
    for (int o0 = 0; o0 < O; o0 += tile_rows) {
      for (int a = 0; a < A; ++a) {
        const float v = ro_aug(x, lm, r, a, S, n);
        aug[a] = ES == 2 && !COMP ? ro_round_bf16(v) : v;
      }
      const int o_end = o0 + tile_rows < O ? o0 + tile_rows : O;
      if (vec)
        readout_rows<ES, true, COMP>((const unsigned char*)wout, aug, r, O,
                                     S, A, o0, o_end, out_mean, out_std, out,
                                     sc, pt);
      else
        readout_rows<ES, false, COMP>((const unsigned char*)wout, aug, r, O,
                                      S, A, o0, o_end, out_mean, out_std,
                                      out, sc, pt);
    }
  delete[] buf;
  return vec ? 1 : 0;
}

// readout_launch's arguments less the device and the stream, with the
// rows a block takes (tile_rows; the kernel's: readout_tile_rows_host);
// returns 1 where the vector path was taken, 0 for the scalar one
extern "C" int readout_host(int wout_bf16, const void* wout, const void* x,
                            const void* lm, const void* out_mean,
                            const void* out_std, int R, int O, int S, int n,
                            int tile_rows, void* out, void* grid,
                            const void* index, long long q0, long long q1,
                            long long p0, long long p1) {
  const RoScatter sc = {(float*)grid, (const int*)index, q0, q1, p0, p1};
  const RoParts pt = {nullptr, nullptr};
  return wout_bf16
             ? readout_es<2, false>(wout, (const float*)x, (const float*)lm,
                                    (const float*)out_mean,
                                    (const float*)out_std, R, O, S, n,
                                    tile_rows, (float*)out, sc, pt)
             : readout_es<4, false>(wout, (const float*)x, (const float*)lm,
                                    (const float*)out_mean,
                                    (const float*)out_std, R, O, S, n,
                                    tile_rows, (float*)out, sc, pt);
}

// The components form: readout_components_launch's arguments less the
// device and the stream, with tile_rows; returns the path as readout_host
extern "C" int readout_components_host(
    int wout_bf16, const void* wout, const void* x, const void* lm,
    const void* out_mean, const void* out_std, int R, int O, int S, int n,
    int tile_rows, void* out, void* vp, void* vml, void* grid,
    const void* index, long long q0, long long q1, long long p0,
    long long p1) {
  const RoScatter sc = {(float*)grid, (const int*)index, q0, q1, p0, p1};
  const RoParts pt = {(float*)vp, (float*)vml};
  return wout_bf16
             ? readout_es<2, true>(wout, (const float*)x, (const float*)lm,
                                   (const float*)out_mean,
                                   (const float*)out_std, R, O, S, n,
                                   tile_rows, (float*)out, sc, pt)
             : readout_es<4, true>(wout, (const float*)x, (const float*)lm,
                                   (const float*)out_mean,
                                   (const float*)out_std, R, O, S, n,
                                   tile_rows, (float*)out, sc, pt);
}

// The rows a block of the kernel takes on a card of `sms` SMs
extern "C" int readout_tile_rows_host(int sms, int R, int O) {
  return ro_tile_rows(sms, R, O);
}

// ---------------------------------------------------------------- K14

static float host_fma(float a, float b, float c) { return fmaf(a, b, c); }
static double host_fma(double a, double b, double c) { return fma(a, b, c); }

// The panel, then every tile of every region as the kernel's blocks
// compute it from the panel: each output summed in sample order with FMA
// from 0, then added to its old value once, directly and (mirrored
// tiles) into the transpose.
template <typename T>
static void gram_tiles(int tile, int sym, const T* states, const T* model,
                       const T* target, int C, int R, int n, int S, int O,
                       T* ss, T* st) {
  const int A = S + n;
  const int Ap = gu_panel_aug(A, tile), W = gu_panel_width(A, O, tile);
  T* P = new T[(size_t)R * C * W];
  for (int r = 0; r < R; ++r)
    for (int c = 0; c < C; ++c)
      for (int w = 0; w < W; ++w)
        P[((size_t)r * C + c) * W + w] =
            gu_panel(states, model, target, R, n, S, O, Ap, r, c, w);
  for (int r = 0; r < R; ++r)
    for (int t = 0; t < gu_tiles(A, O, tile, sym != 0); ++t) {
      const GuTile g = gu_decode(t, A, tile, sym != 0);
      T* dst = g.kind == GU_SS ? ss : st;
      const T* left = P + (size_t)r * C * W + gu_left_col(g, Ap, tile);
      const T* right = P + (size_t)r * C * W + gu_right_col(g, tile);
      const int rows = gu_rows(g, A, O, tile), cols = gu_cols(g, A, tile);
      for (int ii = 0; ii < rows; ++ii)
        for (int jj = 0; jj < cols; ++jj) {
          T acc = T(0);
          for (int c = 0; c < C; ++c)
            acc = host_fma(left[(size_t)c * W + ii], right[(size_t)c * W + jj],
                           acc);
          T* d = dst + gu_direct(g, r, ii, jj, A, O, tile);
          *d = *d + acc;
          if (g.mirror) {
            T* e = ss + gu_mirror(g, r, ii, jj, A, tile);
            *e = *e + acc;
          }
        }
    }
  delete[] P;
}

// gram_update_launch's arguments less the device, the panel and the
// stream, with the tile size (the kernel's: 128 for the float32
// symmetric list, else 64) and the list (sym 1: the upper triangle,
// mirrored; 0: full)
extern "C" int gram_update_host(int is_double, int tile, int sym,
                                const void* states, const void* model,
                                const void* target, int C, int R, int n,
                                int S, int O, void* ss, void* st) {
  if (is_double)
    gram_tiles<double>(tile, sym, (const double*)states,
                       (const double*)model, (const double*)target, C, R, n,
                       S, O, (double*)ss, (double*)st);
  else
    gram_tiles<float>(tile, sym, (const float*)states, (const float*)model,
                      (const float*)target, C, R, n, S, O, (float*)ss,
                      (float*)st);
  return 0;
}

// How often the tile list writes each output of one region: cnt_ss
// (A, A) and cnt_st (O, A), zeroed by the caller
extern "C" int gram_coverage_host(int A, int O, int tile, int sym,
                                  unsigned char* cnt_ss,
                                  unsigned char* cnt_st) {
  for (int t = 0; t < gu_tiles(A, O, tile, sym != 0); ++t) {
    const GuTile g = gu_decode(t, A, tile, sym != 0);
    unsigned char* dst = g.kind == GU_SS ? cnt_ss : cnt_st;
    const int rows = gu_rows(g, A, O, tile), cols = gu_cols(g, A, tile);
    for (int ii = 0; ii < rows; ++ii)
      for (int jj = 0; jj < cols; ++jj) {
        ++dst[gu_direct(g, 0, ii, jj, A, O, tile)];
        if (g.mirror) ++cnt_ss[gu_mirror(g, 0, ii, jj, A, tile)];
      }
  }
  return 0;
}

// K2's arithmetic, shared by the CUDA kernel (readout.cu) and its host
// build (dense_host.cpp, which the CPU tests compile with g++ and hold
// against the plain PyTorch version): the augmented vector, its rounding
// to bfloat16, one lane's share of a Wout row's dot product, the
// unstandardize epilogue, the store (into the (R, O) vector, or into the
// assembled grid with the clamps: the core scatter) and the rows a block
// takes.  Wout elements are read as raw bits (bfloat16:
// the upper half of a float), so the same code runs on both sides.
//
// A row is split over RO_LANES lanes.  On the vector path a row that
// starts 8 bytes past a 16-byte boundary (every second row when A is 4
// mod 8 in bf16) first takes a head of 4 elements, one per lane; the body
// is 16-byte words, word c on lane c % RO_LANES, RO_UNROLL of them loaded
// before their products; the last A - head mod 8 elements are the tail,
// one per lane.  Each lane sums its elements in that order with fmaf; the
// lanes' sums are then added by the xor butterfly of offsets 16, 8, 4, 2,
// 1 (shuffles on the card; dense_host.cpp repeats them).
//
// The components form (the JAX package's predict_all(components=True),
// hybrid/model.py:338-372) splits each row's sum at S: v_p over the
// local-model block (a < S) and v_ml over the reservoir block, two
// accumulators filled in the same pass and order (ro_lane_dot2), added
// for the main output; aug is then NOT rounded to bf16 (there the JAX
// einsum of a bf16 Wout and the f32 vector promotes to f32).

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define RO_HD __host__ __device__ __forceinline__
#else
#define RO_HD inline
#endif

#define RO_LANES 32   // lanes that share one Wout row (a warp)
#define RO_UNROLL 4   // 16-byte words a lane loads before their products
#define RO_WARPS 8    // warps of a block, each on its own rows

RO_HD float ro_from_bits(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, 4);
  return f;
#endif
}

RO_HD uint32_t ro_to_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
#endif
}

// v rounded to bfloat16 (to nearest, ties to even) and widened back: the
// rounding of torch's .to(torch.bfloat16)
RO_HD float ro_round_bf16(float v) {
  uint32_t u = ro_to_bits(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return v;  // NaN stays NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return ro_from_bits(u & 0xffff0000u);
}

// aug[a] of region r before any rounding: [local_model (S) ; x with the
// odd nodes squared (n)]
RO_HD float ro_aug(const float* x, const float* lm, long long r, int a, int S,
                   int n) {
  if (a < S) return lm[r * S + a];
  const int i = a - S;
  const float xi = x[r * n + i];
  return (i & 1) ? xi * xi : xi;
}

// Elements before the first 16-byte boundary of a row of ES-byte elements
RO_HD int ro_head(const unsigned char* row, int es) {
  return (int)((16u - (unsigned)((uintptr_t)row & 15u)) & 15u) / es;
}

// True where every row of Wout (R, O, A) can take the vector path: each
// row starts on a 16-byte boundary or 4 elements before one, so that the
// body's words and aug's float4 pairs line up.  (readout.py's
// vector_path is the same rule.)
RO_HD bool ro_vector_ok(const void* wout, int A, int es) {
  return A % 4 == 0 && (uintptr_t)wout % (uintptr_t)(4 * es) == 0;
}

struct RoWord {
  uint32_t w[4];
};

RO_HD RoWord ro_load16(const unsigned char* p) {
  RoWord v;
#ifdef __CUDA_ARCH__
  // evict-first: Wout is read once per cycle and must not evict the state
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  v.w[0] = q.x;
  v.w[1] = q.y;
  v.w[2] = q.z;
  v.w[3] = q.w;
#else
  memcpy(v.w, p, 16);
#endif
  return v;
}

template <int ES>
struct RoElem;

// bfloat16 Wout: 8 elements to a word, element 2k in the low half of w[k]
template <>
struct RoElem<2> {
  static RO_HD float at(const unsigned char* row, int a) {
    uint16_t h;
#ifdef __CUDA_ARCH__
    h = reinterpret_cast<const uint16_t*>(row)[a];
#else
    memcpy(&h, row + 2 * (size_t)a, 2);
#endif
    return ro_from_bits((uint32_t)h << 16);
  }
  // element j of a word (the order of dot)
  static RO_HD float word_at(const RoWord& v, int j) {
    return ro_from_bits((j & 1) ? (v.w[j >> 1] & 0xffff0000u)
                                : (v.w[j >> 1] << 16));
  }
  // acc + the word's 8 products with aug[0..7] (16-byte aligned)
  static RO_HD float dot(const RoWord& v, const float* aug, float acc) {
#ifdef __CUDA_ARCH__
    const float4 p = reinterpret_cast<const float4*>(aug)[0];
    const float4 q = reinterpret_cast<const float4*>(aug)[1];
    const float a[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#else
    const float* a = aug;
#endif
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc = fmaf(ro_from_bits(v.w[k] << 16), a[2 * k], acc);
      acc = fmaf(ro_from_bits(v.w[k] & 0xffff0000u), a[2 * k + 1], acc);
    }
    return acc;
  }
};

// float32 Wout: 4 elements to a word
template <>
struct RoElem<4> {
  static RO_HD float at(const unsigned char* row, int a) {
    float f;
#ifdef __CUDA_ARCH__
    f = reinterpret_cast<const float*>(row)[a];
#else
    memcpy(&f, row + 4 * (size_t)a, 4);
#endif
    return f;
  }
  static RO_HD float word_at(const RoWord& v, int j) {
    return ro_from_bits(v.w[j]);
  }
  static RO_HD float dot(const RoWord& v, const float* aug, float acc) {
#ifdef __CUDA_ARCH__
    const float4 p = reinterpret_cast<const float4*>(aug)[0];
    const float a[4] = {p.x, p.y, p.z, p.w};
#else
    const float* a = aug;
#endif
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = fmaf(ro_from_bits(v.w[k]), a[k], acc);
    return acc;
  }
};

// Lane `lane`'s share of sum_a row[a] * aug[a] for a row of A ES-byte
// elements; aug is 16-byte aligned.  VEC: head, 16-byte body, tail (the
// row must pass ro_vector_ok); else element a on lane a % RO_LANES.
template <int ES, bool VEC>
RO_HD float ro_lane_dot(const unsigned char* row, const float* aug, int A,
                        int lane) {
  float acc = 0.f;
  if (!VEC) {
    for (int a = lane; a < A; a += RO_LANES)
      acc = fmaf(RoElem<ES>::at(row, a), aug[a], acc);
    return acc;
  }
  constexpr int N = 16 / ES;  // elements to a word
  const int head = ro_head(row, ES) < A ? ro_head(row, ES) : A;
  const int nw = (A - head) / N;  // words of the body
  const int t0 = head + nw * N;   // first element of the tail
  if (lane < head) acc = fmaf(RoElem<ES>::at(row, lane), aug[lane], acc);
  const unsigned char* body = row + (size_t)head * ES;
  const float* ab = aug + head;
  int c = lane;
  for (; c + (RO_UNROLL - 1) * RO_LANES < nw; c += RO_UNROLL * RO_LANES) {
    RoWord v[RO_UNROLL];
#pragma unroll
    for (int u = 0; u < RO_UNROLL; ++u)
      v[u] = ro_load16(body + (size_t)(c + u * RO_LANES) * 16);
#pragma unroll
    for (int u = 0; u < RO_UNROLL; ++u)
      acc = RoElem<ES>::dot(v[u], ab + (size_t)(c + u * RO_LANES) * N, acc);
  }
  for (; c < nw; c += RO_LANES)
    acc = RoElem<ES>::dot(ro_load16(body + (size_t)c * 16), ab + (size_t)c * N,
                          acc);
  if (lane < A - t0)
    acc = fmaf(RoElem<ES>::at(row, t0 + lane), aug[t0 + lane], acc);
  return acc;
}

// The components form's word: its elements into p (a < S) or m (the
// rest), a0 the index of its first element; a word wholly on one side
// takes dot's path
template <int ES>
RO_HD void ro_dot2(const RoWord& v, const float* aug, int a0, int S,
                   float& p, float& m) {
  constexpr int N = 16 / ES;
  if (a0 >= S) {
    m = RoElem<ES>::dot(v, aug, m);
    return;
  }
  if (a0 + N <= S) {
    p = RoElem<ES>::dot(v, aug, p);
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float t = RoElem<ES>::word_at(v, j);
    if (a0 + j < S)
      p = fmaf(t, aug[j], p);
    else
      m = fmaf(t, aug[j], m);
  }
}

// ro_lane_dot split at S: lane `lane`'s share of the row's sum over a < S
// into p and over a >= S into m, element by element in ro_lane_dot's
// order
template <int ES, bool VEC>
RO_HD void ro_lane_dot2(const unsigned char* row, const float* aug, int A,
                        int S, int lane, float& p, float& m) {
  p = 0.f;
  m = 0.f;
  if (!VEC) {
    for (int a = lane; a < A; a += RO_LANES) {
      const float t = RoElem<ES>::at(row, a);
      if (a < S)
        p = fmaf(t, aug[a], p);
      else
        m = fmaf(t, aug[a], m);
    }
    return;
  }
  constexpr int N = 16 / ES;
  const int head = ro_head(row, ES) < A ? ro_head(row, ES) : A;
  const int nw = (A - head) / N;
  const int t0 = head + nw * N;
  if (lane < head) {
    const float t = RoElem<ES>::at(row, lane);
    if (lane < S)
      p = fmaf(t, aug[lane], p);
    else
      m = fmaf(t, aug[lane], m);
  }
  const unsigned char* body = row + (size_t)head * ES;
  const float* ab = aug + head;
  int c = lane;
  for (; c + (RO_UNROLL - 1) * RO_LANES < nw; c += RO_UNROLL * RO_LANES) {
    RoWord v[RO_UNROLL];
#pragma unroll
    for (int u = 0; u < RO_UNROLL; ++u)
      v[u] = ro_load16(body + (size_t)(c + u * RO_LANES) * 16);
#pragma unroll
    for (int u = 0; u < RO_UNROLL; ++u)
      ro_dot2<ES>(v[u], ab + (size_t)(c + u * RO_LANES) * N,
                  head + (c + u * RO_LANES) * N, S, p, m);
  }
  for (; c < nw; c += RO_LANES)
    ro_dot2<ES>(ro_load16(body + (size_t)c * 16), ab + (size_t)c * N,
                head + c * N, S, p, m);
  if (lane < A - t0) {
    const int a = t0 + lane;
    const float t = RoElem<ES>::at(row, a);
    if (a < S)
      p = fmaf(t, aug[a], p);
    else
      m = fmaf(t, aug[a], m);
  }
}

// out = acc * std + mean, each operation rounded on its own
RO_HD float ro_unstd(float acc, float std, float mean) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(__fmul_rn(acc, std), mean);
#else
  const float p = acc * std;  // built with -ffp-contract=off
  return p + mean;
#endif
}

// Where K2 stores its outputs straight into the assembled grid, K4's
// former work (the JAX package's unpack_core_vector + scatter_core and the
// clamps of HybridAtmosphere.assemble_global): grid is the flat
// [atmo (4, K, lat, lon), logp, precip] and index[k] the element of it
// that the class's output k = r O + o fills (-1: none; the cores tile the
// grid once, so no two outputs share an element); [q0, q1) is the
// humidity block, [p0, p1) the precip block.  grid null: the outputs go
// to the (R, O) vector.
struct RoScatter {
  float* grid;
  const int* index;
  long long q0, q1, p0, p1;
};

// v as grid element e holds it: q = max(q, 1e-6), precip < 1e-5 -> 0;
// the comparisons keep NaN, as the JAX clamps do
RO_HD float ro_clamp(float v, long long e, const RoScatter& sc) {
  if (e >= sc.q0 && e < sc.q1) return v < 1e-6f ? 1e-6f : v;
  if (e >= sc.p0 && e < sc.p1) return v < 1e-5f ? 0.f : v;
  return v;
}

// The store of output k (value v): into the grid where sc has one, else
// out[k]
RO_HD void ro_store(float v, long long k, float* out, const RoScatter& sc) {
  if (!sc.grid) {
    out[k] = v;
    return;
  }
  const long long e = sc.index[k];
  if (e >= 0) sc.grid[e] = ro_clamp(v, e, sc);
}

// Where the components form stores v_p and v_ml (standardized, no
// clamps): with the grid, two flat grids of its layout, at the same
// element (cores tile the grid, so every element is written); without,
// two (R, O) vectors beside out.  Null in the main form.
struct RoParts {
  float* vp;
  float* vml;
};

// The components form's store of output k: v (the main output, stored as
// ro_store does), vp and vml
RO_HD void ro_store_parts(float v, float vp, float vml, long long k,
                          float* out, const RoScatter& sc,
                          const RoParts& pt) {
  ro_store(v, k, out, sc);
  if (!sc.grid) {
    pt.vp[k] = vp;
    pt.vml[k] = vml;
    return;
  }
  const long long e = sc.index[k];
  if (e >= 0) {
    pt.vp[e] = vp;
    pt.vml[e] = vml;
  }
}

// Rows per block on a card of `sms` SMs: all O where R blocks already
// give ~4 per SM, else fewer, a multiple of the warps, so that R * tiles
// reaches that count (the 48-region polar classes: one region's rows over
// several blocks, each storing its own)
RO_HD int ro_tile_rows(int sms, int R, int O) {
  const int want = 4 * sms;
  int tiles = (want + R - 1) / R;
  const int most = (O + RO_WARPS - 1) / RO_WARPS;
  tiles = tiles < 1 ? 1 : (tiles > most ? most : tiles);
  const int rows = (O + tiles - 1) / tiles;
  return (rows + RO_WARPS - 1) / RO_WARPS * RO_WARPS;
}

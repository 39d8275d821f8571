// K14: the Gram update of the ridge trainer.
//
// Replaces (JAX package) speedy_ml_tpu/esn/train.py:130-160 (the
// batch_step body of accumulate_batches) and hybrid/chunked.py:311-333
// (accumulate).  For the C collected states of one time chunk and R
// regions, in place:
//   aug_c  = [model_c (S) ; quad_expand(states_c) (n)]      A = S + n
//   ss[r] += sum_c aug_c^T aug_c                            (A, A)
//   st[r] += sum_c target_c^T aug_c                         (O, A)
// quad_expand squares the odd nodes (0-based): aug index a >= S is node
// a - S.
//
// Bound on an H100 SXM: the larger of the read-modify-write of ss and st,
// R*A*(A+O)*4*2 bytes at 3.35 TB/s (96 interior regions, A = 5,892: 27
// GB, 8.1 ms), and 2*C*R*(A(A+1)/2 + O*A) FFMAs at 67 TFLOP/s (ss is
// symmetric; C = 1,896, R = 8: 8.2 ms).
// Design, two launches:
//  1. gram_panel_kernel writes the panel P (R, C, W) of gram_update.cuh:
//     aug and target of each sample, zero-padded to whole tiles (about 1%
//     of the Gram's bytes at C = 16 to 128), so that the tiles load whole
//     aligned rows with cp.async and no edge tests;
//  2. gram_tile_kernel, one block of 256 threads (GuThread) per (tile,
//     region); GU_STAGES stages of samples in flight by cp.async; a warp
//     owns a (TILE/4 x TILE/2) block of outputs, its lanes 4 x 8, so each
//     fragment load from shared memory is one wavefront.  Each output is
//     summed in sample order with FMA from 0 and added to its old value
//     once, as cuBLAS does for these shapes (0 difference from the plain
//     version on the card).  Two configurations, by the tile list the
//     caller picks (gram_update.py's SYM_MIN_C):
//     - the full list, for short chunks (C = 16: bound by the bytes of
//       ss): 64 x 64 tiles, 4 x 4 outputs a thread, 4 blocks an SM; the
//       tile's old values are copied into shared memory by cp.async
//       before anything else, so that their read overlaps the products,
//       and the epilogue adds and stores;
//     - the symmetric list, for long chunks (bound by FLOPs): 128 x 128
//       tiles, 8 x 8 outputs a thread (4 fragment loads to 64 FFMA); the
//       finished tile, then its transpose, goes through shared memory
//       into ss/st by the bulk reduce-add (cp.reduce.async.bulk .add.f32,
//       one row a thread): L2 adds each element once, rounding old + sum
//       as a plain add does, and no thread waits for the old values.
//     float64 (the checks only) takes 64 x 64 tiles read first for both
//     lists; a width whose rows are not 16-byte aligned, element copies.
// FFMA in the operand type: no tensor cores, no TF32 (the port's
// precision rule).  Indices into ss/st and P are 64-bit.

#include <stddef.h>
#include <stdint.h>

#include "common.cuh"
#include "gram_update.cuh"

#define GU_THREADS 256
#define GU_STAGES 4  // stages of samples in flight

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// one element (4 or 8 bytes)
template <int N>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(N), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// H consecutive values of T in one shared-memory access
template <typename T, int H>
struct GuVec;
template <>
struct GuVec<float, 4> {
  using type = float4;
};
template <>
struct GuVec<float, 2> {
  using type = float2;
};
template <>
struct GuVec<double, 2> {
  using type = double2;
};
template <typename T, int H>
__device__ __forceinline__ void ldv(const T* p, T* v) {
  const typename GuVec<T, H>::type q =
      *reinterpret_cast<const typename GuVec<T, H>::type*>(p);
#pragma unroll
  for (int k = 0; k < H; ++k) v[k] = reinterpret_cast<const T*>(&q)[k];
}
template <typename T, int H>
__device__ __forceinline__ void stv(T* p, const T* v) {
  typename GuVec<T, H>::type q;
#pragma unroll
  for (int k = 0; k < H; ++k) reinterpret_cast<T*>(&q)[k] = v[k];
  *reinterpret_cast<typename GuVec<T, H>::type*>(p) = q;
}

// dst[0 .. bytes/4) += src[...] in L2 (the bulk reduce-add); both 16-byte
// aligned, bytes a multiple of 16
__device__ __forceinline__ void bulk_add_f32(float* dst, const float* src,
                                             int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;" ::"l"(dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  // the shared source may be overwritten once it has been read
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(256)
gram_panel_kernel(const T* __restrict__ states, const T* __restrict__ model,
                  const T* __restrict__ target, int C, int R, int n, int S,
                  int O, int Ap, int W, T* __restrict__ P) {
  const size_t total = (size_t)R * C * W;
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < total;
       k += (size_t)gridDim.x * blockDim.x) {
    const int w = (int)(k % W);
    const size_t rc = k / W;
    P[k] = gu_panel(states, model, target, R, n, S, O, Ap, (int)(rc / C),
                    (int)(rc % C), w);
  }
}

// Copies the nr x nc block at src (row stride ld) into buf (TILE x TILE),
// zeros elsewhere; vec: 16-byte pieces (ld, nc and src aligned to them)
template <typename T, int TILE>
__device__ __forceinline__ void copy_block(T* buf, const T* src, size_t ld,
                                           int nr, int nc, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (int k = threadIdx.x; k < TILE * TILE / V; k += GU_THREADS) {
      const int i = k / (TILE / V), j = k % (TILE / V) * V;
      const bool ok = i < nr && j < nc;
      cp_async16(buf + i * TILE + j, ok ? src + i * ld + j : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int k = threadIdx.x; k < TILE * TILE; k += GU_THREADS) {
      const int i = k / TILE, j = k % TILE;
      const bool ok = i < nr && j < nc;
      cp_async_elem<sizeof(T)>(buf + k, ok ? src + i * ld + j : src,
                               ok ? (int)sizeof(T) : 0);
    }
  }
}

// dst[0..H) = old[0..H) + add[0..H) for the valid ones (nv of them)
template <typename T, int H>
__device__ __forceinline__ void add_store(T* dst, const T* old, const T* add,
                                          int nv, bool vec) {
  T v[H];
#pragma unroll
  for (int q = 0; q < H; ++q) v[q] = old[q] + add[q];
  if (vec && nv >= H) {
    stv<T, H>(dst, v);
  } else {
#pragma unroll
    for (int q = 0; q < H; ++q)
      if (q < nv) dst[q] = v[q];
  }
}

// The work of one thread in a TILE x TILE tile: 256 threads, 8 warps of
// (TILE/4 x TILE/2) outputs, lanes 4 x 8, TM x TM outputs a thread in
// two halves (rows ra.., rb.., columns ca.., cb..).  A stage holds KC
// samples of the left and the right operand, [kk][TILE] each; a thread
// copies one 16-byte piece of each (sample kk0, columns m..).
template <typename T, int TILE>
struct GuThread {
  static constexpr int TM = TILE / 16;
  static constexpr int H = TM / 2;
  static constexpr int V = 16 / sizeof(T);
  static constexpr int KC = GU_THREADS * V / TILE;
  static constexpr int STAGE = 2 * KC * TILE;
  int ra, rb, ca, cb, kk0, m;
  __device__ __forceinline__ GuThread() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    ra = warp / 2 * (TILE / 4) + lane / 8 * H;
    rb = ra + TILE / 8;
    ca = warp % 2 * (TILE / 2) + lane % 8 * H;
    cb = ca + TILE / 4;
    kk0 = threadIdx.x / (TILE / V);
    m = threadIdx.x % (TILE / V) * V;
  }
  // samples c0 .. c0 + KC - 1 of the operand rows at lsrc and rsrc (panel
  // row stride W) into a stage; samples past C stage as 0
  __device__ __forceinline__ void load(T* s, const T* lsrc, const T* rsrc,
                                       int c0, int C, int W) const {
    const int c = c0 + kk0;
    const bool ok = c < C;
    const size_t off = ok ? (size_t)c * W : 0;
    cp_async16(s + kk0 * TILE + m, lsrc + off + m, ok ? 16 : 0);
    cp_async16(s + KC * TILE + kk0 * TILE + m, rsrc + off + m, ok ? 16 : 0);
  }
  // acc += the stage's products, sample by sample in order
  __device__ __forceinline__ void products(const T* s, T (&acc)[TM][TM])
      const {
    const T* ls = s;
    const T* rs = s + KC * TILE;
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      T a[TM], b[TM];
      ldv<T, H>(ls + kk * TILE + ra, a);
      ldv<T, H>(ls + kk * TILE + rb, a + H);
      ldv<T, H>(rs + kk * TILE + ca, b);
      ldv<T, H>(rs + kk * TILE + cb, b + H);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
  }
  // out0[ii, jj] = old_s[ii, jj] + acc for the valid rows and columns
  __device__ __forceinline__ void store(T* out0, const T* old_s,
                                        const T (&acc)[TM][TM], int rows,
                                        int cols, int A, bool vec) const {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int ii = i < H ? ra + i : rb + i - H;
      if (ii >= rows) continue;
      add_store<T, H>(out0 + (size_t)ii * A + ca, old_s + ii * TILE + ca,
                      acc[i], cols - ca, vec);
      add_store<T, H>(out0 + (size_t)ii * A + cb, old_s + ii * TILE + cb,
                      acc[i] + H, cols - cb, vec);
    }
  }
};

// One (tile, region) per block, of the full tile list or (SYM) the
// symmetric one.  bulk: the bulk reduce-add epilogue (float32, vec only)
// instead of the old values read first.
template <typename T, int TILE, int MINB, bool SYM>
__global__ void __launch_bounds__(GU_THREADS, MINB)
gram_tile_kernel(const T* __restrict__ P, int C, int A, int O, int Ap, int W,
                 int vec, int bulk, T* __restrict__ ss, T* __restrict__ st) {
  using Th = GuThread<T, TILE>;
  constexpr int TM = Th::TM, H = Th::H, KC = Th::KC, STAGE = Th::STAGE;
  extern __shared__ float4 smem_raw[];
  T* const stage = reinterpret_cast<T*>(smem_raw);    // [GU_STAGES][STAGE]
  T* const old_s = stage + GU_STAGES * STAGE;         // [TILE][TILE]

  const Th th;
  const GuTile g = gu_decode(blockIdx.x, A, TILE, SYM);
  const int r = blockIdx.y;
  const int rows = gu_rows(g, A, O, TILE), cols = gu_cols(g, A, TILE);
  T* const out0 = (g.kind == GU_SS ? ss : st) + gu_direct(g, r, 0, 0, A, O,
                                                           TILE);
  if (!bulk) copy_block<T, TILE>(old_s, out0, A, rows, cols, vec);
  cp_async_commit();

  const T* const lsrc = P + (size_t)r * C * W + gu_left_col(g, Ap, TILE);
  const T* const rsrc = P + (size_t)r * C * W + gu_right_col(g, TILE);
  const int passes = (C + KC - 1) / KC;
  auto load = [&](int p) {
    if (p < passes)
      th.load(stage + (p % GU_STAGES) * STAGE, lsrc, rsrc, p * KC, C, W);
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < GU_STAGES - 1; ++p) load(p);
  T acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = T(0);
  for (int p = 0; p < passes; ++p) {
    cp_async_wait<GU_STAGES - 2>();
    __syncthreads();
    load(p + GU_STAGES - 1);
    th.products(stage + (p % GU_STAGES) * STAGE, acc);
  }
  cp_async_wait<0>();
  __syncthreads();

  T* const mir0 = ss + gu_mirror(g, r, 0, 0, A, TILE);
  const int ra = th.ra, rb = th.rb, ca = th.ca, cb = th.cb;
  if constexpr (sizeof(T) == 4) {
    if (bulk) {
      // the tile, then its transpose, through old_s into L2's adds
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int ii = i < H ? ra + i : rb + i - H;
        stv<T, H>(old_s + ii * TILE + ca, acc[i]);
        stv<T, H>(old_s + ii * TILE + cb, acc[i] + H);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x < rows)
        bulk_add_f32(out0 + (size_t)threadIdx.x * A,
                     old_s + threadIdx.x * TILE, cols * 4);
      if (!g.mirror) return;
      __syncthreads();
#pragma unroll
      for (int j = 0; j < TM; ++j) {
        const int jj = j < H ? ca + j : cb + j - H;
        T t[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) t[i] = acc[i][j];
        stv<T, H>(old_s + jj * TILE + ra, t);
        stv<T, H>(old_s + jj * TILE + rb, t + H);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (threadIdx.x < cols)
        bulk_add_f32(mir0 + (size_t)threadIdx.x * A,
                     old_s + threadIdx.x * TILE, rows * 4);
      return;
    }
  }
  th.store(out0, old_s, acc, rows, cols, A, vec);
  if (!g.mirror) return;
  // its transpose into ss[J, I]: old_s[jj, ii] = ss[J * TILE + jj, ...]
  __syncthreads();
  copy_block<T, TILE>(old_s, mir0, A, cols, rows, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int jj = j < H ? ca + j : cb + j - H;
    if (jj >= cols) continue;
    T t[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) t[i] = acc[i][j];
    add_store<T, H>(mir0 + (size_t)jj * A + ra, old_s + jj * TILE + ra, t,
                    rows - ra, vec);
    add_store<T, H>(mir0 + (size_t)jj * A + rb, old_s + jj * TILE + rb,
                    t + H, rows - rb, vec);
  }
}

template <typename T, int TILE, int MINB, bool SYM>
static int launch_tiles(const T* panel, int C, int R, int A, int O, int vec,
                        int bulk, T* ss, T* st, cudaStream_t stream) {
  using Th = GuThread<T, TILE>;
  const size_t smem = (GU_STAGES * Th::STAGE + TILE * TILE) * sizeof(T);
  void (*kern)(const T*, int, int, int, int, int, int, int, T*, T*) =
      &gram_tile_kernel<T, TILE, MINB, SYM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(gu_tiles(A, O, TILE, SYM), R);
  kern<<<grid, GU_THREADS, smem, stream>>>(
      panel, C, A, O, gu_panel_aug(A, TILE), gu_panel_width(A, O, TILE), vec,
      bulk, ss, st);
  return (int)cudaGetLastError();
}

// float32: the full tile list (chunks bound by bytes) takes 64-tiles, the
// old values read first; the symmetric list (chunks bound by FLOPs)
// 128-tiles with the bulk reduce-add.  float64: 64-tiles read first.
static int tile_of(int is_double, int sym) {
  return !is_double && sym ? 128 : 64;
}

template <typename T>
static int launch(const void* states, const void* model,
                  const void* target, int C, int R, int n, int S, int O,
                  void* ss, void* st, void* panel, int sym,
                  cudaStream_t stream) {
  const int A = S + n;
  const int tile = tile_of(sizeof(T) == 8, sym);
  const int Ap = gu_panel_aug(A, tile), W = gu_panel_width(A, O, tile);
  const size_t total = (size_t)R * C * W;
  const int pblocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256
                                                        : 8192);
  gram_panel_kernel<T><<<pblocks, 256, 0, stream>>>(
      (const T*)states, (const T*)model, (const T*)target, C, R, n, S, O,
      Ap, W, (T*)panel);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec = (A * sizeof(T)) % 16 == 0 && (uintptr_t)ss % 16 == 0 &&
                  (uintptr_t)st % 16 == 0;
  const T* p = (const T*)panel;
  T* const sp = (T*)ss;
  T* const tp = (T*)st;
  if constexpr (sizeof(T) == 8) {
    if (!sym)
      return launch_tiles<T, 64, 2, false>(p, C, R, A, O, vec, 0, sp, tp,
                                           stream);
    return launch_tiles<T, 64, 2, true>(p, C, R, A, O, vec, 0, sp, tp,
                                        stream);
  } else {
    if (!sym)
      return launch_tiles<T, 64, 4, false>(p, C, R, A, O, vec, 0, sp, tp,
                                           stream);
    return launch_tiles<T, 128, 2, true>(p, C, R, A, O, vec, vec, sp, tp,
                                         stream);
  }
}

// The panel's size in elements for these operands and tile list (the
// caller allocates it, of the operands' type)
SPEEDY_API long long gram_panel_size(int is_double, int sym, int C, int R,
                                     int n, int S, int O) {
  return (long long)R * C * gu_panel_width(S + n, O, tile_of(is_double, sym));
}

// is_double: 1 for float64 operands, 0 for float32.  states (C, R, n),
// model (C, R, S) (null when S == 0), target (C, R, O), ss (R, A, A) and
// st (R, O, A), all contiguous, updated in place; panel: scratch of
// gram_panel_size elements.  sym: 1 for the symmetric tile list, 0 for
// the full one.
SPEEDY_API int gram_update_launch(int device, int is_double,
                                  const void* states, const void* model,
                                  const void* target, int C, int R, int n,
                                  int S, int O, void* ss, void* st,
                                  void* panel, int sym, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || R < 1 || R > 65535 || n < 1 || S < 0 || O < 1 ||
      (S > 0) != (model != nullptr) || sym < 0 || sym > 1 ||
      (uintptr_t)panel % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch<double>(states, model, target, C, R, n, S, O, ss,
                                    st, panel, sym, s)
                   : launch<float>(states, model, target, C, R, n, S, O, ss,
                                   st, panel, sym, s);
}

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
// a - S.  aug is built as the tiles load and never written to device
// memory.
//
// Bound on an H100 SXM: at the trainer's time chunk C = 16 the
// read-modify-write of ss and st, R*A*(A+O)*4*2 bytes (96 interior
// regions, A = 5,892: 27 GB, 8.1 ms at 3.35 TB/s); at C = 1,896 (26
// training years in 20 chunks) the 2*C*R*A*(A+O) FFMAs at 67 TFLOP/s.
// Design (simple first): one block per 64 x 64 output tile of one
// region, the output rows 0..A-1 over ss and A..A+O-1 over st, so one
// launch covers both; 256 threads with 4 x 4 outputs each, strided by 16
// so that a warp's read-modify-write of a row is 64 contiguous bytes, its
// reads issued first; the row and column operands staged GU_KC samples
// at a time in shared memory; the sums kept in registers over all C
// samples in order, then one add into ss/st.  FFMA in the operand type
// (float or double): no tensor cores, no TF32 (the port's precision
// rule); the full matrix, not its upper triangle.  Indices into ss/st
// are 64-bit (R*A*A passes 2^31 from 62 interior regions).

#include <stddef.h>

#include "common.cuh"

#define GU_TILE 64     // output rows and columns per block
#define GU_KC 16       // samples staged per shared-memory pass
#define GU_THREADS 256

// aug[c, r, a] of region r at sample c
template <typename T>
__device__ __forceinline__ T aug_value(const T* __restrict__ states,
                                       const T* __restrict__ model,
                                       size_t row, int a, int S, int n) {
  if (a < S) return model[row * S + a];
  const int k = a - S;
  const T v = states[row * n + k];
  return (k & 1) ? v * v : v;
}

template <typename T>
__global__ void __launch_bounds__(GU_THREADS)
gram_update_kernel(const T* __restrict__ states, const T* __restrict__ model,
                   const T* __restrict__ target, int C, int R, int n, int S,
                   int O, T* __restrict__ ss, T* __restrict__ st) {
  __shared__ T rows_s[GU_KC][GU_TILE];
  __shared__ T cols_s[GU_KC][GU_TILE];
  const int A = S + n;
  const int r = blockIdx.z;
  const int row0 = blockIdx.y * GU_TILE;
  const int col0 = blockIdx.x * GU_TILE;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  // this tile's current ss/st values, read first so that their latency
  // overlaps the staging and the products
  T* dst[4];
  T old[4][4];
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    dst[i] = row < A       ? ss + ((size_t)r * A + row) * A
             : row < A + O ? st + ((size_t)r * O + (row - A)) * A
                           : nullptr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      old[i][j] = (dst[i] != nullptr && col < A) ? dst[i][col] : T(0);
      acc[i][j] = T(0);
    }
  }

  for (int c0 = 0; c0 < C; c0 += GU_KC) {
    // stage samples c0..c0+GU_KC-1: this tile's rows (aug or target) and
    // columns (aug); zeros past C and past the matrix edge
#pragma unroll
    for (int q = 0; q < GU_KC * GU_TILE / GU_THREADS; ++q) {
      const int l = threadIdx.x + q * GU_THREADS;
      const int kk = l / GU_TILE;
      const int m = l % GU_TILE;
      const int c = c0 + kk;
      T rv = T(0), cv = T(0);
      if (c < C) {
        const size_t row = (size_t)c * R + r;
        const int i = row0 + m;
        if (i < A)
          rv = aug_value(states, model, row, i, S, n);
        else if (i < A + O)
          rv = target[row * O + (i - A)];
        const int j = col0 + m;
        if (j < A) cv = aug_value(states, model, row, j, S, n);
      }
      rows_s[kk][m] = rv;
      cols_s[kk][m] = cv;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GU_KC; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = rows_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = cols_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (dst[i] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < A) dst[i][col] = old[i][j] + acc[i][j];
    }
  }
}

template <typename T>
static int launch(const void* states, const void* model, const void* target,
                  int C, int R, int n, int S, int O, void* ss, void* st,
                  cudaStream_t stream) {
  const int A = S + n;
  const dim3 grid((A + GU_TILE - 1) / GU_TILE,
                  (A + O + GU_TILE - 1) / GU_TILE, R);
  gram_update_kernel<T><<<grid, GU_THREADS, 0, stream>>>(
      (const T*)states, (const T*)model, (const T*)target, C, R, n, S, O,
      (T*)ss, (T*)st);
  return (int)cudaGetLastError();
}

// is_double: 1 for float64 operands, 0 for float32.  states (C, R, n),
// model (C, R, S) (null when S == 0), target (C, R, O), ss (R, A, A) and
// st (R, O, A), all contiguous, updated in place.
SPEEDY_API int gram_update_launch(int device, int is_double,
                                  const void* states, const void* model,
                                  const void* target, int C, int R, int n,
                                  int S, int O, void* ss, void* st,
                                  void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (C < 1 || R < 1 || R > 65535 || n < 1 || S < 0 || O < 1 ||
      (S > 0) != (model != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_double
             ? launch<double>(states, model, target, C, R, n, S, O, ss, st, s)
             : launch<float>(states, model, target, C, R, n, S, O, ss, st, s);
}

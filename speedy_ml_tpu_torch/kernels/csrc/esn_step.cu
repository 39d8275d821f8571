// K1: one ESN step for every region of a class.
//
// Replaces (JAX package) speedy_ml_tpu/esn/reservoir.py: esn_step with
// ell_spmv_shift / ell_spmv and BatchedReservoir.win_apply.  Computes
//   y[r,i] = tanh( sum_j vals[j,r,i] * x[r, col_j(r,i)] + win[r,i] * u[r, k(r,i)] )
// then the leakage (1-l) x + l y when l != 1, with
//   col_j = (i + s_j) mod n          shift topology (the main path),
//         = cols[i, j]               shared ELL pattern (n, J),
//         = cols[r, i, j]            per-region ELL pattern (R, n, J);
//   k     = min(i / q, I - 1), q = n / I, or win_cols[r, i] when given.
// jnp.roll(x, -s) reads x[(i + s) mod n], hence the + in col_j.
// With linear != 0 the input term, the tanh and the leakage are dropped:
// y = A x, the power iteration of spectral_radius at build time.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  Per call it moves vals
// (J*R*n*4 B), x, win and y (R*n*4 B each) and u; for the three T30
// classes at m=6000 that is about 240 MB, about 0.07 ms.  It does
// 2*J+4 flops per output, far below the 67 TFLOP/s f32 rate.
// Design: one thread per (r, i).  Neighbouring threads read neighbouring
// i, so every vals/win/y access and the shifted x reads are coalesced
// (the shift only moves the window, and wraps once per row).  A thread
// issues the loads of up to CHUNK slots before it multiplies, so enough
// bytes are in flight to cover the memory latency.  The sum
// follows the JAX order with explicit round-to-nearest multiplies and
// adds (no FMA contraction), so it matches the plain version.

#include "common.cuh"

#define MAX_SHIFTS 32
#define CHUNK 8

struct Shifts {
  int s[MAX_SHIFTS];
};

enum { MODE_SHIFT = 0, MODE_SHARED_COLS = 1, MODE_REGION_COLS = 2 };

template <int MODE, bool LINEAR>
__global__ void esn_step_kernel(const float* __restrict__ vals,
                                const float* __restrict__ x,
                                const float* __restrict__ win,
                                const float* __restrict__ u,
                                const int* __restrict__ cols,
                                const int* __restrict__ win_cols,
                                Shifts shifts, int J, int R, int n, int I,
                                int q, float leak, float one_minus_leak,
                                float* __restrict__ y) {
  const long long total = (long long)R * n;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int r = (int)((unsigned)t / (unsigned)n);  // total < 2^31 (host)
  const int i = (int)t - r * n;
  const float* xr = x + (long long)r * n;

  // slots go in chunks of CHUNK: all loads of a chunk are issued before
  // the first product, so each thread keeps up to 2*CHUNK loads in flight.
  // The loops unroll fully, so shifts.s[j] is a constant index into the
  // parameter space (a dynamic index would copy it to local memory).
  float acc = 0.f;
#pragma unroll
  for (int j0 = 0; j0 < MAX_SHIFTS; j0 += CHUNK) {
    if (j0 >= J) break;
    float v[CHUNK], xv[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const int j = j0 + k;
      if (j < J) {
        int c;
        if (MODE == MODE_SHIFT) {
          c = i + shifts.s[j];
          if (c >= n) c -= n;
        } else if (MODE == MODE_SHARED_COLS) {
          c = cols[(long long)i * J + j];
        } else {
          c = cols[t * J + j];
        }
        v[k] = vals[(long long)j * total + t];
        xv[k] = xr[c];
      }
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      if (j0 + k < J) {
        const float term = __fmul_rn(v[k], xv[k]);
        acc = (j0 + k == 0) ? term : __fadd_rn(acc, term);
      }
    }
  }
  if (!LINEAR) {
    const int k = win_cols ? win_cols[t] : min(i / q, I - 1);
    acc = __fadd_rn(acc, __fmul_rn(win[t], u[(long long)r * I + k]));
    float xt = tanhf(acc);
    if (leak != 1.f)
      xt = __fadd_rn(__fmul_rn(one_minus_leak, xr[i]), __fmul_rn(leak, xt));
    acc = xt;
  }
  y[t] = acc;
}

template <int MODE>
static void launch_mode(bool linear, dim3 grid, dim3 block, cudaStream_t st,
                        const float* vals, const float* x, const float* win,
                        const float* u, const int* cols, const int* win_cols,
                        const Shifts& sh, int J, int R, int n, int I, int q,
                        float leak, float oml, float* y) {
  if (linear)
    esn_step_kernel<MODE, true><<<grid, block, 0, st>>>(
        vals, x, win, u, cols, win_cols, sh, J, R, n, I, q, leak, oml, y);
  else
    esn_step_kernel<MODE, false><<<grid, block, 0, st>>>(
        vals, x, win, u, cols, win_cols, sh, J, R, n, I, q, leak, oml, y);
}

// mode: 0 shift (shifts[J] host array), 1 shared cols (n, J),
// 2 per-region cols (R, n, J).  win/u/win_cols may be null when linear.
SPEEDY_API int esn_step_launch(int device, int mode, int linear,
                               const void* vals, const void* x,
                               const void* win, const void* u,
                               const void* cols, const void* win_cols,
                               const int* shifts, int J, int R, int n, int I,
                               float leak, float one_minus_leak, void* y,
                               void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (J < 1 || J > MAX_SHIFTS) return (int)cudaErrorInvalidValue;
  Shifts sh = {};
  if (mode == MODE_SHIFT)
    for (int j = 0; j < J; ++j) sh.s[j] = shifts[j];
  const int q = (!linear && I > 0) ? n / I : 1;
  const long long total = (long long)R * n;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 block(256);
  const dim3 grid((unsigned)((total + block.x - 1) / block.x));
  cudaStream_t st = (cudaStream_t)stream;
  const float* fv = (const float*)vals;
  const float* fx = (const float*)x;
  const float* fw = (const float*)win;
  const float* fu = (const float*)u;
  const int* ic = (const int*)cols;
  const int* iw = (const int*)win_cols;
  float* fy = (float*)y;
  switch (mode) {
    case MODE_SHIFT:
      launch_mode<MODE_SHIFT>(linear, grid, block, st, fv, fx, fw, fu, ic,
                              iw, sh, J, R, n, I, q, leak, one_minus_leak, fy);
      break;
    case MODE_SHARED_COLS:
      launch_mode<MODE_SHARED_COLS>(linear, grid, block, st, fv, fx, fw, fu,
                                    ic, iw, sh, J, R, n, I, q, leak,
                                    one_minus_leak, fy);
      break;
    case MODE_REGION_COLS:
      launch_mode<MODE_REGION_COLS>(linear, grid, block, st, fv, fx, fw, fu,
                                    ic, iw, sh, J, R, n, I, q, leak,
                                    one_minus_leak, fy);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

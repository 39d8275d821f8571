// K26: the cgrate limiter and the leapfrog of vor and div (the arithmetic:
// cgrate.cuh, which says what is computed).  With cgrate_on, every dycore
// step launches K8 in its tendency form (vor's and div's diffused
// tendencies in level 0 of their outputs, no leapfrog for them) and then
// this kernel once, which writes both levels of both fields over them.
//
// Replaces (JAX package) speedy_ml_tpu/dycore/model.py:565-585
// (_cgrate, called at :540-542) and :446 (_timint) for vor and div, fused
// by XLA into the step.  In/out at T30L8 (float32): reads the two fields'
// two leapfrog levels and tendencies (3 x 2 x 63 KB) and the (31, 32)
// tables, writes 2 x 127 KB.
//
// Bound on an H100 SXM: memory, 0.64 MB, 0.0002 ms at 3.35 TB/s; the work
// (~0.2 MFLOP) is nothing: a launch floor, and one block a field runs the
// sums serially.  Design: the first, simple one; a block a field; phase 1
// a thread a row (k, m) sums over n, phase 2 a thread a level sums the
// rows and forms its candidate, phase 3 one thread takes the largest,
// phase 4 the block's threads over the field's elements (the plain
// version's order throughout, so that the result is bit-identical).

#include "common.cuh"
#include "cgrate.cuh"

constexpr int kCgBlock = 256;

template <typename T>
struct CgIO {
  const T *f[2], *fj[2], *elm2, *trfilt;
  T* o[2];   // (2, K, mx, nx) complex: level 0 holds the tendency on entry
  int K, mx, nx, trunc;
  T dt, ew1, ew2, grmax;
};

template <typename T>
__global__ void __launch_bounds__(kCgBlock) cgrate_kernel(const CgIO<T> io) {
  extern __shared__ unsigned char cg_smem[];
  T* rg = (T*)cg_smem;                 // (K, mx) row sums of grate
  T* rr = rg + io.K * io.mx;           // (K, mx) row sums of rnorm
  T* cand = rr + io.K * io.mx;         // (K,)
  const int fld = blockIdx.x, K = io.K, mx = io.mx, nx = io.nx;
  const T* f = io.f[fld];
  const T* fdt = io.o[fld];
  for (int r = threadIdx.x; r < K * mx; r += kCgBlock)
    cgrate_row(f, fdt, io.elm2, mx, nx, r / mx, r % mx, rg + r, rr + r);
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kCgBlock)
    cand[k] = cgrate_level(rg + k * mx, rr + k * mx, mx, k, io.grmax);
  __syncthreads();
  // every thread takes the same largest candidate
  const T cd = cgrate_cd(cand, K);
  const long long n = 2LL * K * mx * nx;
  T* o1 = io.o[fld];
  T* o2 = o1 + n;
  for (long long e = threadIdx.x; e < n; e += kCgBlock)
    cgrate_step_at(f, io.fj[fld], fdt, io.trfilt, mx, nx, cd, io.trunc, io.dt,
                   io.ew1, io.ew2, o1, o2, e);
}

template <typename T>
static int launch(const void* const* f, const void* const* fj,
                  const void* elm2, const void* trfilt, void* const* o, int K,
                  int mx, int nx, int trunc, double dt, double ew1,
                  double ew2, double grmax, cudaStream_t s) {
  CgIO<T> io;
  for (int i = 0; i < 2; ++i) {
    io.f[i] = (const T*)f[i];
    io.fj[i] = (const T*)fj[i];
    io.o[i] = (T*)o[i];
  }
  io.elm2 = (const T*)elm2;
  io.trfilt = (const T*)trfilt;
  io.K = K;
  io.mx = mx;
  io.nx = nx;
  io.trunc = trunc;
  io.dt = (T)dt;
  io.ew1 = (T)ew1;
  io.ew2 = (T)ew2;
  io.grmax = (T)grmax;
  const size_t smem = (2 * (size_t)K * mx + K) * sizeof(T);
  cgrate_kernel<T><<<2, kCgBlock, smem, s>>>(io);
  return (int)cudaGetLastError();
}

// f[2]: level 0 of vor and div (K, mx, nx) complex; fj[2]: their level
// j1 - 1; o[2]: their outputs (2, K, mx, nx), level 0 holding the
// diffused tendency (K8's tendency form), both levels written; elm2,
// trfilt (mx, nx) real.  All of the element type (is_double: double, else
// float).  Python numbers dt, ew1 = wil eps, ew2 = (1 - wil) eps and grmax
// are cast to the type.
SPEEDY_API int cgrate_launch(int device, int is_double, int K, int mx,
                             int nx, const void* const* f,
                             const void* const* fj, const void* elm2,
                             const void* trfilt, void* const* o, int trunc,
                             double dt, double ew1, double ew2, double grmax,
                             void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || mx < 1 || nx < 1 || !f || !fj || !o || !elm2 || !trfilt)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 2; ++i)
    if (!f[i] || !fj[i] || !o[i]) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_double
             ? launch<double>(f, fj, elm2, trfilt, o, K, mx, nx, trunc, dt,
                              ew1, ew2, grmax, s)
             : launch<float>(f, fj, elm2, trfilt, o, K, mx, nx, trunc, dt,
                             ew1, ew2, grmax, s);
}

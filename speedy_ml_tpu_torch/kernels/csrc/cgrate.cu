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

// the kernel's forms: the whole field, the rows of an m range, the step of
// an m range from the gathered rows
enum { kCgWhole = 0, kCgRows = 1, kCgRange = 2 };

template <typename T>
struct CgIO {
  const T *f[2], *fj[2], *elm2, *trfilt;
  T* o[2];   // (2, K, mr, nx) complex: level 0 holds the tendency on entry
  T* rows;   // rows form: (2, 2, K, mr) out; range form: (2, 2, K, mx) in
  int K, mx, mr, nx, m0, trunc;
  T dt, ew1, ew2, grmax;
};

template <typename T, int FORM>
__global__ void __launch_bounds__(kCgBlock) cgrate_kernel(const CgIO<T> io) {
  extern __shared__ unsigned char cg_smem[];
  const int fld = blockIdx.x, K = io.K, mx = io.mx, mr = io.mr, nx = io.nx;
  const T* f = io.f[fld];
  const T* fdt = io.o[fld];
  if (FORM == kCgRows) {
    T* rg = io.rows + (long long)(2 * fld) * K * mr;
    T* rr = rg + (long long)K * mr;
    for (int r = threadIdx.x; r < K * mr; r += kCgBlock)
      cgrate_row(f, fdt, io.elm2, mr, nx, io.m0, r / mr, r % mr, rg + r,
                 rr + r);
    return;
  }
  T* rg = (T*)cg_smem;                 // (K, mx) row sums of grate
  T* rr = rg + K * mx;                 // (K, mx) row sums of rnorm
  T* cand = rr + K * mx;               // (K,)
  if (FORM == kCgWhole) {
    for (int r = threadIdx.x; r < K * mx; r += kCgBlock)
      cgrate_row(f, fdt, io.elm2, mx, nx, 0, r / mx, r % mx, rg + r, rr + r);
  } else {
    const T* g = io.rows + (long long)(2 * fld) * K * mx;
    for (int r = threadIdx.x; r < K * mx; r += kCgBlock) {
      rg[r] = g[r];
      rr[r] = g[(long long)K * mx + r];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kCgBlock)
    cand[k] = cgrate_level(rg + k * mx, rr + k * mx, mx, k, io.grmax);
  __syncthreads();
  // every thread takes the same largest candidate
  const T cd = cgrate_cd(cand, K);
  const long long n = 2LL * K * mr * nx;
  T* o1 = io.o[fld];
  T* o2 = o1 + n;
  for (long long e = threadIdx.x; e < n; e += kCgBlock)
    cgrate_step_at(f, io.fj[fld], fdt, io.trfilt, mr, nx, io.m0, cd,
                   io.trunc, io.dt, io.ew1, io.ew2, o1, o2, e);
}

template <typename T>
static int launch(int form, const void* const* f, const void* const* fj,
                  const void* elm2, const void* trfilt, void* const* o,
                  void* rows, int K, int mx, int mr, int nx, int m0,
                  int trunc, double dt, double ew1, double ew2, double grmax,
                  cudaStream_t s) {
  CgIO<T> io;
  for (int i = 0; i < 2; ++i) {
    io.f[i] = (const T*)f[i];
    io.fj[i] = fj ? (const T*)fj[i] : nullptr;
    io.o[i] = (T*)o[i];
  }
  io.elm2 = (const T*)elm2;
  io.trfilt = (const T*)trfilt;
  io.rows = (T*)rows;
  io.K = K;
  io.mx = mx;
  io.mr = mr;
  io.nx = nx;
  io.m0 = m0;
  io.trunc = trunc;
  io.dt = (T)dt;
  io.ew1 = (T)ew1;
  io.ew2 = (T)ew2;
  io.grmax = (T)grmax;
  const size_t smem = (2 * (size_t)K * mx + K) * sizeof(T);
  if (form == kCgWhole)
    cgrate_kernel<T, kCgWhole><<<2, kCgBlock, smem, s>>>(io);
  else if (form == kCgRows)
    cgrate_kernel<T, kCgRows><<<2, kCgBlock, 0, s>>>(io);
  else
    cgrate_kernel<T, kCgRange><<<2, kCgBlock, smem, s>>>(io);
  return (int)cudaGetLastError();
}

static int launch_any(int device, int is_double, int form,
                      const void* const* f, const void* const* fj,
                      const void* elm2, const void* trfilt, void* const* o,
                      void* rows, int K, int mx, int mr, int nx, int m0,
                      int trunc, double dt, double ew1, double ew2,
                      double grmax, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || mx < 1 || mr < 1 || nx < 1 || m0 < 0 || !f || !o)
    return (int)cudaErrorInvalidValue;
  const bool step = form != kCgRows;
  if ((form != kCgWhole && !rows) || (step && (!fj || !trfilt)) ||
      (form != kCgRange && !elm2))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 2; ++i)
    if (!f[i] || !o[i] || (step && !fj[i])) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_double
             ? launch<double>(form, f, fj, elm2, trfilt, o, rows, K, mx, mr,
                              nx, m0, trunc, dt, ew1, ew2, grmax, s)
             : launch<float>(form, f, fj, elm2, trfilt, o, rows, K, mx, mr,
                             nx, m0, trunc, dt, ew1, ew2, grmax, s);
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
  return launch_any(device, is_double, kCgWhole, f, fj, elm2, trfilt, o,
                    nullptr, K, mx, mx, nx, 0, trunc, dt, ew1, ew2, grmax,
                    stream);
}

// The rows form on the m range m0 .. m0 + mr - 1: f[2] and o[2] as
// cgrate_launch's on the range (o's level 0 read only), elm2 (mr, nx);
// rows (2, 2, K, mr) written: per field the sums over n of grate's and
// rnorm's products.
SPEEDY_API int cgrate_rows_launch(int device, int is_double, int K, int mr,
                                  int nx, int m0, const void* const* f,
                                  void* const* o, const void* elm2,
                                  void* rows, void* stream) {
  return launch_any(device, is_double, kCgRows, f, nullptr, elm2, nullptr,
                    o, rows, K, mr, mr, nx, m0, 0, 0.0, 0.0, 0.0, 0.0,
                    stream);
}

// The range form: rows (2, 2, K, mx) the gathered row sums of every
// shard in m order; f, fj, o and trfilt (mr, nx) as cgrate_launch's on the
// range m0 .. m0 + mr - 1.
SPEEDY_API int cgrate_range_launch(int device, int is_double, int K, int mx,
                                   int mr, int nx, int m0,
                                   const void* const* f,
                                   const void* const* fj, const void* rows,
                                   const void* trfilt, void* const* o,
                                   int trunc, double dt, double ew1,
                                   double ew2, double grmax, void* stream) {
  return launch_any(device, is_double, kCgRange, f, fj, nullptr, trfilt, o,
                    (void*)rows, K, mx, mr, nx, m0, trunc, dt, ew1, ew2,
                    grmax, stream);
}

// K26: the cgrate limiter and the leapfrog of vor and div (the arithmetic
// and the layout: cgrate.cuh, which says what is computed).  With
// cgrate_on, every dycore step launches K8 in its tendency form (vor's
// and div's diffused tendencies in level 0 of their outputs, no leapfrog
// for them) and then this kernel once, which writes both levels of both
// fields over them.
//
// Replaces (JAX package) speedy_ml_tpu/dycore/model.py:565-585
// (_cgrate, called at :540-542) and :446 (_timint) for vor and div, fused
// by XLA into the step.  In/out at T30L8 (float32): reads the two fields'
// two leapfrog levels and tendencies (3 x 2 x 63 KB) and the (31, 32)
// tables, writes 2 x 127 KB.
//
// Bound on an H100 SXM: memory, 0.64 MB, 0.0002 ms at 3.35 TB/s; the work
// (~0.2 MFLOP) is nothing: a launch floor.  What holds it is the order of
// the sums (bit for bit the plain version): 32 dependent adds a row, 31 a
// level.  Design: a cluster of kCgCluster (8) blocks a field, 16 blocks
// at all; rank r holds the levels r, r + 8, ... (at T30L8 one level a
// block).  (1) The block stages its levels' f and fdt and elm2 in shared
// memory with 16-byte loads, rows padded by one element so that the
// threads of a warp, a row each, fall on 32 banks; (2) a thread a row m
// sums over n (cgrate_row); (3) after the cluster barrier's wait, each
// level's candidate (cgrate_level, from m = 0) goes into the candidate
// array of every block of the cluster (distributed shared memory); (4)
// cluster.sync(); every block takes cd = cgrate_cd of the K candidates,
// the same in every block, and (5) writes both new levels of its own
// levels' elements, f and fdt read from shared memory (32-bit indices
// within a level: 64-bit divisions cost more than the step's arithmetic).
//
// The in-place hazard: on entry the tendency fdt is level 0 of the output
// that (5) overwrites.  A block reads the fdt of its own levels only, all
// of it into shared memory before the barrier, and writes only its own
// levels; the other blocks' candidates reach it only through the cluster
// barrier.  A design in which blocks summed levels that other blocks
// write (every block summing every level, with no barrier between the
// sums and the writes) would read tendencies already overwritten.
//
// On a mesh the kernel runs in two more forms (cgrate.cuh): the rows
// form, a block a (field, level) with the same staging, writes the shard's
// row sums (2, 2, K, mr); the range form, a block a (field, level) with no
// cluster, takes the K candidates from the gathered rows (2, 2, K, mx), a
// thread a level, and steps its level of the shard's m range from device
// memory.  No block of the range form writes what another reads (the
// gathered rows are an input), so it needs no barrier across blocks.

#include <cooperative_groups.h>

#include "common.cuh"
#include "cgrate.cuh"

namespace cg = cooperative_groups;

constexpr int kCgThreads = 256;

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

// Field fld's entry of a pair, chosen without indexing the kernel's
// argument by a register (which would copy the arrays to the stack).
template <typename P>
static __device__ __forceinline__ P cg_pick(const P (&a)[2], int fld) {
  return fld ? a[1] : a[0];
}

// The whole form: a cluster a field (blockIdx.x / kCgCluster).
template <typename T>
__global__ void __cluster_dims__(kCgCluster, 1, 1)
    __launch_bounds__(kCgThreads)
    cgrate_kernel(const CgIO<T> io) {
  extern __shared__ __align__(16) unsigned char cg_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), fld = blockIdx.x / kCgCluster;
  const int K = io.K, mx = io.mx, nx = io.nx;
  const int nl = cg_nlev(K, r), FS = cg_fstride(nx), ES = cg_estride(nx);
  const CgSmem<T> sm = cg_smem((T*)cg_raw, K, mx, nx, true);
  const long long lvl = 2LL * mx * nx;   // reals a level
  const T* f = cg_pick(io.f, fld);
  const T* fj = cg_pick(io.fj, fld);
  T* o1 = cg_pick(io.o, fld);
  speedy_cluster_arrive_relaxed();
  for (int l = 0; l < nl; ++l) {
    const long long k = r + l * kCgCluster;
    speedy_stage_rows(sm.f + l * mx * FS, FS, f + k * lvl, mx, 2 * nx);
    speedy_stage_rows(sm.d + l * mx * FS, FS, o1 + k * lvl, mx, 2 * nx);
  }
  if (nl) speedy_stage_rows(sm.e, ES, io.elm2, mx, nx);
  __syncthreads();
  for (int i = threadIdx.x; i < nl * mx; i += kCgThreads) {
    const int m = i % mx;
    cgrate_row(sm.f + i * FS, sm.d + i * FS, sm.e + m * ES, nx,
               cgrate_mask<T>(m), sm.rg + i, sm.rr + i);
  }
  __syncthreads();
  speedy_cluster_wait();
  // the candidates of the block's levels into every block's array
  for (int i = threadIdx.x; i < nl * kCgCluster; i += kCgThreads) {
    const int l = i / kCgCluster, dst = i % kCgCluster;
    const int k = r + l * kCgCluster;
    cluster.map_shared_rank(sm.cand, dst)[k] =
        cgrate_level(sm.rg + l * mx, sm.rr + l * mx, mx, k, io.grmax);
  }
  cluster.sync();
  const T cd = cgrate_cd(sm.cand, K);
  for (int l = 0; l < nl; ++l) {
    // level k's elements (int indices: a level holds 2 mx nx reals)
    const long long at = (r + (long long)l * kCgCluster) * lvl;
    const T* fjk = fj + at;
    T* o1k = o1 + at;
    T* o2k = o1k + K * lvl;
    for (int e = threadIdx.x; e < (int)lvl; e += kCgThreads) {
      const int mn = e >> 1, m = mn / nx;
      const int s = (l * mx + m) * FS + (e - 2 * m * nx);
      T n1, n2;
      cgrate_step(sm.f[s], fjk[e], sm.d[s], io.trfilt[mn], cgrate_mask<T>(m),
                  cd, io.trunc, io.dt, io.ew1, io.ew2, &n1, &n2);
      o1k[e] = n1;
      o2k[e] = n2;
    }
  }
}

// The range form: a block a (field, level) (blockIdx.x = fld K + k), no
// cluster; its shared memory the K candidates, a thread a level from the
// gathered rows, then the step of level k of the shard's m range.
template <typename T>
__global__ void __launch_bounds__(kCgThreads)
    cgrate_range_kernel(const CgIO<T> io) {
  extern __shared__ __align__(16) unsigned char cg_raw[];
  T* cand = (T*)cg_raw;
  const int K = io.K, mx = io.mx, nx = io.nx;
  const int fld = blockIdx.x / K, k = blockIdx.x % K;
  const T* g = io.rows + (long long)2 * fld * K * mx;
  for (int i = threadIdx.x; i < K; i += kCgThreads)
    cand[i] = cgrate_level(g + (long long)i * mx, g + (long long)(K + i) * mx,
                           mx, i, io.grmax);
  __syncthreads();
  const T cd = cgrate_cd(cand, K);
  const long long lvl = 2LL * io.mr * nx, at = k * lvl;
  const T* fk = cg_pick(io.f, fld) + at;
  const T* fjk = cg_pick(io.fj, fld) + at;
  T* o1k = cg_pick(io.o, fld) + at;
  T* o2k = o1k + K * lvl;
  for (int e = threadIdx.x; e < (int)lvl; e += kCgThreads) {
    const int mn = e >> 1, m = mn / nx;
    T n1, n2;
    cgrate_step(fk[e], fjk[e], o1k[e], io.trfilt[mn],
                cgrate_mask<T>(io.m0 + m), cd, io.trunc, io.dt, io.ew1,
                io.ew2, &n1, &n2);
    o1k[e] = n1;
    o2k[e] = n2;
  }
}

// The rows form: a block a (field, level) (blockIdx.x = fld K + k); the
// shared memory of cg_smem for one level of mr rows.
template <typename T>
__global__ void __launch_bounds__(kCgThreads)
    cgrate_rows_kernel(const CgIO<T> io) {
  extern __shared__ __align__(16) unsigned char cg_raw[];
  const int K = io.K, mr = io.mr, nx = io.nx;
  const int fld = blockIdx.x / K, k = blockIdx.x % K;
  const int FS = cg_fstride(nx), ES = cg_estride(nx);
  const CgSmem<T> sm = cg_smem((T*)cg_raw, 1, mr, nx, true);
  const long long lvl = 2LL * mr * nx;
  speedy_stage_rows(sm.f, FS, cg_pick(io.f, fld) + k * lvl, mr, 2 * nx);
  speedy_stage_rows(sm.d, FS, cg_pick(io.o, fld) + k * lvl, mr, 2 * nx);
  speedy_stage_rows(sm.e, ES, io.elm2, mr, nx);
  __syncthreads();
  T* rg = io.rows + ((long long)2 * fld * K + k) * mr;
  for (int m = threadIdx.x; m < mr; m += kCgThreads)
    cgrate_row(sm.f + m * FS, sm.d + m * FS, sm.e + m * ES, nx,
               cgrate_mask<T>(io.m0 + m), rg + m, rg + (long long)K * mr + m);
}

// An empty kernel of the whole form's shape: the floor of its launch.
__global__ void __cluster_dims__(kCgCluster, 1, 1)
    __launch_bounds__(kCgThreads)
    cgrate_floor_kernel() {}

template <typename T>
static size_t smem_bytes(int form, int K, int mx, int mr, int nx) {
  return form == kCgRows
             ? (size_t)cg_smem_count(1, mr, nx, true) * sizeof(T)
             : (size_t)cg_smem_count(K, mx, nx, form == kCgWhole) * sizeof(T);
}

// kernel<<<grid, kCgThreads, smem>>>(io) after raising the kernel's
// dynamic shared memory limit where smem is above the default 48 KB.
template <typename T>
static cudaError_t go(void (*kernel)(const CgIO<T>), int grid, size_t smem,
                      cudaStream_t s, const CgIO<T>& io) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kCgThreads, smem, s>>>(io);
  return cudaGetLastError();
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
  const size_t smem = smem_bytes<T>(form, K, mx, mr, nx);
  if (form == kCgWhole)
    return (int)go<T>(cgrate_kernel<T>, 2 * kCgCluster, smem, s, io);
  if (form == kCgRows)
    return (int)go<T>(cgrate_rows_kernel<T>, 2 * K, smem, s, io);
  return (int)go<T>(cgrate_range_kernel<T>, 2 * K, smem, s, io);
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

// The empty kernel with cgrate_launch's grid, block, cluster and shared
// memory for (K, mx, nx): the launch floor a K26 time is read against
// (chip_smoke.py).  It computes nothing and is on no path.
SPEEDY_API int cgrate_floor_launch(int device, int is_double, int K, int mx,
                                   int nx, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = is_double ? smem_bytes<double>(kCgWhole, K, mx, mx, nx)
                                : smem_bytes<float>(kCgWhole, K, mx, mx, nx);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cgrate_floor_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cgrate_floor_kernel<<<2 * kCgCluster, kCgThreads, smem,
                        (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

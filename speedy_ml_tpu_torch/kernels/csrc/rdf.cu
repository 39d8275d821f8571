// K25: random diabatic forcing (the arithmetic and the chunks: rdf.cuh,
// which says what is computed).  With randfh set, every physics step
// launches it once, after its last column kernel: on a shortwave step it
// forms the new randfv (xs_rdf of the step's heating) and adds setrdf to
// the temperature tendency; on the other steps it adds setrdf of the
// carried randfv.
//
// Replaces (JAX package) speedy_ml_tpu/physics/randfor.py:83-110 and
// physics/driver.py:277-288, fused by XLA into the physics step.
// In/out at T30L8 (float32): the add reads two (48, 96) patterns and
// randfv and reads and writes the (8, 48, 96) tendency (0.33 MB); a
// shortwave step also reads three (8, 48, 96) heating fields and rps
// (0.46 MB) and writes randfv (3 KB).
//
// Bound on an H100 SXM: memory, 0.33 MB (0.0001 ms at 3.35 TB/s) or 0.80
// MB (0.00024 ms) on a shortwave step: launch floors.  What holds the
// shortwave form is the order of the zonal sums (bit for bit the plain
// version): 96 dependent adds a row.  Design, the shortwave form: a
// cluster of kRdfCluster (8) blocks a level, a chunk of latitude rows a
// block (rdf.cuh).  (1) The block stages its rows of tt_m and of the
// heating (rdf_heat of tt_rsw, dfabs and rps, read with 16-byte loads) in
// shared memory, rows padded by one element; (2) after the cluster
// barrier's wait, a thread a (mode, row) sums the row from longitude 0
// and writes the weighted sum into the latitude profile of every block of
// the cluster (distributed shared memory); (3) cluster.sync(); every
// block runs the two smoothing passes over the whole 2 x nlat profile,
// the same in every block, and rank 0 writes column k of randfv; (4) each
// block adds the forcing to its own rows.  A block reads and writes only
// its own rows of the level, so tt may be tt_m itself.
//
// The other form has no sums: a block a (level, chunk), no cluster,
// reading column k of randfv at its rows' latitudes and adding.
//
// On a mesh (a shard holding a latitude band, rdf.cuh) two more entry
// points run around an all-gather of the bands' sums: rdf_sums_launch, a
// block a (level, chunk of the band's rows) with the shortwave form's
// staging, writes the band's weighted zonal sums (2, K, rows);
// rdf_band_launch is the other form's layout on the band's rows, each
// block with the gathered (2, K, nlat) sums smoothing its level's whole
// profile as the shortwave form does (the first chunk writing the new
// randfv's column), or with none reading the carried randfv.

#include <cooperative_groups.h>

#include "common.cuh"
#include "rdf.cuh"

namespace cg = cooperative_groups;

constexpr int kRdfThreads = 128;

template <typename T>
struct RdfIO {
  T* tt;                      // (K, rows, nlon) in place
  const T *h, *v_in;          // (2, rows, nlon), (2, nlat, K)
  const T *ttm, *tt_rsw, *dfabs, *rps, *grdscp, *w;  // shortwave step
  const T* sums;              // (2, K, nlat) gathered band sums, or null
  T* v_out;                   // (2, nlat, K): sums out (rdf_sums_launch:
                              // (2, K, rows)), or the new randfv
  int K, nlat, nlon, p0, nb;  // the band: pairs p0 .. p0 + nb - 1
  int rows;                   // the latitude rows tt and the heating hold
};

// Rows [r0, r0 + n) of level k (of `rows`) into shared memory: x0 tt_m,
// x1 the heating, rows rdf_stride(nlon) apart.
template <typename T>
static __device__ __forceinline__ void rdf_stage(const RdfIO<T>& io, int k,
                                                 int rows, int r0, int n,
                                                 T* x0, T* x1) {
  using V = Speedy16<T>;
  const int nlon = io.nlon, S = rdf_stride(nlon);
  const long long at = ((long long)k * rows + r0) * nlon;
  speedy_stage_rows(x0, S, io.ttm + at, n, nlon);
  const T* a = io.tt_rsw + at;
  const T* b = io.dfabs + at;
  const T* p = io.rps + (long long)r0 * nlon;
  const T gs = io.grdscp[k];
  if (speedy_vec_ok(a, nlon) && speedy_vec_ok(b, nlon) &&
      speedy_vec_ok(p, nlon)) {
    using W = typename V::type;
    for (int i = threadIdx.x; i < n * nlon / V::n; i += blockDim.x) {
      const W va = reinterpret_cast<const W*>(a)[i];
      const W vb = reinterpret_cast<const W*>(b)[i];
      const W vp = reinterpret_cast<const W*>(p)[i];
      const int r = i * V::n / nlon, c = i * V::n % nlon;
      for (int j = 0; j < V::n; ++j)
        x1[r * S + c + j] = rdf_heat(V::at(va, j), V::at(vb, j),
                                     V::at(vp, j), gs);
    }
  } else {
    for (int i = threadIdx.x; i < n * nlon; i += blockDim.x)
      x1[(i / nlon) * S + i % nlon] = rdf_heat(a[i], b[i], p[i], gs);
  }
}

// The two smoothing passes over the profile v (2 x nlat), s scratch of the
// same size; the result in v.
template <typename T>
static __device__ __forceinline__ void rdf_smooth(T* v, T* s, int nlat) {
  for (int j = threadIdx.x; j < 2 * nlat; j += blockDim.x)
    s[j] = rdf_smooth_at(v + (j / nlat) * nlat, nlat, j % nlat);
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * nlat; j += blockDim.x)
    v[j] = rdf_smooth_at(s + (j / nlat) * nlat, nlat, j % nlat);
  __syncthreads();
}

// The profile v (2 x nlat) into column k of randfv (2, nlat, K).
template <typename T>
static __device__ __forceinline__ void rdf_write_v(const RdfIO<T>& io,
                                                   int k, const T* v) {
  for (int j = threadIdx.x; j < 2 * io.nlat; j += blockDim.x)
    io.v_out[((long long)(j / io.nlat) * io.nlat + j % io.nlat) * io.K + k] =
        v[j];
}

// The forcing added to rows [r0, r0 + n) of level k (of the band's rows),
// row r reading the profiles v at latitude rdf_band_lat(r).
template <typename T>
static __device__ __forceinline__ void rdf_add_rows(const RdfIO<T>& io,
                                                    int k, int r0, int n,
                                                    const T* v) {
  const int nlon = io.nlon, rows = io.rows;
  for (int p = threadIdx.x; p < n * nlon; p += blockDim.x) {
    const int r = r0 + p / nlon;
    rdf_add_at(io.h, v, v + io.nlat, io.tt, k, rows, nlon, r, p % nlon,
               rdf_band_lat(r, io.p0, io.nb, io.nlat));
  }
}

// The shortwave form on the whole grid: a cluster a level (blockIdx.x /
// kRdfCluster), rank c the chunk c of its nlat rows.
template <typename T>
__global__ void __cluster_dims__(kRdfCluster, 1, 1)
    __launch_bounds__(kRdfThreads)
    rdf_cluster_kernel(const RdfIO<T> io) {
  extern __shared__ __align__(16) unsigned char rdf_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank(), k = blockIdx.x / kRdfCluster;
  const int nlat = io.nlat, nlon = io.nlon, S = rdf_stride(nlon);
  const int rc = rdf_chunk_rows(nlat);
  T* v = (T*)rdf_raw;                 // the profiles v0, v1 (2 x nlat)
  T* s = v + 2 * nlat;                // scratch (2 x nlat)
  T* x0 = s + 2 * nlat;               // tt_m rows (rc x S)
  T* x1 = x0 + rc * S;                // heating rows (rc x S)
  int r0, n;
  rdf_chunk(nlat, c, &r0, &n);
  speedy_cluster_arrive_relaxed();
  rdf_stage(io, k, nlat, r0, n, x0, x1);
  __syncthreads();
  speedy_cluster_wait();
  for (int i = threadIdx.x; i < 2 * n; i += kRdfThreads) {
    const int mode = i / n, r = i % n;
    const T val = rdf_row_sum((mode ? x1 : x0) + r * S, nlon,
                              io.w[mode * io.K + k]);
    for (int dst = 0; dst < kRdfCluster; ++dst)
      cluster.map_shared_rank(v, dst)[mode * nlat + r0 + r] = val;
  }
  cluster.sync();
  rdf_smooth(v, s, nlat);
  if (c == 0) rdf_write_v(io, k, v);
  rdf_add_rows(io, k, r0, n, v);
}

// The other form, and the band form: a block a (level, chunk of the 2 nb
// rows); with sums, the level's gathered sums smoothed, else the carried
// randfv at the chunk's latitudes.
template <typename T>
__global__ void __launch_bounds__(kRdfThreads) rdf_add_kernel(
    const RdfIO<T> io) {
  extern __shared__ __align__(16) unsigned char rdf_raw[];
  const int rows = io.rows, nlat = io.nlat, K = io.K;
  const int ch = rdf_chunks(rows), k = blockIdx.x / ch, c = blockIdx.x % ch;
  T* v = (T*)rdf_raw;                 // the profiles v0, v1 (2 x nlat)
  T* s = v + 2 * nlat;                // scratch (2 x nlat)
  int r0, n;
  rdf_chunk(rows, c, &r0, &n);
  if (io.sums) {
    for (int j = threadIdx.x; j < 2 * nlat; j += kRdfThreads)
      v[j] = io.sums[((long long)(j / nlat) * K + k) * nlat + j % nlat];
    __syncthreads();
    rdf_smooth(v, s, nlat);
    if (c == 0) rdf_write_v(io, k, v);
  } else {
    for (int i = threadIdx.x; i < 2 * n; i += kRdfThreads) {
      const int mode = i / n;
      const int jv = rdf_band_lat(r0 + i % n, io.p0, io.nb, nlat);
      v[mode * nlat + jv] = io.v_in[((long long)mode * nlat + jv) * K + k];
    }
    __syncthreads();
  }
  rdf_add_rows(io, k, r0, n, v);
}

// The sums form: a block a (level, chunk of the band's rows), the band's
// weighted zonal sums into v_out (2, K, rows).
template <typename T>
__global__ void __launch_bounds__(kRdfThreads) rdf_sums_kernel(
    const RdfIO<T> io) {
  extern __shared__ __align__(16) unsigned char rdf_raw[];
  const int rows = io.rows, nlon = io.nlon, S = rdf_stride(nlon);
  const int ch = rdf_chunks(rows), k = blockIdx.x / ch, c = blockIdx.x % ch;
  T* x0 = (T*)rdf_raw;
  T* x1 = x0 + rdf_chunk_rows(rows) * S;
  int r0, n;
  rdf_chunk(rows, c, &r0, &n);
  rdf_stage(io, k, rows, r0, n, x0, x1);
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * n; i += kRdfThreads) {
    const int mode = i / n, r = i % n;
    io.v_out[((long long)mode * io.K + k) * rows + r0 + r] = rdf_row_sum(
        (mode ? x1 : x0) + r * S, nlon, io.w[mode * io.K + k]);
  }
}

// Empty kernels of the shortwave form's and the other form's shapes: the
// floors of their launches.
__global__ void __cluster_dims__(kRdfCluster, 1, 1)
    __launch_bounds__(kRdfThreads)
    rdf_floor_cluster_kernel() {}
__global__ void __launch_bounds__(kRdfThreads) rdf_floor_kernel() {}

// The launches' shapes: 0 the shortwave form (clusters), 1 the add (the
// other form and the band form), 2 the sums form; rows the latitude rows
// the arrays hold.
enum { kRdfCl = 0, kRdfAdd = 1, kRdfSums = 2 };

static int rdf_grid(int kind, int K, int rows) {
  return K * (kind == kRdfCl ? kRdfCluster : rdf_chunks(rows));
}

static size_t rdf_smem(int kind, int nlat, int nlon, int rows, size_t el) {
  const size_t st = 2 * (size_t)rdf_chunk_rows(rows) * rdf_stride(nlon);
  return el * (kind == kRdfAdd ? 4 * (size_t)nlat
               : kind == kRdfSums ? st : 4 * (size_t)nlat + st);
}

template <typename T>
static int launch(int kind, const RdfIO<T>& io, cudaStream_t s) {
  const int rows = io.rows;
  const int grid = rdf_grid(kind, io.K, rows);
  const size_t smem = rdf_smem(kind, io.nlat, io.nlon, rows, sizeof(T));
  void (*kernel)(const RdfIO<T>) =
      kind == kRdfCl ? &rdf_cluster_kernel<T>
      : kind == kRdfAdd ? &rdf_add_kernel<T> : &rdf_sums_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kRdfThreads, smem, s>>>(io);
  return (int)cudaGetLastError();
}

static int launch_any(int device, int is_double, int kind, int K, int nlat,
                      int nlon, void* tt, const void* h, const void* v_in,
                      const void* ttm, const void* tt_rsw, const void* dfabs,
                      const void* rps, const void* grdscp, const void* w,
                      const void* sums, void* v_out, int p0, int nb,
                      int rows, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || nlon < 1 || rows < 1 || nb < 0 || p0 < 0)
    return (int)cudaErrorInvalidValue;
  const bool heat = kind != kRdfAdd;
  if (heat && (!ttm || !tt_rsw || !dfabs || !rps || !grdscp || !w || !v_out))
    return (int)cudaErrorInvalidValue;
  if (kind != kRdfSums &&
      (nlat < 2 || rows != 2 * nb || 2 * (p0 + nb) > nlat || !tt || !h ||
       (kind == kRdfAdd && (sums ? !v_out : !v_in))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define RDF_IO(T)                                                        \
  RdfIO<T> io;                                                           \
  io.tt = (T*)tt;                                                        \
  io.h = (const T*)h;                                                    \
  io.v_in = (const T*)v_in;                                              \
  io.ttm = (const T*)ttm;                                                \
  io.tt_rsw = (const T*)tt_rsw;                                          \
  io.dfabs = (const T*)dfabs;                                            \
  io.rps = (const T*)rps;                                                \
  io.grdscp = (const T*)grdscp;                                          \
  io.w = (const T*)w;                                                    \
  io.sums = (const T*)sums;                                              \
  io.v_out = (T*)v_out;                                                  \
  io.K = K;                                                              \
  io.nlat = nlat;                                                        \
  io.nlon = nlon;                                                        \
  io.p0 = p0;                                                            \
  io.nb = nb;                                                            \
  io.rows = rows;                                                        \
  return launch<T>(kind, io, s);
  if (is_double) {
    RDF_IO(double)
  } else {
    RDF_IO(float)
  }
#undef RDF_IO
}

// tt (K, nlat, nlon) in place; h (2, nlat, nlon); v_in (2, nlat, K) (read
// when xs is 0); with xs: ttm, tt_rsw, dfabs (K, nlat, nlon), rps (nlat,
// nlon), grdscp (K,), w (2, K), and v_out (2, nlat, K) written.  All of
// the element type (is_double: double, else float).
SPEEDY_API int rdf_launch(int device, int is_double, int K, int nlat,
                          int nlon, int xs, void* tt, const void* h,
                          const void* v_in, const void* ttm,
                          const void* tt_rsw, const void* dfabs,
                          const void* rps, const void* grdscp,
                          const void* w, void* v_out, void* stream) {
  if (!xs)
    return launch_any(device, is_double, kRdfAdd, K, nlat, nlon, tt, h, v_in,
                      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, 0, nlat / 2, 2 * (nlat / 2),
                      stream);
  return launch_any(device, is_double, kRdfCl, K, nlat, nlon, tt, h, v_in,
                    ttm, tt_rsw, dfabs, rps, grdscp, w, nullptr, v_out, 0,
                    nlat / 2, 2 * (nlat / 2), stream);
}

// The band of latitude pairs p0 .. p0 + nb - 1 of nlat: tt (K, 2 nb, nlon)
// in place and h (2, 2 nb, nlon), the band's rows; v_in (2, nlat, K) whole
// (read when xs is 0); with xs, sums (2, K, nlat) the gathered weighted
// zonal sums of every band in latitude order, and v_out (2, nlat, K) whole
// written.
SPEEDY_API int rdf_band_launch(int device, int is_double, int K, int nlat,
                               int nlon, int p0, int nb, int xs, void* tt,
                               const void* h, const void* v_in,
                               const void* sums, void* v_out, void* stream) {
  if (xs && !sums) return (int)cudaErrorInvalidValue;
  return launch_any(device, is_double, kRdfAdd, K, nlat, nlon, tt, h, v_in,
                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    xs ? sums : nullptr, xs ? v_out : nullptr, p0, nb,
                    2 * nb, stream);
}

// A band's weighted zonal sums (2, K, rows) written to out: ttm, tt_rsw,
// dfabs (K, rows, nlon), rps (rows, nlon), grdscp (K,), w (2, K).
SPEEDY_API int rdf_sums_launch(int device, int is_double, int K, int rows,
                               int nlon, const void* ttm, const void* tt_rsw,
                               const void* dfabs, const void* rps,
                               const void* grdscp, const void* w, void* out,
                               void* stream) {
  return launch_any(device, is_double, kRdfSums, K, rows, nlon, nullptr,
                    nullptr, nullptr, ttm, tt_rsw, dfabs, rps, grdscp, w,
                    nullptr, out, 0, 0, rows, stream);
}

// The empty kernel with rdf_launch's grid, block, cluster and shared
// memory for (K, nlat, nlon, xs): the launch floor a K25 time is read
// against (chip_smoke.py).  It computes nothing and is on no path.
SPEEDY_API int rdf_floor_launch(int device, int is_double, int K, int nlat,
                                int nlon, int xs, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  const int kind = xs ? kRdfCl : kRdfAdd;
  const size_t smem = rdf_smem(kind, nlat, nlon, nlat,
                               is_double ? sizeof(double) : sizeof(float));
  const int grid = rdf_grid(kind, K, nlat);
  cudaStream_t s = (cudaStream_t)stream;
  if (xs)
    rdf_floor_cluster_kernel<<<grid, kRdfThreads, smem, s>>>();
  else
    rdf_floor_kernel<<<grid, kRdfThreads, smem, s>>>();
  return (int)cudaGetLastError();
}

// K25: random diabatic forcing (the arithmetic: rdf.cuh, which says what
// is computed).  With randfh set, every physics step launches it once,
// after its last column kernel: on a shortwave step it forms the new
// randfv (xs_rdf of the step's heating) and adds setrdf to the
// temperature tendency; on the other steps it adds setrdf of the carried
// randfv.
//
// Replaces (JAX package) speedy_ml_tpu/physics/randfor.py:83-110 and
// physics/driver.py:277-288, fused by XLA into the physics step.
// In/out at T30L8 (float32): the add reads two (48, 96) patterns and
// randfv and reads and writes the (8, 48, 96) tendency (0.33 MB); a
// shortwave step also reads three (8, 48, 96) heating fields and rps
// (0.46 MB) and writes randfv (3 KB).
//
// Bound on an H100 SXM: memory, 0.33 MB (0.0001 ms at 3.35 TB/s) or 0.80
// MB (0.00024 ms) on a shortwave step: launch floors.  Design: the first,
// simple one; a block a level, a thread a latitude for the sums (the
// order of the plain version: one longitude after another), the two
// smoothings in shared memory, then the block's threads over the level's
// points for the add.
//
// On a mesh (a shard holding a latitude band, rdf.cuh) two more entry
// points run around an all-gather of the bands' sums: rdf_sums_launch, a
// block a level and a thread a band row, writes the band's weighted zonal
// sums (2, K, rows); rdf_band_launch is the kernel above with the gathered
// (2, K, nlat) sums read in place of its zonal sums, the new randfv written
// whole, and the add on the band's rows.

#include "common.cuh"
#include "rdf.cuh"

constexpr int kRdfBlock = 128;

template <typename T>
struct RdfIO {
  T* tt;                      // (K, rows, nlon) in place
  const T *h, *v_in;          // (2, rows, nlon), (2, nlat, K)
  const T *ttm, *tt_rsw, *dfabs, *rps, *grdscp, *w;  // shortwave step
  const T* sums;              // (2, K, nlat) gathered band sums, or null
  T* v_out;                   // (2, nlat, K), shortwave step
  int K, nlat, nlon, xs, p0, nb;   // the band: pairs p0 .. p0 + nb - 1
};

template <typename T>
__global__ void __launch_bounds__(kRdfBlock) rdf_kernel(const RdfIO<T> io) {
  extern __shared__ unsigned char rdf_smem[];
  T* v = (T*)rdf_smem;          // v0 [nlat], v1 [nlat], scratch [2 nlat]
  const int k = blockIdx.x, nlat = io.nlat, nlon = io.nlon, K = io.K;
  const int rows = 2 * io.nb;
  T* v0 = v;
  T* v1 = v + nlat;
  T* s = v + 2 * nlat;
  if (io.xs) {
    if (io.sums) {
      for (int j = threadIdx.x; j < 2 * nlat; j += kRdfBlock) {
        const int f = j / nlat, jj = j % nlat;
        v[j] = io.sums[((long long)f * K + k) * nlat + jj];
      }
    } else {
      for (int j = threadIdx.x; j < nlat; j += kRdfBlock)
        rdf_zonal(io.ttm, io.tt_rsw, io.dfabs, io.rps, io.grdscp, io.w, K,
                  k, nlat, nlon, j, v0, v1);
    }
    __syncthreads();
    for (int pass = 0; pass < 2; ++pass) {
      for (int j = threadIdx.x; j < 2 * nlat; j += kRdfBlock) {
        const int f = j / nlat, jj = j % nlat;
        s[j] = rdf_smooth_at(v + f * nlat, nlat, jj);
      }
      __syncthreads();
      for (int j = threadIdx.x; j < 2 * nlat; j += kRdfBlock) v[j] = s[j];
      __syncthreads();
    }
    for (int j = threadIdx.x; j < 2 * nlat; j += kRdfBlock) {
      const int f = j / nlat, jj = j % nlat;
      io.v_out[((long long)f * nlat + jj) * K + k] = v[j];
    }
  } else {
    for (int j = threadIdx.x; j < 2 * nlat; j += kRdfBlock) {
      const int f = j / nlat, jj = j % nlat;
      v[j] = io.v_in[((long long)f * nlat + jj) * K + k];
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < rows * nlon; p += kRdfBlock) {
    const int r = p / nlon;
    rdf_add_at(io.h, v0, v1, io.tt, k, rows, nlon, r, p % nlon,
               rdf_band_lat(r, io.p0, io.nb, nlat));
  }
}

// The band's weighted zonal sums: a block a level, a thread a row.
template <typename T>
__global__ void __launch_bounds__(kRdfBlock) rdf_sums_kernel(
    const T* ttm, const T* tt_rsw, const T* dfabs, const T* rps,
    const T* grdscp, const T* w, int K, int rows, int nlon, T* out) {
  const int k = blockIdx.x;
  for (int j = threadIdx.x; j < rows; j += kRdfBlock)
    rdf_zonal(ttm, tt_rsw, dfabs, rps, grdscp, w, K, k, rows, nlon, j,
              out + (long long)k * rows, out + ((long long)K + k) * rows);
}

template <typename T>
static int launch(const RdfIO<T>& io, cudaStream_t s) {
  const size_t smem = 4 * (size_t)io.nlat * sizeof(T);
  rdf_kernel<T><<<io.K, kRdfBlock, smem, s>>>(io);
  return (int)cudaGetLastError();
}

static int launch_any(int device, int is_double, int K, int nlat, int nlon,
                      int xs, void* tt, const void* h, const void* v_in,
                      const void* ttm, const void* tt_rsw, const void* dfabs,
                      const void* rps, const void* grdscp, const void* w,
                      const void* sums, void* v_out, int p0, int nb,
                      void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || nlat < 2 || nlon < 1 || !tt || !h || nb < 1 || p0 < 0 ||
      2 * (p0 + nb) > nlat ||
      (xs ? (!v_out || (!sums && (!ttm || !tt_rsw || !dfabs || !rps ||
                                  !grdscp || !w)))
          : !v_in))
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
  io.xs = xs;                                                            \
  io.p0 = p0;                                                            \
  io.nb = nb;                                                            \
  return launch<T>(io, s);
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
  return launch_any(device, is_double, K, nlat, nlon, xs, tt, h, v_in, ttm,
                    tt_rsw, dfabs, rps, grdscp, w, nullptr, v_out, 0,
                    nlat / 2, stream);
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
  return launch_any(device, is_double, K, nlat, nlon, xs, tt, h, v_in,
                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    xs ? sums : nullptr, v_out, p0, nb, stream);
}

// A band's weighted zonal sums (2, K, rows) written to out: ttm, tt_rsw,
// dfabs (K, rows, nlon), rps (rows, nlon), grdscp (K,), w (2, K).
SPEEDY_API int rdf_sums_launch(int device, int is_double, int K, int rows,
                               int nlon, const void* ttm, const void* tt_rsw,
                               const void* dfabs, const void* rps,
                               const void* grdscp, const void* w, void* out,
                               void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || rows < 1 || nlon < 1 || !ttm || !tt_rsw || !dfabs || !rps ||
      !grdscp || !w || !out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    rdf_sums_kernel<double><<<K, kRdfBlock, 0, s>>>(
        (const double*)ttm, (const double*)tt_rsw, (const double*)dfabs,
        (const double*)rps, (const double*)grdscp, (const double*)w, K, rows,
        nlon, (double*)out);
  else
    rdf_sums_kernel<float><<<K, kRdfBlock, 0, s>>>(
        (const float*)ttm, (const float*)tt_rsw, (const float*)dfabs,
        (const float*)rps, (const float*)grdscp, (const float*)w, K, rows,
        nlon, (float*)out);
  return (int)cudaGetLastError();
}

// K17: the SPEEDY window's entry, the climatological surface and the
// daily forcing's grid fields, a block per latitude row; K17b: the TISR
// plane of the hybrid's feedback on the ML-only cycle, one thread per grid
// point (the arithmetic: surface_forcing.cuh, which says what is
// computed).  The coupled cycle feeds back K17's own fsol plane, which is
// K17b's plane at the same tyear (hybrid/model.py).
//
// Replaces (JAX package) speedy_ml_tpu/physics/land_sea.py:89-115,
// 191-243 (forint, forin5, interp_climatology, init_surface_state), the
// grid part of speedy_ml_tpu/physics/driver.py:132-175 daily_forcing,
// physics/radiation.py:118-160 sol_oz_traced + solar_flux_traced and
// hybrid/model.py:525-544 tisr_field.  In: five monthly tables (12 x 4,608
// floats at T30) and up to nine (lat, lon) fields; out: 8 surface planes
// and 11 forcing planes.
//
// Bound on an H100 SXM: memory, and latency-sized: at T30 ~0.44 MB read
// and written, 0.13 us at 3.35 TB/s.  The first design (a thread per
// point, 36 blocks of 128) ran the whole solar chain, nine dependent
// sines, cosines, an arccosine and a division, at every one of the 4,608
// points before its first forcing store, and issued its 16 table loads
// from the same thread: 0.0028 ms.  Design: a block per latitude
// row (48 at T30).  Its point threads, one a point, issue every load of
// their point at kernel start and form and store the surface and the
// latitude-free forcing planes; meanwhile two lanes of one more warp work
// out the row's solar terms once (fsol on one lane, oz and zenit on the
// other) into shared memory.  One barrier, then the five solar planes.
// A thread's dependent chain sets the time: 16-byte accesses (four points
// a thread) took 0.0037 ms, 8-byte ones 0.0026, one point a thread 0.0023
// (PERF.md).  Every operation is rounded apart in the plain version's
// order (compiled without FMA contraction, SOURCE_FLAGS in
// kernels/build.py).  K17's device-scalar form is the same block reading
// the date's scalars from device memory (sdev), which a captured CUDA
// graph of the hybrid cycle (hybrid/graph.py) refills before each replay;
// the by-value form stays for the eager cycle.

#include "common.cuh"
#include "surface_forcing.cuh"

constexpr int kSfBlock = 128;         // K17b: threads a block
constexpr int kSfPointThreads = 256;  // K17: most point threads a block

template <typename T>
__device__ __forceinline__ void sf_block(const SfIO<T>& io, int npt) {
  __shared__ SfRow<T> row;
  const int j = blockIdx.x;
  const int t = threadIdx.x;
  if (t < npt) {
    for (int c = t; c < io.nlon; c += npt) sf_block_points(io, j, c);
  } else if (io.frc) {
    sf_block_solar(io, row, j, t - npt);
  }
  __syncthreads();
  if (io.frc && t < npt)
    for (int c = t; c < io.nlon; c += npt)
      sf_block_solar_store(io, row, j, c);
}

// DEV: the device-scalar form, which reads the date's scalars and month
// indices from sdev (sf_scalars_from) in place of io.s, so that a
// captured CUDA graph of the cycle takes each replay's date from device
// memory.  Each thread takes a copy of the operands with the date filled
// in: 0.0024 ms against the by-value form's 0.0021 (PERF.md); one copy a
// block staged in shared memory by one thread took 0.0029.
template <typename T, bool DEV>
__global__ void __launch_bounds__(kSfPointThreads + 32)
    surface_forcing_kernel(const SfIO<T> io, const double* __restrict__ sdev,
                           int npt) {
  if constexpr (DEV) {
    SfIO<T> d = io;
    sf_scalars_from(d.s, sdev);
    sf_block(d, npt);
  } else {
    sf_block(io, npt);
  }
}

template <typename T>
__global__ void __launch_bounds__(kSfBlock)
    tisr_kernel(const SfScalars<T> s, const T* __restrict__ slat,
                const T* __restrict__ clat, int nlon, long long G,
                T* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kSfBlock + threadIdx.x;
  if (i < G) tisr_at(s, slat, clat, nlon, out, i);
}

template <typename T>
static SfScalars<T> scalars(const double* scal, const int* ix) {
  SfScalars<T> s;
  for (int k = 0; k < SC_COUNT; ++k) s.v[k] = (T)scal[k];
  for (int k = 0; k < IX_COUNT; ++k) s.ix[k] = ix ? ix[k] : 0;
  return s;
}

static unsigned blocks_for(long long G) {
  return (unsigned)((G + kSfBlock - 1) / kSfBlock);
}


template <typename T>
static void launch(int nlat, int nlon, const void* const* in, void* sfc,
                   void* frc, const double* scal, const int* ix,
                   const double* sdev, cudaStream_t stream) {
  SfIO<T> io;
  const T* const* p = (const T* const*)in;
  io.stl12 = p[0];
  io.snowd12 = p[1];
  io.soilw12 = p[2];
  io.sst12 = p[3];
  io.sice12 = p[4];
  io.sst_hyb = p[5];
  io.alb0 = p[6];
  io.fmask_l = p[7];
  io.fmask_s = p[8];
  io.phis0 = p[9];
  io.stl_am = p[10];
  io.snowd_am = p[11];
  io.sst_am = p[12];
  io.sice_am = p[13];
  io.slat = p[14];
  io.clat = p[15];
  io.stl_carry = p[16];
  io.sfc = (T*)sfc;
  io.frc = (T*)frc;
  io.G = (long long)nlat * nlon;
  io.nlon = nlon;
  if (!sdev) io.s = scalars<T>(scal, ix);
  // a row's point threads (whole warps, at most kSfPointThreads), then
  // the solar warp
  int npt = (nlon + 31) / 32 * 32;
  if (npt > kSfPointThreads) npt = kSfPointThreads;
  if (sdev)
    surface_forcing_kernel<T, true><<<nlat, npt + 32, 0, stream>>>(io, sdev,
                                                                    npt);
  else
    surface_forcing_kernel<T, false><<<nlat, npt + 32, 0, stream>>>(
        io, nullptr, npt);
}

// in: 17 pointers (surface_forcing.cuh SfIO order: stl12, snowd12,
// soilw12, sst12, sice12, sst_hyb, alb0, fmask_l, fmask_s, phis0, stl_am,
// snowd_am, sst_am, sice_am, slat, clat, stl_carry), the ones a call does
// not read null (stl_carry only with both outputs); sfc (SF_PLANES, G) and frc (FC_PLANES, G), either null; scal:
// SC_COUNT doubles, ix: IX_COUNT ints (kernels/surface_forcing.py), both
// host memory; or, in the device-scalar form, both null and sdev a device
// pointer to SC_COUNT + IX_COUNT doubles (sf_scalars_from).
SPEEDY_API int surface_forcing_launch(int device, int is_double, int nlat,
                                      int nlon, const void* const* in,
                                      void* sfc, void* frc,
                                      const double* scal, const int* ix,
                                      const double* sdev, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (nlat <= 0 || nlon <= 0 || (!sfc && !frc) ||
      (sdev ? (scal || ix) : (!scal || (sfc && !ix))) ||
      (in[16] && !(sfc && frc)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    launch<double>(nlat, nlon, in, sfc, frc, scal, ix, sdev, s);
  else
    launch<float>(nlat, nlon, in, sfc, frc, scal, ix, sdev, s);
  return (int)cudaGetLastError();
}

// slat, clat (nlat); out (nlat, nlon); scal as above (SC_TYEAR,
// SC_TWO_PI and SC_CSOLP are read).
SPEEDY_API int tisr_launch(int device, int is_double, int nlat, int nlon,
                           const void* slat, const void* clat, void* out,
                           const double* scal, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (nlat <= 0 || nlon <= 0 || !scal) return (int)cudaErrorInvalidValue;
  const long long G = (long long)nlat * nlon;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    tisr_kernel<double><<<blocks_for(G), kSfBlock, 0, s>>>(
        scalars<double>(scal, nullptr), (const double*)slat,
        (const double*)clat, nlon, G, (double*)out);
  else
    tisr_kernel<float><<<blocks_for(G), kSfBlock, 0, s>>>(
        scalars<float>(scal, nullptr), (const float*)slat,
        (const float*)clat, nlon, G, (float*)out);
  return (int)cudaGetLastError();
}

// K5: spherical-harmonic analysis (grid -> spectral) of a stack of fields.
//
// Replaces (JAX package) speedy_ml_tpu/core/spectral.py:251 _specx (the
// zonal="dft" leg) and :280 _specy, as grid_to_spec (:311) and vdspec
// (:319) chain them.  For every field b of grid (B, nlat, nlon):
//   fm[j, m]  = sum_i f[j, i] * dft_fwd[i, m]             (zonal DFT)
//   sv[j, m]  = (fm[nlat-1-j, m] + fm[j, m]) * wt[j]       (j < nlat/2)
//   dv[j, m]  = (fm[nlat-1-j, m] - fm[j, m]) * wt[j]
//   out[m, n] = sum_j cpol_s[j, m, n] * (n even ? sv : dv)[j, m]
// cpol_s holds the masked Legendre table (mask_s: n = nx-1 is zero) of
// both parities; the parity of n picks the folded sum.  Fields b >= n0
// are first multiplied by pre[lat] (vdspec's 1/cos or 1/cos^2).
//
// Bound on an H100 SXM: neither.  At T30 a call moves 18 KB per field
// in and 8 KB out and does ~0.6 MFLOP per field: a 73-field call is
// ~2 MB (0.6 us at 3.35 TB/s) and ~45 MFLOP (0.7 us at 67 TFLOP/s f32).
// The kernel is latency-sized: its bound is less than a launch takes.
// Design (sht.cuh holds the arithmetic, the layout and the tile choice):
// one block per (field, group of mg wavenumbers), mg the fewest (even, 4
// to 8) that keep the grid within one block per SM.  The block stages its
// field (rows padded to an odd number of 16-byte words), its columns of
// dft_fwd and pre by cp.async, then the Legendre rows of its wavenumbers
// as a second group that lands while the DFT phase runs.  The DFT phase
// gives each thread one latitude pair at two wavenumbers: per 4
// longitudes one 16-byte load of each row and four of dft_fwd feed 32
// products, the 1/cos scaling applied to the row values as they are
// loaded, and the hemispheric fold with the Gaussian weight done in
// registers.  Then each thread runs the Legendre sums of 4 consecutive n
// of one m.  One launch per call; every output's sum in the first
// design's order (bit-identical to it).

#include "common.cuh"
#include "sht.cuh"

__global__ void __launch_bounds__(SHT_MAX_THREADS)
sht_analysis_kernel(ShtAnaArgs a, int mg) {
  extern __shared__ __align__(16) unsigned char sht_smem[];
  const ShtAnaSmem s = sht_ana_carve(sht_smem, mg, a.nlat, a.nlon, a.nx);
  const ShtAnaBlock b = sht_ana_block(a, mg, blockIdx.x);
  const int t = threadIdx.x, T = blockDim.x;
  const ShtAsyncCopy cp;
  sht_ana_stage_grid(cp, a, s, b, mg, t, T);
  sht_async_commit();
  sht_ana_stage_legendre(cp, a, s, b, mg, t, T);
  sht_async_commit();
  sht_async_wait<1>();
  __syncthreads();
  sht_ana_dft(a, s, b, mg, t, T);
  sht_async_wait<0>();
  __syncthreads();
  sht_ana_legendre(a, s, b, mg, t, T, nullptr);
}

// grid (B, nlat, nlon) f32, dft_fwd (nlon, mx) complex64, wt (nlat/2,),
// cpol_s (nlat/2, mx, nx), pre (nlat,) or null, out (B, mx, nx) complex64.
SPEEDY_API int sht_analysis_launch(int device, const void* grid,
                                   const void* dft_fwd, const void* wt,
                                   const void* cpol_s, const void* pre,
                                   int n0, int B, int nlat, int nlon, int mx,
                                   int nx, void* out, void* stream) {
  static int smem_set[64];
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nlat <= 0 || (nlat & 1) || nlon <= 0 || mx <= 0 || nx <= 0 ||
      nlon % 4 || nx % 4 || !sht_aligned(grid, 16) ||
      !sht_aligned(dft_fwd, 8) || !sht_aligned(cpol_s, 16) ||
      !sht_aligned(out, 16))
    return (int)cudaErrorInvalidValue;
  int sms;
  size_t smem_max;
  err = sht_device_limits(device, &sms, &smem_max);
  if (err != cudaSuccess) return (int)err;
  const ShtAnaTile tl = sht_ana_choose(B, nlat, mx, nx, sms);
  const size_t smem = sht_ana_smem_bytes(tl.mg, nlat, nlon, nx);
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  err = sht_smem_limit((const void*)sht_analysis_kernel, device, smem,
                       smem_set);
  if (err != cudaSuccess) return (int)err;
  const ShtAnaArgs a = {(const float*)grid, (const sht_c*)dft_fwd,
                        (const float*)wt, (const float*)cpol_s,
                        (const float*)pre, n0, B, nlat, nlon, mx, nx,
                        (sht_c*)out};
  sht_analysis_kernel<<<tl.blocks, tl.threads, smem, (cudaStream_t)stream>>>(
      a, tl.mg);
  return (int)cudaGetLastError();
}

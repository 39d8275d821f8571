// K6: spherical-harmonic synthesis (spectral -> grid) of a stack of fields.
//
// Replaces (JAX package) speedy_ml_tpu/core/spectral.py:294 _gridy and
// :260 _gridx (the zonal="dft" leg), as spec_to_grid (:315) and uv_grid
// (:351) chain them.  For every field b of spec (B, mx, nx) complex and
// every latitude pair (j south, nlat-1-j north), j < nlat/2:
//   even[m] = sum_{n even} cpol_g[j, m, n] * v[m, n]
//   odd[m]  = sum_{n odd}  cpol_g[j, m, n] * v[m, n]
//   fm_south = even - odd, fm_north = even + odd
//   g[lat, x] = Re(sum_m fm[lat, m] * dft_inv[m, x])   (factor 2, m >= 1,
//                                                       is in dft_inv)
// and fields b >= ncos are multiplied by cosgr[lat] (kcos=2).
//
// Bound on an H100 SXM: neither.  At T30 a call reads 8 KB and writes
// 18 KB per field (~1.3 MB for 50 fields, 0.4 us at 3.35 TB/s) and does
// ~0.6 MFLOP per field (0.45 us at 67 TFLOP/s f32 for 50 fields), less
// than a launch takes.  What limits it is the latency of staging each
// block's operands from L2 and of its dependent sums.
// Design (sht.cuh holds the arithmetic, the layout and the tile choice):
// one block per (2 fields, lp latitude pairs), lp the fewest that keep
// the grid within one block per SM (5 pairs, 125 blocks at 50 fields).
// The block stages its fields' coefficients and its pairs' Legendre rows
// by 16-byte cp.async, then dft_inv as a second group that lands while
// the Legendre phase runs (one thread per (field, pair, m), 4 values of n
// per shared-memory load); the DFT phase gives each thread the south and
// north rows of one (field, pair) at two longitudes, so one 16-byte load
// of dft_inv serves 8 products.  One launch per call; every output's sum
// in the first design's order (bit-identical to it).

#include "common.cuh"
#include "sht.cuh"

__global__ void __launch_bounds__(SHT_MAX_THREADS)
sht_synthesis_kernel(ShtSynArgs a, int ft, int lp) {
  extern __shared__ __align__(16) unsigned char sht_smem[];
  const ShtSynSmem s = sht_syn_carve(sht_smem, ft, lp, a.mx, a.nx, a.nlon);
  const ShtSynBlock b = sht_syn_block(a, ft, lp, blockIdx.x);
  const int t = threadIdx.x, T = blockDim.x;
  const ShtAsyncCopy cp;
  sht_syn_stage_coef(cp, a, s, b, t, T);
  sht_async_commit();
  sht_syn_stage_dft(cp, a, s, t, T);
  sht_async_commit();
  sht_async_wait<1>();
  __syncthreads();
  sht_syn_legendre(a, s, b, ft, lp, t, T);
  sht_async_wait<0>();
  __syncthreads();
  sht_syn_dft(a, s, b, ft, lp, t, T, nullptr);
}

// spec (B, mx, nx) complex64, dft_inv (mx, nlon) complex64, cpol_g
// (nlat/2, mx, nx) f32, cosgr (nlat,), out (B, nlat, nlon) f32.
SPEEDY_API int sht_synthesis_launch(int device, const void* spec,
                                    const void* dft_inv, const void* cpol_g,
                                    const void* cosgr, int ncos, int B,
                                    int nlat, int nlon, int mx, int nx,
                                    void* out, void* stream) {
  static int smem_set[64];
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nlat <= 0 || (nlat & 1) || nlon <= 0 || mx <= 0 || nx <= 0 ||
      nlon % 4 || nx % 4 || !sht_aligned(spec, 16) ||
      !sht_aligned(dft_inv, 16) || !sht_aligned(cpol_g, 16) ||
      !sht_aligned(out, 8))
    return (int)cudaErrorInvalidValue;
  int sms;
  size_t smem_max;
  err = sht_device_limits(device, &sms, &smem_max);
  if (err != cudaSuccess) return (int)err;
  const ShtSynTile tl = sht_syn_choose(B, nlat, nlon, mx, nx, sms, smem_max);
  const size_t smem = sht_syn_smem_bytes(tl.ft, tl.lp, mx, nx, nlon);
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  err = sht_smem_limit((const void*)sht_synthesis_kernel, device, smem,
                       smem_set);
  if (err != cudaSuccess) return (int)err;
  const ShtSynArgs a = {(const sht_c*)spec, (const sht_c*)dft_inv,
                        (const float*)cpol_g, (const float*)cosgr,
                        ncos, B, nlat, nlon, mx, nx, (float*)out};
  sht_synthesis_kernel<<<tl.blocks, tl.threads, smem, (cudaStream_t)stream>>>(
      a, tl.ft, tl.lp);
  return (int)cudaGetLastError();
}

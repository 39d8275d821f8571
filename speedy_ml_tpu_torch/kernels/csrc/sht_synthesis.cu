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
// ~0.6 MFLOP per field (0.45 us at 67 TFLOP/s f32 for 50 fields).
// Design: one block per (latitude pair, field), B*nlat/2 blocks; the
// block stages its field's (mx, nx) coefficients in shared memory, one
// thread per m forms the even/odd Legendre sums, then one thread per
// longitude forms the two real rows.  f32 sums in index order.

#include "common.cuh"

__global__ void sht_synthesis_kernel(const float2* __restrict__ spec,
                                     const float2* __restrict__ dft_inv,
                                     const float* __restrict__ cpol_g,
                                     const float* __restrict__ cosgr,
                                     int ncos, int nlat, int nlon, int mx,
                                     int nx, float* __restrict__ out) {
  extern __shared__ float2 sm2[];
  const int j = blockIdx.x;     // southern row j, northern row nlat-1-j
  const int b = blockIdx.y;
  float2* v = sm2;              // mx * nx
  float2* fs = sm2 + mx * nx;   // mx
  float2* fn = fs + mx;         // mx
  const float2* src = spec + (size_t)b * mx * nx;
  for (int i = threadIdx.x; i < mx * nx; i += blockDim.x) v[i] = src[i];
  __syncthreads();
  for (int m = threadIdx.x; m < mx; m += blockDim.x) {
    const float* c = cpol_g + ((size_t)j * mx + m) * nx;
    const float2* vm = v + m * nx;
    float er = 0.f, ei = 0.f, orr = 0.f, oi = 0.f;
    for (int n = 0; n < nx; n += 2) {
      er = fmaf(c[n], vm[n].x, er);
      ei = fmaf(c[n], vm[n].y, ei);
      if (n + 1 < nx) {
        orr = fmaf(c[n + 1], vm[n + 1].x, orr);
        oi = fmaf(c[n + 1], vm[n + 1].y, oi);
      }
    }
    fs[m] = make_float2(er - orr, ei - oi);
    fn[m] = make_float2(er + orr, ei + oi);
  }
  __syncthreads();
  const int jn = nlat - 1 - j;
  const bool scale = b >= ncos;
  for (int x = threadIdx.x; x < nlon; x += blockDim.x) {
    float gs = 0.f, gn = 0.f;
    for (int m = 0; m < mx; ++m) {
      const float2 w = dft_inv[m * nlon + x];
      gs = fmaf(fs[m].x, w.x, gs);
      gs = fmaf(-fs[m].y, w.y, gs);
      gn = fmaf(fn[m].x, w.x, gn);
      gn = fmaf(-fn[m].y, w.y, gn);
    }
    if (scale) {
      gs = __fmul_rn(gs, cosgr[j]);
      gn = __fmul_rn(gn, cosgr[jn]);
    }
    out[((size_t)b * nlat + j) * nlon + x] = gs;
    out[((size_t)b * nlat + jn) * nlon + x] = gn;
  }
}

// spec (B, mx, nx) complex64, dft_inv (mx, nlon) complex64, cpol_g
// (nlat/2, mx, nx) f32, cosgr (nlat,), out (B, nlat, nlon) f32.
SPEEDY_API int sht_synthesis_launch(int device, const void* spec,
                                    const void* dft_inv, const void* cpol_g,
                                    const void* cosgr, int ncos, int B,
                                    int nlat, int nlon, int mx, int nx,
                                    void* out, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nlat <= 0 || (nlat & 1) || nlon <= 0 || mx <= 0 || nx <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(mx * nx + 2 * mx) * sizeof(float2);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sht_synthesis_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_dim((unsigned)(nlat / 2), (unsigned)B);
  sht_synthesis_kernel<<<grid_dim, 128, smem, (cudaStream_t)stream>>>(
      (const float2*)spec, (const float2*)dft_inv, (const float*)cpol_g,
      (const float*)cosgr, ncos, nlat, nlon, mx, nx, (float*)out);
  return (int)cudaGetLastError();
}

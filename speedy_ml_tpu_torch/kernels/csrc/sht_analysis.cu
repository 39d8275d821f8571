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
// The kernel is latency-sized.  Design: one block per (group of MG
// wavenumbers, field), 256 threads.  The block stages its field in
// shared memory (rows padded by one word against bank conflicts); one
// thread per (latitude, m) pair runs the DFT of that row for that m
// (neighbouring threads take neighbouring m: the dft_fwd reads coalesce
// and the row reads broadcast); then one thread per (m, n) runs the fold
// and the Legendre sum.  All sums are f32 in index order; no TF32 path
// exists.

#include "common.cuh"

#define SHT_MG 8          // wavenumbers per block
#define SHT_THREADS 256

__global__ void __launch_bounds__(SHT_THREADS)
sht_analysis_kernel(const float* __restrict__ grid,
                    const float2* __restrict__ dft_fwd,
                    const float* __restrict__ wt,
                    const float* __restrict__ cpol_s,
                    const float* __restrict__ pre, int n0, int nlat,
                    int nlon, int mx, int nx, float2* __restrict__ out) {
  extern __shared__ float smem[];
  const int m0 = blockIdx.x * SHT_MG;
  const int nm = min(SHT_MG, mx - m0);
  const int b = blockIdx.y;
  const int stride = nlon + 1;
  float* f = smem;                                       // nlat * stride
  float2* fm = reinterpret_cast<float2*>(smem + ((nlat * stride + 1) & ~1));
  const float* src = grid + (size_t)b * nlat * nlon;
  const bool scale = pre != nullptr && b >= n0;
  for (int i = threadIdx.x; i < nlat * nlon; i += blockDim.x) {
    const int j = i / nlon;
    float v = src[i];
    if (scale) v = __fmul_rn(v, pre[j]);
    f[j * stride + (i - j * nlon)] = v;
  }
  __syncthreads();
  // fm[mm * nlat + j]: the zonal coefficient m0 + mm of latitude j
  for (int p = threadIdx.x; p < nlat * nm; p += blockDim.x) {
    const int j = p / nm;
    const int mm = p - j * nm;
    const float* row = f + j * stride;
    const float2* w = dft_fwd + m0 + mm;
    float re = 0.f, im = 0.f;
    for (int i = 0; i < nlon; ++i) {
      const float2 c = w[(size_t)i * mx];
      re = fmaf(row[i], c.x, re);
      im = fmaf(row[i], c.y, im);
    }
    fm[mm * nlat + j] = make_float2(re, im);
  }
  __syncthreads();
  const int iy = nlat / 2;
  for (int p = threadIdx.x; p < nm * nx; p += blockDim.x) {
    const int mm = p / nx;
    const int n = p - mm * nx;
    const int m = m0 + mm;
    const bool even = (n & 1) == 0;
    const float2* g = fm + mm * nlat;
    float re = 0.f, im = 0.f;
    for (int j = 0; j < iy; ++j) {
      const float2 s = g[j];
      const float2 nn = g[nlat - 1 - j];
      const float w = wt[j];
      const float ar = (even ? nn.x + s.x : nn.x - s.x) * w;
      const float ai = (even ? nn.y + s.y : nn.y - s.y) * w;
      const float c = cpol_s[((size_t)j * mx + m) * nx + n];
      re = fmaf(c, ar, re);
      im = fmaf(c, ai, im);
    }
    out[((size_t)b * mx + m) * nx + n] = make_float2(re, im);
  }
}

// grid (B, nlat, nlon) f32, dft_fwd (nlon, mx) complex64, wt (nlat/2,),
// cpol_s (nlat/2, mx, nx), pre (nlat,) or null, out (B, mx, nx) complex64.
SPEEDY_API int sht_analysis_launch(int device, const void* grid,
                                   const void* dft_fwd, const void* wt,
                                   const void* cpol_s, const void* pre,
                                   int n0, int B, int nlat, int nlon, int mx,
                                   int nx, void* out, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nlat <= 0 || (nlat & 1) || nlon <= 0 || mx <= 0 || nx <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(((nlat * (nlon + 1) + 1) & ~1) +
                               2 * SHT_MG * nlat) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sht_analysis_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_dim((unsigned)((mx + SHT_MG - 1) / SHT_MG), (unsigned)B);
  sht_analysis_kernel<<<grid_dim, SHT_THREADS, smem,
                        (cudaStream_t)stream>>>(
      (const float*)grid, (const float2*)dft_fwd, (const float*)wt,
      (const float*)cpol_s, (const float*)pre, n0, nlat, nlon, mx, nx,
      (float2*)out);
  return (int)cudaGetLastError();
}

// K8: the spectral tail of one dycore step, one thread per (m, n).
//
// Replaces (JAX package) speedy_ml_tpu/dycore/model.py: the vds/lap sums
// of to_spectral_tendencies (:371-383), :386 sptend (with :233
// geopotential), :419 implicit_correction, :443 _hordif with the
// orographic corrections, the drag and the top-level del^2 (:517-550),
// and :446 _timint (trunct, leapfrog, Robert-Asselin-Williams filter),
// in the order of step (:505-562).  Input A (1 + 9K, mx, nx) complex:
//   [psdt; ke (K), ttend (K), qtend (K);
//    utend, -u(T-tref), -u q (K each); vtend, -v(T-tref), -v q (K each)]
// the K5 analysis of K7's stack (u/v stacks already times 1/cos).
// Output: the new vor, div, t, ps, tr, both leapfrog levels.
//
// Bound on an H100 SXM: memory, latency-sized.  At T30L8 a call reads
// ~0.5 MB (A, the state, xj) and writes 0.25 MB (0.2 us at 3.35 TB/s)
// for ~0.5 MFLOP.  Design: 992 threads (31 x 32 coefficients); each
// keeps the K levels of the four tendencies in registers as float2 and
// reads its (m, n +- 1) neighbours of the u/v stacks from global memory
// (L1/L2).  The 8x8 level mixes run per thread: xd, xc from the table
// blob (L1 broadcast), xj[m, n] (K*K floats) read per thread.  The
// tables arrive as one float32 blob in the order of
// kernels/spectral_tail.py:tail_blob.

#include "common.cuh"

struct c2 {
  float x, y;
};
__device__ __forceinline__ c2 mk(float x, float y) { return {x, y}; }
__device__ __forceinline__ c2 ld(const float2* p, size_t i) {
  const float2 v = p[i];
  return {v.x, v.y};
}
__device__ __forceinline__ c2 operator+(c2 a, c2 b) {
  return {a.x + b.x, a.y + b.y};
}
__device__ __forceinline__ c2 operator-(c2 a, c2 b) {
  return {a.x - b.x, a.y - b.y};
}
__device__ __forceinline__ c2 operator*(float s, c2 a) {
  return {s * a.x, s * a.y};
}
// i * g * a: (0 + i g)(a.x + i a.y)
__device__ __forceinline__ c2 itimes(float g, c2 a) {
  return {-g * a.y, g * a.x};
}

template <int K>
__global__ void spectral_tail_kernel(
    int mx, int nx, const float2* __restrict__ A,
    const float2* __restrict__ vor, const float2* __restrict__ div,
    const float2* __restrict__ tem, const float2* __restrict__ ps,
    const float2* __restrict__ tr, const float2* __restrict__ phis,
    const float2* __restrict__ tcorh, const float2* __restrict__ qcorh,
    const float* __restrict__ T, int j1, int j4, int implicit, int trunc,
    float dt, float ew1, float ew2, float sdrag, float rgas,
    float2* __restrict__ o_vor, float2* __restrict__ o_div,
    float2* __restrict__ o_t, float2* __restrict__ o_ps,
    float2* __restrict__ o_tr) {
  const int MN = mx * nx;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= MN) return;
  const int m = idx / nx;
  const int n = idx - m * nx;

  // table blob (kernels/spectral_tail.py:tail_blob)
  const float* vddym = T;
  const float* vddyp = vddym + MN;
  const float* gradx = vddyp + MN;
  const float* zrow = gradx + mx;
  const float* el2 = zrow + nx;
  const float* trfilt = el2 + MN;
  const float* dmp = trfilt + MN;
  const float* dmpd = dmp + MN;
  const float* dmps = dmpd + MN;
  const float* dhs = dmps + MN;
  const float* dhsr = dhs + K;
  const float* xgeop1 = dhsr + K;
  const float* xgeop2 = xgeop1 + K;
  const float* corf = xgeop2 + K;
  const float* tcorv = corf + K;
  const float* qcorv = tcorv + K;
  const float* tref = qcorv + K;
  const float* tref1 = tref + K;
  const float* tref2 = tref1 + K;
  const float* tref3 = tref2 + K;
  const float* dhsx = tref3 + K;
  const float* xc = dhsx + K;
  const float* xd = xc + K * K;
  const float* elz = xd + K * K;
  const float* dmp1 = elz + MN;
  const float* dmp1d = dmp1 + MN;
  const float* dmp1s = dmp1d + MN;
  const float* xj = dmp1s + MN + (size_t)idx * K * K;

  const float ym = vddym[idx], yp = vddyp[idx], gx = gradx[m], z = zrow[n];
  const float l2 = el2[idx];
  const c2 zero = mk(0.f, 0.f);
  auto at = [&](int f, int nn) -> c2 {
    if (nn < 0 || nn >= nx) return zero;
    return ld(A, ((size_t)f * mx + m) * nx + nn);
  };
  const int o_s = 1, o_u = 1 + 3 * K, o_v = 1 + 6 * K;

  // --- tendencies from the analysed stack (vds + lap / advection sums)
  c2 vordt[K], divdt[K], tdt[K], qdt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const c2 uc = at(o_u + k, n), vc = at(o_v + k, n);
    vordt[k] = (ym * at(o_u + k, n - 1) - yp * at(o_u + k, n + 1)) +
               itimes(gx * z, vc);
    divdt[k] = (yp * at(o_v + k, n + 1) - ym * at(o_v + k, n - 1)) +
               itimes(gx * z, uc);
    divdt[k] = divdt[k] + l2 * at(o_s + k, n);
    tdt[k] = ((yp * at(o_v + K + k, n + 1) - ym * at(o_v + K + k, n - 1)) +
              itimes(gx * z, at(o_u + K + k, n))) +
             at(o_s + K + k, n);
    qdt[k] = ((yp * at(o_v + 2 * K + k, n + 1) -
               ym * at(o_v + 2 * K + k, n - 1)) +
              itimes(gx * z, at(o_u + 2 * K + k, n))) +
             at(o_s + 2 * K + k, n);
  }
  c2 psdt = idx == 0 ? zero : at(0, n);

  // --- sptend at level j4
  c2 dvs[K], ts[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    dvs[k] = ld(div, ((size_t)j4 * K + k) * MN + idx);
    ts[k] = ld(tem, ((size_t)j4 * K + k) * MN + idx);
  }
  const c2 pss = ld(ps, (size_t)j4 * MN + idx);
  c2 dmeanc = dhs[0] * dvs[0];
#pragma unroll
  for (int k = 1; k < K; ++k) dmeanc = dmeanc + dhs[k] * dvs[k];
  psdt = idx == 0 ? zero : psdt - dmeanc;
  c2 sig[K + 1];
  sig[0] = zero;
  sig[K] = zero;
#pragma unroll
  for (int k = 0; k < K - 1; ++k)
    sig[k + 1] = sig[k] + (-dhs[k]) * (dvs[k] - dmeanc);
  c2 dumk[K + 1];
  dumk[0] = zero;
  dumk[K] = zero;
#pragma unroll
  for (int j = 1; j < K; ++j) dumk[j] = (tref[j] - tref[j - 1]) * sig[j];
#pragma unroll
  for (int k = 0; k < K; ++k)
    tdt[k] = ((tdt[k] - dhsr[k] * (dumk[k + 1] + dumk[k])) +
              tref3[k] * (sig[k + 1] + sig[k])) -
             tref2[k] * dmeanc;
  c2 phi[K];
  phi[K - 1] = ld(phis, idx) + xgeop1[K - 1] * ts[K - 1];
#pragma unroll
  for (int k = K - 2; k >= 0; --k)
    phi[k] = (phi[k + 1] + xgeop2[k + 1] * ts[k + 1]) + xgeop1[k] * ts[k];
  if (m == 0) {
#pragma unroll
    for (int k = 1; k < K - 1; ++k)
      phi[k] = phi[k] + corf[k] * (ts[k + 1] - ts[k - 1]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    divdt[k] = divdt[k] + l2 * (phi[k] + (rgas * tref[k]) * pss);

  // --- semi-implicit correction
  if (implicit) {
    const float ez = elz[idx];
    c2 yf[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c2 ye = xd[k * K] * tdt[0];
#pragma unroll
      for (int l = 1; l < K; ++l) ye = ye + xd[k * K + l] * tdt[l];
      ye = ye + tref1[k] * psdt;
      yf[k] = divdt[k] + ez * ye;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c2 d = xj[k * K] * yf[0];
#pragma unroll
      for (int l = 1; l < K; ++l) d = d + xj[k * K + l] * yf[l];
      divdt[k] = d;
    }
    c2 s = dhsx[0] * divdt[0];
#pragma unroll
    for (int k = 1; k < K; ++k) s = s + dhsx[k] * divdt[k];
    psdt = psdt - s;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c2 d = xc[k * K] * divdt[0];
#pragma unroll
      for (int l = 1; l < K; ++l) d = d + xc[k * K + l] * divdt[l];
      tdt[k] = tdt[k] + d;
    }
  }

  // --- horizontal diffusion, drag, top-level del^2 (level-0 state)
  const float d_v = dmp[idx], d_d = dmpd[idx], d_s = dmps[idx];
  const float f_v = dmp1[idx], f_d = dmp1d[idx], f_s = dmp1s[idx];
  const c2 tc = tcorh ? ld(tcorh, idx) : zero;
  const c2 qc = qcorh ? ld(qcorh, idx) : zero;
  c2 vor0[K], div0[K], ctmp[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    vor0[k] = ld(vor, (size_t)k * MN + idx);
    div0[k] = ld(div, (size_t)k * MN + idx);
    ctmp[k] = ld(tem, (size_t)k * MN + idx);
    if (tcorh) ctmp[k] = ctmp[k] + tcorv[k] * tc;
    vordt[k] = f_v * (vordt[k] - d_v * vor0[k]);
    divdt[k] = f_d * (divdt[k] - d_d * div0[k]);
    tdt[k] = f_v * (tdt[k] - d_v * ctmp[k]);
    c2 qtmp = ld(tr, (size_t)k * MN + idx);
    if (qcorh) qtmp = qtmp + qcorv[k] * qc;
    qdt[k] = f_d * (qdt[k] - d_d * qtmp);
  }
  if (m == 0) {
    vordt[0] = vordt[0] - sdrag * vor0[0];
    divdt[0] = divdt[0] - sdrag * div0[0];
  }
  vordt[0] = f_s * (vordt[0] - d_s * vor0[0]);
  divdt[0] = f_s * (divdt[0] - d_s * div0[0]);
  tdt[0] = f_s * (tdt[0] - d_s * ctmp[0]);

  // --- trunct + leapfrog + Robert-Asselin-Williams filter
  const float tf = trunc ? trfilt[idx] : 1.f;
  const size_t lev = (size_t)K * MN;  // one leapfrog level of a 3-D field
  auto step = [&](const float2* f, float2* o, size_t off, size_t level,
                  c2 fdt) {
    if (trunc) fdt = tf * fdt;
    const c2 old1 = ld(f, off + idx);
    const c2 oldj = ld(f, (size_t)(j1 - 1) * level + off + idx);
    const c2 fnew = old1 + dt * fdt;
    const c2 new1 = oldj + ew1 * ((old1 - 2.f * oldj) + fnew);
    const c2 new2 = fnew - ew2 * ((new1 - 2.f * oldj) + fnew);
    o[off + idx] = make_float2(new1.x, new1.y);
    o[level + off + idx] = make_float2(new2.x, new2.y);
  };
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t off = (size_t)k * MN;
    step(vor, o_vor, off, lev, vordt[k]);
    step(div, o_div, off, lev, divdt[k]);
    step(tem, o_t, off, lev, tdt[k]);
    step(tr, o_tr, off, lev, qdt[k]);
  }
  step(ps, o_ps, 0, (size_t)MN, psdt);
}

// K levels (5, 7 or 8), one tracer.  A (1 + 9K, mx, nx), vor/div/t
// (2, K, mx, nx), ps (2, mx, nx), tr (2, 1, K, mx, nx), phis/tcorh/qcorh
// (mx, nx), all complex64 (tcorh/qcorh may be null); blob: the f32 tables
// (tail_blob); outputs shaped as the state.
SPEEDY_API int spectral_tail_launch(
    int device, int K, int mx, int nx, const void* A, const void* vor,
    const void* div, const void* tem, const void* ps, const void* tr,
    const void* phis, const void* tcorh, const void* qcorh, const void* blob,
    int j1, int j4, int implicit, int trunc, float dt, float ew1, float ew2,
    float sdrag, float rgas, void* o_vor, void* o_div, void* o_t, void* o_ps,
    void* o_tr, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (mx <= 0 || nx <= 0 || (j1 != 1 && j1 != 2) || (j4 != 0 && j4 != 1))
    return (int)cudaErrorInvalidValue;
  const int MN = mx * nx;
  const int block = 128;
  const unsigned grid = (unsigned)((MN + block - 1) / block);
  cudaStream_t s = (cudaStream_t)stream;
#define SPEEDY_TAIL_ARGS                                                     \
  mx, nx, (const float2*)A, (const float2*)vor, (const float2*)div,         \
      (const float2*)tem, (const float2*)ps, (const float2*)tr,             \
      (const float2*)phis, (const float2*)tcorh, (const float2*)qcorh,      \
      (const float*)blob, j1, j4, implicit, trunc, dt, ew1, ew2, sdrag,     \
      rgas, (float2*)o_vor, (float2*)o_div, (float2*)o_t, (float2*)o_ps,    \
      (float2*)o_tr
  switch (K) {
    case 5:
      spectral_tail_kernel<5><<<grid, block, 0, s>>>(SPEEDY_TAIL_ARGS);
      break;
    case 7:
      spectral_tail_kernel<7><<<grid, block, 0, s>>>(SPEEDY_TAIL_ARGS);
      break;
    case 8:
      spectral_tail_kernel<8><<<grid, block, 0, s>>>(SPEEDY_TAIL_ARGS);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPEEDY_TAIL_ARGS
  return (int)cudaGetLastError();
}

// K7: grid-point dynamics of one step, one thread per grid column.
//
// Replaces (JAX package) speedy_ml_tpu/dycore/model.py:258
// grid_tendencies after its inverse transform (:290-350), the physics
// sum of step (:500-503) and the products of to_spectral_tendencies
// (:365-379).  Input gall ((5+R)K + 2, lat, lon): vor, div, T, q (K
// each), u, v (K each, 1/cos applied), dps/dx, dps/dy.  Per column, with
// the K levels in registers:
//   vertical means umean, vmean, dmean (sum_k f[k] * dhs[k], level order);
//   puv = (u - umean) px + (v - vmean) py; the half-level sums sigdt,
//   sigm (cumulative, 0 on top); the u/v/T/q tendencies with the vertical
//   advection half_flux terms (zero at the top and bottom half levels,
//   and for q also on the two half levels below the top);
//   plus the physics tendencies (u, v, t, q; optional).
// Output (1 + 9K, lat, lon), the stack K5 transforms:
//   [psfield = -umean px - vmean py; ke, ttend, qtend;
//    utend, -u (T - tref), -u q; vtend, -v (T - tref), -v q].
//
// Bound on an H100 SXM: memory, and latency-sized: at T30L8 a call reads
// 52 + 32 fields and writes 73 of 4,608 columns (~2.9 MB, 0.9 us at
// 3.35 TB/s) for ~0.6 MFLOP.  Design: 4,608 threads, each reads its
// column (coalesced across neighbouring columns), keeps the K levels in
// registers and writes its outputs once.  Every operation is rounded
// apart (no FMA contraction), in the order of the plain version, so the
// two agree to a few ulps.

#include "common.cuh"

// every operation rounded apart: no FMA contraction
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

template <int K>
__global__ void grid_dynamics_kernel(const float* __restrict__ gall,
                                     const float* __restrict__ pu,
                                     const float* __restrict__ pv,
                                     const float* __restrict__ pt,
                                     const float* __restrict__ pq,
                                     const float* __restrict__ blob,
                                     float rgas, float akap, int nlat,
                                     int nlon, float* __restrict__ out) {
  const int G = nlat * nlon;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= G) return;
  const int lat = p / nlon;
  const float* coriol = blob;
  const float* dhs = blob + nlat;
  const float* dhsr = dhs + K;
  const float* fsgr = dhsr + K;
  const float* tref = fsgr + K;
  const float* tref3 = tref + K;

  float vor[K], dv[K], t[K], q[K], u[K], v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    vor[k] = gall[(size_t)(0 * K + k) * G + p];
    dv[k] = gall[(size_t)(1 * K + k) * G + p];
    t[k] = gall[(size_t)(2 * K + k) * G + p];
    q[k] = gall[(size_t)(3 * K + k) * G + p];
    u[k] = gall[(size_t)(4 * K + k) * G + p];
    v[k] = gall[(size_t)(5 * K + k) * G + p];
  }
  const float px = gall[(size_t)(6 * K) * G + p];
  const float py = gall[(size_t)(6 * K + 1) * G + p];
  const float cor = coriol[lat];

  float umean = mul(u[0], dhs[0]), vmean = mul(v[0], dhs[0]),
        dmean = mul(dv[0], dhs[0]);
#pragma unroll
  for (int k = 1; k < K; ++k) {
    umean = add(umean, mul(u[k], dhs[k]));
    vmean = add(vmean, mul(v[k], dhs[k]));
    dmean = add(dmean, mul(dv[k], dhs[k]));
  }
  const float psfield = sub(mul(-umean, px), mul(vmean, py));

  float puv[K], sigdt[K + 1], sigm[K + 1], tgg[K];
  sigdt[0] = 0.f;
  sigm[0] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    puv[k] = add(mul(sub(u[k], umean), px), mul(sub(v[k], vmean), py));
    sigdt[k + 1] = add(sigdt[k], mul(-dhs[k], sub(add(puv[k], dv[k]), dmean)));
    sigm[k + 1] = add(sigm[k], mul(-dhs[k], puv[k]));
    tgg[k] = sub(t[k], tref[k]);
  }
  const float rpx = mul(rgas, px), rpy = mul(rgas, py);

  // half-level vertical advection fluxes, zero on the top/bottom half
  // levels; q's are also zero on the two half levels below the top
  float tku[K + 1], tkv[K + 1], tkt[K + 1], tkq[K + 1];
  tku[0] = tkv[0] = tkt[0] = tkq[0] = 0.f;
  tku[K] = tkv[K] = tkt[K] = tkq[K] = 0.f;
#pragma unroll
  for (int j = 1; j < K; ++j) {
    tku[j] = mul(sigdt[j], sub(u[j], u[j - 1]));
    tkv[j] = mul(sigdt[j], sub(v[j], v[j - 1]));
    tkt[j] = add(mul(sigdt[j], sub(tgg[j], tgg[j - 1])),
                 mul(sigm[j], sub(tref[j], tref[j - 1])));
    tkq[j] = j <= 2 ? 0.f : mul(sigdt[j], sub(q[j], q[j - 1]));
  }

  float* o_ps = out;
  float* o_ke = out + (size_t)1 * G;
  float* o_tt = out + (size_t)(1 + K) * G;
  float* o_qt = out + (size_t)(1 + 2 * K) * G;
  float* o_ut = out + (size_t)(1 + 3 * K) * G;
  float* o_utg = out + (size_t)(1 + 4 * K) * G;
  float* o_uq = out + (size_t)(1 + 5 * K) * G;
  float* o_vt = out + (size_t)(1 + 6 * K) * G;
  float* o_vtg = out + (size_t)(1 + 7 * K) * G;
  float* o_vq = out + (size_t)(1 + 8 * K) * G;
  o_ps[p] = psfield;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float vabs = add(vor[k], cor);
    float ut = sub(sub(mul(v[k], vabs), mul(tgg[k], rpx)),
                   mul(add(tku[k + 1], tku[k]), dhsr[k]));
    float vt = sub(sub(mul(-u[k], vabs), mul(tgg[k], rpy)),
                   mul(add(tkv[k + 1], tkv[k]), dhsr[k]));
    float tt = sub(mul(tgg[k], dv[k]), mul(add(tkt[k + 1], tkt[k]), dhsr[k]));
    tt = add(tt, mul(mul(fsgr[k], tgg[k]), add(sigdt[k + 1], sigdt[k])));
    tt = add(tt, mul(tref3[k], add(sigm[k + 1], sigm[k])));
    tt = add(tt, mul(akap, sub(mul(t[k], puv[k]), mul(tgg[k], dmean))));
    float qt = sub(mul(q[k], dv[k]), mul(add(tkq[k + 1], tkq[k]), dhsr[k]));
    const size_t i = (size_t)k * G + p;
    if (pu != nullptr) {
      ut = add(ut, pu[i]);
      vt = add(vt, pv[i]);
      tt = add(tt, pt[i]);
      qt = add(qt, pq[i]);
    }
    o_ke[i] = mul(0.5f, add(mul(u[k], u[k]), mul(v[k], v[k])));
    o_tt[i] = tt;
    o_qt[i] = qt;
    o_ut[i] = ut;
    o_utg[i] = mul(-u[k], tgg[k]);
    o_uq[i] = mul(-u[k], q[k]);
    o_vt[i] = vt;
    o_vtg[i] = mul(-v[k], tgg[k]);
    o_vq[i] = mul(-v[k], q[k]);
  }
}

// K levels (5, 7 or 8), one tracer.  gall (6K + 2, lat, lon); pu/pv/pt/pq
// (K, lat, lon) each, all null for the dry core; blob: coriol (lat),
// dhs, dhsr, fsgr, tref, tref3 (K each); out (1 + 9K, lat, lon).
SPEEDY_API int grid_dynamics_launch(int device, int K, const void* gall,
                                    const void* pu, const void* pv,
                                    const void* pt, const void* pq,
                                    const void* blob, float rgas, float akap,
                                    int nlat, int nlon, void* out,
                                    void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  const bool some = pu || pv || pt || pq;
  const bool all = pu && pv && pt && pq;
  if (nlat <= 0 || nlon <= 0 || (some && !all))
    return (int)cudaErrorInvalidValue;
  const int G = nlat * nlon;
  const int block = 128;
  const unsigned grid = (unsigned)((G + block - 1) / block);
  cudaStream_t s = (cudaStream_t)stream;
  const float *g = (const float*)gall, *b = (const float*)blob;
  const float *u = (const float*)pu, *v = (const float*)pv,
              *t = (const float*)pt, *q = (const float*)pq;
  switch (K) {
    case 5:
      grid_dynamics_kernel<5><<<grid, block, 0, s>>>(g, u, v, t, q, b, rgas,
                                                     akap, nlat, nlon,
                                                     (float*)out);
      break;
    case 7:
      grid_dynamics_kernel<7><<<grid, block, 0, s>>>(g, u, v, t, q, b, rgas,
                                                     akap, nlat, nlon,
                                                     (float*)out);
      break;
    case 8:
      grid_dynamics_kernel<8><<<grid, block, 0, s>>>(g, u, v, t, q, b, rgas,
                                                     akap, nlat, nlon,
                                                     (float*)out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

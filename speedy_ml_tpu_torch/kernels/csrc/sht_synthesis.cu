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
//
// K6_inject (inject_synthesis_launch): the injection's synthesis with
// K18's spectral glue as its phase 0 (inject_spectral.cuh), replacing
// (JAX package) speedy_ml_tpu/hybrid/model.py:404-434 inject_to_speedy's
// vdspec, trunct, uv_grid and the spec_to_grid of t and q, from K5's
// analysis on.  Bound as K6 (latency); K18 on its own moved ~1 MB through
// device memory (K5's 33 fields in, the state's 66 and a 32-field stack
// out, and the stack back in for K6) and cost a launch.  Design: the stack
// never goes to device memory.  A block of K6's tile at 4K fields (2
// fields x 3 latitude pairs, 128 blocks at T30L8) issues the copies of its
// Legendre rows and of dft_inv, and while they land forms its two
// fields' coefficients straight into K6's coefficient buffer: a warp per
// row m (16 warps), lane n on coefficient n of both fields, reading K5's
// rows and the tables from L2, vor and div of the n +- 1 neighbours by
// shuffles.  The blocks of latitude group 0 store leapfrog level 0 of the
// state, those of group 1 level 1.  Then K6's phases as they are: the
// grid is K6's on K18's stack, bit for bit.  (Staging K5's rows and the
// tables by cp.async first, or a cluster of the latitude groups sharing
// the coefficients through distributed shared memory, took longer on an
// H100: PERF.md.)
#include "common.cuh"
#include "inject_spectral.cuh"
#include "sht.cuh"

// K6_inject, phase 0 while the copies land: a warp per row m of the
// block's coefficients, lane n on coefficient n; the n +- 1 neighbours of
// vor and div by shuffles (inject_spectral.cuh)
__device__ __forceinline__ void sht_inj_coef(const ShtSynArgs& a,
                                             const ShtSynSmem& s,
                                             const InjBlk& B, int t, int T) {
  const int lane = t & 31, W = T >> 5;
  if (!B.uv) {
    for (int m = t >> 5; m < a.mx; m += W) inj_tq_lane(B, a, s, m, lane);
    return;
  }
  for (int m = t >> 5; m < a.mx; m += W) {
    InjLane L;
    inj_uv_load(L, B, a, m, lane);
    auto xch = [&](int v, int fl, int d) {
      const stack_c<float> x = v ? L.div[fl] : L.vor[fl];
      stack_c<float> o;
      if (d < 0) {
        o.x = __shfl_up_sync(0xffffffffu, x.x, 1);
        o.y = __shfl_up_sync(0xffffffffu, x.y, 1);
      } else {
        o.x = __shfl_down_sync(0xffffffffu, x.x, 1);
        o.y = __shfl_down_sync(0xffffffffu, x.y, 1);
      }
      return o;
    };
    InjNb nb;
    inj_uv_exchange(B, a.nx, lane, xch, nb);
    inj_uv_out(L, nb, B, a, s, m, lane);
  }
}

// kInject: K6_inject, whose phase 0 stages the Legendre rows alone and
// forms the coefficients while they and dft_inv land
// (sht_syn_stage_legendre, sht_inj_coef) in place of staging the
// coefficients (sht_syn_stage_coef); the phases after it are K6's.
template <bool kInject>
__global__ void __launch_bounds__(kInject ? SHT_INJ_THREADS : SHT_MAX_THREADS)
sht_synthesis_kernel(ShtSynArgs a, InjSynArgs ia, int ft, int lp) {
  extern __shared__ __align__(16) unsigned char sht_smem[];
  const ShtSynSmem s = sht_syn_carve(sht_smem, ft, lp, a.mx, a.nx, a.nlon);
  const ShtSynBlock b = sht_syn_block(a, ft, lp, blockIdx.x);
  const int t = threadIdx.x, T = blockDim.x;
  const ShtAsyncCopy cp;
  if constexpr (kInject)
    sht_syn_stage_legendre(cp, a, s, b, t, T);
  else
    sht_syn_stage_coef(cp, a, s, b, t, T);
  sht_async_commit();
  sht_syn_stage_dft(cp, a, s, t, T);
  sht_async_commit();
  if constexpr (kInject) sht_inj_coef(a, s, inj_blk(a, ia, b, lp), t, T);
  sht_async_wait<1>();
  __syncthreads();
  sht_syn_legendre(a, s, b, ft, lp, t, T);
  sht_async_wait<0>();
  __syncthreads();
  sht_syn_dft(a, s, b, ft, lp, t, T, nullptr);
}

// The checks both launches make; 0 or the error.
static int sht_syn_check(int device, const void* dft_inv, const void* cpol_g,
                         int B, int nlat, int nlon, int mx, int nx,
                         void* out) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || nlat <= 0 || (nlat & 1) || nlon <= 0 || mx <= 0 || nx <= 0 ||
      nlon % 4 || nx % 4 || !sht_aligned(dft_inv, 16) ||
      !sht_aligned(cpol_g, 16) || !sht_aligned(out, 8))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// spec (B, mx, nx) complex64, dft_inv (mx, nlon) complex64, cpol_g
// (nlat/2, mx, nx) f32, cosgr (nlat,), out (B, nlat, nlon) f32.
SPEEDY_API int sht_synthesis_launch(int device, const void* spec,
                                    const void* dft_inv, const void* cpol_g,
                                    const void* cosgr, int ncos, int B,
                                    int nlat, int nlon, int mx, int nx,
                                    void* out, void* stream) {
  static int smem_set[64];
  int code = sht_syn_check(device, dft_inv, cpol_g, B, nlat, nlon, mx, nx,
                           out);
  if (code) return code;
  if (!sht_aligned(spec, 16)) return (int)cudaErrorInvalidValue;
  int sms;
  size_t smem_max;
  cudaError_t err = sht_device_limits(device, &sms, &smem_max);
  if (err != cudaSuccess) return (int)err;
  const ShtSynTile tl = sht_syn_choose(B, nlat, nlon, mx, nx, sms, smem_max);
  const size_t smem = sht_syn_smem_bytes(tl.ft, tl.lp, mx, nx, nlon);
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  err = sht_smem_limit((const void*)sht_synthesis_kernel<false>, device, smem,
                       smem_set);
  if (err != cudaSuccess) return (int)err;
  const ShtSynArgs a = {(const sht_c*)spec, (const sht_c*)dft_inv,
                        (const float*)cpol_g, (const float*)cosgr,
                        ncos, B, nlat, nlon, mx, nx, (float*)out};
  const InjSynArgs none = {};
  sht_synthesis_kernel<false>
      <<<tl.blocks, tl.threads, smem, (cudaStream_t)stream>>>(a, none, tl.ft,
                                                              tl.lp);
  return (int)cudaGetLastError();
}

// K6_inject: K levels, nx <= 32; spec (4K + 1, mx, nx) complex64 (K5's
// analysis of [t, q, logp | u cos, v cos]), blob (6 mx nx + mx + nx) f32
// (inject_blob); K6's tables as above; out: the state vor, div, t (2, K,
// mx, nx), ps (2, mx, nx), tr (2, 1, K, mx, nx) complex64 and the grid
// (4K, nlat, nlon) f32 of [t, q | u, v] (u and v times cos).
SPEEDY_API int inject_synthesis_launch(
    int device, int K, const void* spec, const void* blob,
    const void* dft_inv, const void* cpol_g, const void* cosgr, int nlat,
    int nlon, int mx, int nx, void* vor, void* div, void* tem, void* ps,
    void* tr, void* out, void* stream) {
  static int smem_set[64];
  const int B = 4 * K;
  int code = sht_syn_check(device, dft_inv, cpol_g, B, nlat, nlon, mx, nx,
                           out);
  if (code) return code;
  if (K <= 0 || nx > 32 || !sht_aligned(spec, 8) || !sht_aligned(blob, 4))
    return (int)cudaErrorInvalidValue;
  int sms;
  size_t smem_max;
  cudaError_t err = sht_device_limits(device, &sms, &smem_max);
  if (err != cudaSuccess) return (int)err;
  const ShtSynTile tl = sht_inj_choose(B, nlat, nlon, mx, nx, sms, smem_max);
  const size_t smem = sht_syn_smem_bytes(tl.ft, tl.lp, mx, nx, nlon);
  if (smem > smem_max) return (int)cudaErrorInvalidValue;
  err = sht_smem_limit((const void*)sht_synthesis_kernel<true>, device, smem,
                       smem_set);
  if (err != cudaSuccess) return (int)err;
  const ShtSynArgs a = {nullptr, (const sht_c*)dft_inv,
                        (const float*)cpol_g, (const float*)cosgr,
                        2 * K, B, nlat, nlon, mx, nx, (float*)out};
  const InjSynArgs ia = {(const stack_c<float>*)spec, (const float*)blob,
                         (stack_c<float>*)vor, (stack_c<float>*)div,
                         (stack_c<float>*)tem, (stack_c<float>*)ps,
                         (stack_c<float>*)tr, K};
  sht_synthesis_kernel<true>
      <<<tl.blocks, tl.threads, smem, (cudaStream_t)stream>>>(a, ia, tl.ft,
                                                             tl.lp);
  return (int)cudaGetLastError();
}

// Host build of the column-physics bodies (column_moist.cuh,
// column_longwave.cuh, column_surface.cuh, column_pbl.cuh,
// column_shortwave.cuh, flux_accumulate.cuh): the same per-column code
// the CUDA kernels run, looped over the columns on the CPU (K9, K13 and
// K12 and K16 as their first designs ran them, one kernel after the
// other), and the kernels' blocks (K9 and K9_moist_shortwave,
// K10a_down_surface, K10b, K12 and K12_pbl_flux) with their threads
// written out as loops.  It is not part of the kernel library; the CPU
// tests compile it with a host C++ compiler
//   g++ -O2 -ffp-contract=off -shared -fPIC column_host.cpp -o lib.so
// and hold it against the plain PyTorch versions, and each block against
// the per-column bodies bit for bit, so that a logic error in a column
// body or a block shows without a card.  The entry points take the
// arguments of the CUDA launchers less the device and the stream, and
// return 0, or 1 for a K that is not compiled.

#include <string.h>

#include <memory>

#include "column_longwave.cuh"
#include "column_moist.cuh"
#include "column_pbl.cuh"
#include "column_shortwave.cuh"
#include "column_surface.cuh"

#define HOST_DISPATCH(CALL)                   \
  switch (K) {                                \
    case 5:                                   \
      if (is_double) CALL(double, 5)          \
      else CALL(float, 5)                     \
      break;                                  \
    case 7:                                   \
      if (is_double) CALL(double, 7)          \
      else CALL(float, 7)                     \
      break;                                  \
    case 8:                                   \
      if (is_double) CALL(double, 8)          \
      else CALL(float, 8)                     \
      break;                                  \
    default:                                  \
      return 1;                               \
  }

extern "C" int column_moist_host(int K, int is_double, const void* tg,
                                 const void* qg, const void* phig,
                                 const void* pslg, const void* blob, int G,
                                 void* out_f, void* out_i) {
#define CALL(T, KK)                                                        \
  {                                                                        \
    for (int c = 0; c < G; ++c)                                            \
      column_moist_at<T, KK>(c, G, (const T*)tg, (const T*)qg,             \
                             (const T*)phig, (const T*)pslg,               \
                             (const T*)blob, (T*)out_f, (long long*)out_i); \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

namespace {

// K9's block (the moist_block_* phases) and, with kSw, the shortwave's
// (the sw_block_* phases of K9_moist_shortwave), with the threads written
// out as loops and the shared memory and registers as arrays whose every
// byte starts as 0xff (NaN), so that a phase reading what no earlier
// phase wrote shows; C = 32 columns a block, as the kernel's.
template <typename T, int K, bool kSw>
void moist_block_host(const MoistIO<T>& io, const T* blob, const SwIO<T>& sw,
                      const T* sw_blob) {
  constexpr int C = 32;
  const MoistTab<T, K> tb(blob);
  std::unique_ptr<MoistShared<T, K, C>> sh(new MoistShared<T, K, C>);
  std::unique_ptr<SwShared<T, K, C>> sws(new SwShared<T, K, C>);
  std::unique_ptr<SwReg<T>[]> r(new SwReg<T>[K * C]);
  for (int b = 0; b * C < io.G; ++b) {
    memset(sh.get(), 0xff, sizeof *sh);
    memset(sws.get(), 0xff, sizeof *sws);
    memset(r.get(), 0xff, sizeof(SwReg<T>) * K * C);
    if constexpr (kSw)
      for (int k = 0; k < K; ++k)
        for (int x = 0; x < C; ++x)
          sw_block_start(io, sw, r[k * C + x], b * C + x, k);
    for (int k = 0; k < K; ++k)
      for (int x = 0; x < C; ++x) {
        const T rh = moist_block_levels(tb, io, *sh, b * C + x, x, k);
        if constexpr (kSw) sw_block_keep(io, *sws, rh, b * C + x, x, k);
      }
    for (int x = 0; x < C; ++x) moist_block_convmf(tb, io, *sh, b * C + x, x);
    for (int k = 0; k < K; ++k)
      for (int x = 0; x < C; ++x)
        moist_block_lscond(tb, io, *sh, b * C + x, x, k);
    for (int x = 0; x < C; ++x)
      moist_block_close(tb, io, *sh, b * C + x, x, r[x].itop, r[x].precls);
    if constexpr (kSw) {
      const ShortwaveTab<T, K> ts(sw_blob);
      for (int x = 0; x < C; ++x)
        sw_block_cloud(ts, io, *sh, *sws, r[x], b * C + x, x);
      for (int k = 0; k < K; ++k)
        for (int x = 0; x < C; ++x)
          sw_block_level(ts, io, sw, *sh, *sws, r[k * C + x], b * C + x, x,
                         k);
      for (int x = 0; x < C; ++x)
        sw_block_fluxes(ts, io, sw, *sws, r[x], b * C + x, x);
    }
  }
}

// K9 then K13, each over every column (the first designs in a row):
// column_shortwave_at reads K9's outputs from out_f and out_i.
template <typename T, int K>
void moist_shortwave_bodies(const MoistIO<T>& io, const T* blob,
                            const SwIO<T>& sw, const T* sw_blob) {
  const int G = io.G;
  for (int c = 0; c < G; ++c)
    column_moist_at<T, K>(c, G, io.tg, io.qg, io.phig, io.pslg, blob,
                          io.out_f, io.out_i);
  const T* f = io.out_f;
  const T* planes = f + (size_t)(6 * K) * G;
  ShortwaveIn<T> in;
  in.qg = f;
  in.rh = f + (size_t)(3 * K) * G;
  in.se = f + (size_t)K * G;
  in.phig = io.phig;
  in.precnv = planes + (size_t)3 * G;
  in.precls = planes + (size_t)4 * G;
  in.psg = planes;
  in.rps = planes + (size_t)G;
  in.fmask = sw.fmask;
  in.fsol = sw.fsol;
  in.ozupp = sw.ozupp;
  in.ozone = sw.ozone;
  in.zenit = sw.zenit;
  in.stratz = sw.stratz;
  in.albsfc = sw.albsfc;
  in.itop = io.out_i;
  for (int c = 0; c < G; ++c)
    column_shortwave_at<T, K>(c, G, in, sw_blob, sw.out);
}

}  // namespace

// K9's block; shortwave 1: K9_moist_shortwave's, sw_in the SW_N_PLANES
// planes in the order of SwIO, sw_out (5K + 5, G) (column_moist_launch's
// arguments).
extern "C" int column_moist_block_host(int K, int is_double, const void* tg,
                                       const void* qg, const void* phig,
                                       const void* pslg, const void* blob,
                                       int G, void* out_f, void* out_i,
                                       int shortwave,
                                       const void* const* sw_in, int n_sw,
                                       const void* sw_blob, void* sw_out) {
  if (shortwave && n_sw != SW_N_PLANES) return 1;
#define CALL(T, KK)                                                         \
  {                                                                         \
    const MoistIO<T> io = {(const T*)tg, (const T*)qg, (const T*)phig,      \
                           (const T*)pslg, G, (T*)out_f,                    \
                           (long long*)out_i};                              \
    if (shortwave)                                                          \
      moist_block_host<T, KK, true>(io, (const T*)blob,                     \
                                    sw_io<T>(sw_in, sw_out),                \
                                    (const T*)sw_blob);                     \
    else                                                                    \
      moist_block_host<T, KK, false>(io, (const T*)blob, SwIO<T>(),         \
                                     nullptr);                              \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

// K9 then K13 over every column, column_moist_block_host's arguments with
// shortwave 1.
extern "C" int moist_shortwave_host(int K, int is_double, const void* tg,
                                    const void* qg, const void* phig,
                                    const void* pslg, const void* blob, int G,
                                    void* out_f, void* out_i,
                                    const void* const* sw_in, int n_sw,
                                    const void* sw_blob, void* sw_out) {
  if (n_sw != SW_N_PLANES) return 1;
#define CALL(T, KK)                                                        \
  {                                                                        \
    const MoistIO<T> io = {(const T*)tg, (const T*)qg, (const T*)phig,     \
                           (const T*)pslg, G, (T*)out_f,                   \
                           (long long*)out_i};                             \
    moist_shortwave_bodies<T, KK>(io, (const T*)blob,                      \
                                  sw_io<T>(sw_in, sw_out),                 \
                                  (const T*)sw_blob);                      \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

// K10a_down_surface, K12 and K13 take their operands as an array of n_in
// pointers, in the order of the kernels' In structs; a wrong count
// returns 1 too.  down_surface_host runs the block's phases for one
// column at a time (down_surface_at, C = 1).
extern "C" int down_surface_host(int K, int is_double, const void* const* in,
                                 int n_in, const void* lw_blob,
                                 const void* sfc_blob, int G, int nlon,
                                 void* out) {
  if (n_in != DOWN_SURFACE_N_IN || nlon <= 0 || G % nlon != 0) return 1;
#define CALL(T, KK)                                                      \
  {                                                                      \
    const DownSurfaceIn<T> args = down_surface_in<T>(in);                \
    for (int c = 0; c < G; ++c)                                          \
      down_surface_at<T, KK>(c, G, nlon, args, (const T*)lw_blob,        \
                             (const T*)sfc_blob, (T*)out);               \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

// K10a_down_surface's block (the dnsfc_block_* phases) with its threads
// written out as loops and its shared memory and the surface warp's
// registers starting as NaN, as K9's above; C = 32 columns a block, as
// the kernel's, K level warps and the surface warp.
extern "C" int down_surface_block_host(int K, int is_double,
                                       const void* const* in, int n_in,
                                       const void* lw_blob,
                                       const void* sfc_blob, int G, int nlon,
                                       void* out) {
  if (n_in != DOWN_SURFACE_N_IN || nlon <= 0 || G % nlon != 0) return 1;
  constexpr int C = 32;
#define CALL(T, KK)                                                         \
  {                                                                         \
    const DownSurfaceIn<T> args = down_surface_in<T>(in);                   \
    const LongwaveTab<T, KK> tb((const T*)lw_blob);                         \
    const SurfaceTab<T> ts((const T*)sfc_blob);                             \
    std::unique_ptr<LwDownShared<T, KK, C>> sh(new LwDownShared<T, KK, C>); \
    std::unique_ptr<SfcReg<T>[]> r(new SfcReg<T>[C]);                       \
    for (int b = 0; b * C < G; ++b) {                                       \
      memset(sh.get(), 0xff, sizeof *sh);                                   \
      memset(r.get(), 0xff, sizeof(SfcReg<T>) * C);                         \
      for (int k = 0; k <= KK; ++k)                                         \
        for (int x = 0; x < C; ++x)                                         \
          dnsfc_block_load(tb, ts, G, nlon, args, (T*)out, *sh, r[x],       \
                           b * C + x, x, k);                                \
      for (int jb = 0; jb < 4; ++jb)                                        \
        for (int x = 0; x < C; ++x)                                         \
          dnsfc_block_band(G, (T*)out, *sh, b * C + x, x, jb);              \
      for (int k = 0; k <= KK; ++k)                                         \
        for (int x = 0; x < C; ++x)                                         \
          dnsfc_block_sums(tb, ts, G, (T*)out, *sh, r[x], b * C + x, x, k); \
    }                                                                       \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

extern "C" int radlw_up_host(int K, int is_double, const void* ta,
                             const void* ts, const void* slrd,
                             const void* slru_sfc, const void* dfabs,
                             const void* flux_bands, const void* st4a_mean,
                             const void* st4a_grad, const void* tau2,
                             const void* stratc, const void* blob, int G,
                             void* out) {
#define CALL(T, KK)                                                        \
  {                                                                        \
    for (int c = 0; c < G; ++c)                                            \
      radlw_up_at<T, KK>(c, G, (const T*)ta, (const T*)ts, (const T*)slrd, \
                         (const T*)slru_sfc, (const T*)dfabs,              \
                         (const T*)flux_bands, (const T*)st4a_mean,        \
                         (const T*)st4a_grad, (const T*)tau2,              \
                         (const T*)stratc, (const T*)blob, (T*)out);       \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

// K10b's block (the lwup_block_* phases) with its threads written out as
// loops and its shared memory starting as NaN, as K9's above; C = 32
// columns a block, as the kernel's.
extern "C" int radlw_up_block_host(int K, int is_double, const void* ta,
                                   const void* ts, const void* slrd,
                                   const void* slru_sfc, const void* dfabs,
                                   const void* flux_bands,
                                   const void* st4a_mean,
                                   const void* st4a_grad, const void* tau2,
                                   const void* stratc, const void* blob,
                                   int G, void* out) {
  constexpr int C = 32;
#define CALL(T, KK)                                                         \
  {                                                                         \
    const LongwaveTab<T, KK> tb((const T*)blob);                            \
    std::unique_ptr<LwUpShared<T, KK, C>> sh(new LwUpShared<T, KK, C>);     \
    std::unique_ptr<LwUpReg<T>[]> r(new LwUpReg<T>[KK * C]);                \
    for (int b = 0; b * C < G; ++b) {                                       \
      memset(sh.get(), 0xff, sizeof *sh);                                   \
      memset(r.get(), 0xff, sizeof(LwUpReg<T>) * KK * C);                   \
      for (int k = 0; k < KK; ++k)                                          \
        for (int x = 0; x < C; ++x)                                         \
          lwup_block_load(tb, G, (const T*)ta, (const T*)ts,                \
                          (const T*)slrd, (const T*)slru_sfc,               \
                          (const T*)dfabs, (const T*)flux_bands,            \
                          (const T*)st4a_mean, (const T*)st4a_grad,         \
                          (const T*)tau2, (const T*)stratc, *sh,            \
                          r[k * C + x], b * C + x, x, k);                   \
      for (int jb = 0; jb < 4; ++jb)                                        \
        for (int x = 0; x < C; ++x)                                         \
          lwup_block_band(G, *sh, b * C + x, x, jb);                        \
      for (int k = 0; k < KK; ++k)                                          \
        for (int x = 0; x < C; ++x)                                         \
          lwup_block_sums(tb, G, (T*)out, *sh, r[k * C + x], b * C + x, x,  \
                          k);                                               \
    }                                                                       \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

// K12 over every column; flux 1: then the window's flux sums over every
// column (K16's first design, flux_accumulate_at), on the step's hflux_i
// from out.  in, n_in, out, rsteps, delt2 as column_pbl_launch's.
extern "C" int column_pbl_host(int K, int is_double, int flux,
                               const void* const* in, int n_in,
                               const void* blob, int G, void* out,
                               double rsteps, double delt2) {
  if (n_in != PBL_N_IN + (flux ? PBL_FLUX_N_IN : 0)) return 1;
#define CALL(T, KK)                                                        \
  {                                                                        \
    const PblIn<T> args = pbl_in<T>(in);                                   \
    for (int c = 0; c < G; ++c)                                            \
      column_pbl_at<T, KK>(c, G, args, (const T*)blob, (T*)out);           \
    if (flux) {                                                            \
      const PblFlux<T> fl = pbl_flux<T>(in + PBL_N_IN, rsteps, delt2);     \
      FluxIO<T> io;                                                        \
      T* o = (T*)out + (size_t)(4 * KK) * G;                               \
      for (int f = 0; f < 4; ++f) {                                        \
        io.acc[f] = fl.acc[f];                                             \
        io.out[f] = o + (size_t)(1 + f) * G;                               \
      }                                                                    \
      io.diag[0] = fl.hflux_l;                                             \
      io.diag[1] = args.hflux_s;                                           \
      io.diag[2] = o;                                                      \
      io.diag[3] = fl.precnv;                                              \
      io.diag[4] = fl.precls;                                              \
      io.rsteps = fl.rsteps;                                               \
      io.delt2 = fl.delt2;                                                 \
      for (int c = 0; c < G; ++c) flux_accumulate_at(io, c);               \
    }                                                                      \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

namespace {

// K12's block (the pbl_block_* phases; with kFlux, K12_pbl_flux's) with
// its threads written out as loops and its shared memory starting as
// NaN, as K9's above.
template <typename T, int K, bool kFlux>
void pbl_block_host(const PblIn<T>& in, const PblFlux<T>& fl, const T* blob,
                    int G, T* out) {
  constexpr int C = 32;
  const PblTab<T, K> tb(blob);
  std::unique_ptr<PblShared<T, K, C>> sh(new PblShared<T, K, C>);
  std::unique_ptr<PblReg<T>[]> r(new PblReg<T>[K * C]);
  for (int b = 0; b * C < G; ++b) {
    memset(sh.get(), 0xff, sizeof *sh);
    memset(r.get(), 0xff, sizeof(PblReg<T>) * K * C);
    for (int k = 0; k < K; ++k)
      for (int x = 0; x < C; ++x)
        pbl_block_load<kFlux>(tb, in, fl, G, out, *sh, r[k * C + x],
                              b * C + x, x, k);
    for (int x = 0; x < C; ++x)
      pbl_block_vdifsc(tb, G, *sh, r[x], b * C + x, x);
    for (int k = 0; k < K; ++k)
      for (int x = 0; x < C; ++x)
        pbl_block_sums(tb, G, out, *sh, r[k * C + x], b * C + x, x, k);
  }
}

}  // namespace

// K12's block; flux 1: K12_pbl_flux's (column_pbl_host's arguments).
extern "C" int column_pbl_block_host(int K, int is_double, int flux,
                                     const void* const* in, int n_in,
                                     const void* blob, int G, void* out,
                                     double rsteps, double delt2) {
  if (n_in != PBL_N_IN + (flux ? PBL_FLUX_N_IN : 0)) return 1;
#define CALL(T, KK)                                                         \
  {                                                                         \
    const PblIn<T> args = pbl_in<T>(in);                                    \
    if (flux)                                                               \
      pbl_block_host<T, KK, true>(                                          \
          args, pbl_flux<T>(in + PBL_N_IN, rsteps, delt2), (const T*)blob,  \
          G, (T*)out);                                                      \
    else                                                                    \
      pbl_block_host<T, KK, false>(args, PblFlux<T>(), (const T*)blob, G,   \
                                   (T*)out);                                \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

extern "C" int column_shortwave_host(int K, int is_double,
                                     const void* const* in, int n_in,
                                     const void* blob, int G, void* out) {
  if (n_in != SHORTWAVE_N_IN) return 1;
#define CALL(T, KK)                                                        \
  {                                                                        \
    const ShortwaveIn<T> args = shortwave_in<T>(in);                       \
    for (int c = 0; c < G; ++c)                                            \
      column_shortwave_at<T, KK>(c, G, args, (const T*)blob, (T*)out);     \
  }
  HOST_DISPATCH(CALL)
#undef CALL
  return 0;
}

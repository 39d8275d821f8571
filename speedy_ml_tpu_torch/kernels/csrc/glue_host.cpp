// Host build of the arithmetic of K3, K17-K23 (window_gather.cuh,
// surface_forcing.cuh, inject_spectral.cuh, gate_check.cuh,
// window_select.cuh, slab_couple.cuh, slab_ocean.cuh, sst_by_date.cuh):
// K17's per-point body, K17b, K21, K22's SST form and K23 as loops over
// the grid points, K3,
// K20 and K22's push forms over their output elements; K17's row blocks and
// K18's first-design blocks with their threads written out as loops in
// phase order and their shared memory starting as NaN, so that a phase
// reading what an earlier one did not write shows; K19 as one loop over
// each variable.  It is not part of the kernel library; the CPU tests
// compile it with a host C++ compiler
//   g++ -O2 -ffp-contract=off -shared -fPIC glue_host.cpp -o lib.so
// and hold it against the plain PyTorch versions.  The entry points take
// the launch's arguments less the device and the stream, and return 0, or
// 1 for a K or an nx that the kernel does not take.

#include <string.h>

#include <memory>

#include "gate_check.cuh"
#include "inject_spectral.cuh"
#include "slab_couple.cuh"
#include "slab_ocean.cuh"
#include "sst_by_date.cuh"
#include "surface_forcing.cuh"
#include "window_gather.cuh"
#include "window_select.cuh"

namespace {

template <typename T>
SfIO<T> surface_forcing_io(int nlat, int nlon, const void* const* in,
                           void* sfc, void* frc, const double* scal,
                           const int* ix) {
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
  for (int k = 0; k < SC_COUNT; ++k) io.s.v[k] = (T)scal[k];
  for (int k = 0; k < IX_COUNT; ++k) io.s.ix[k] = ix ? ix[k] : 0;
  return io;
}

// K17's row blocks, a row at a time: the point threads' phase 1 (before
// the solar warp, so a read of the row's shared terms would see NaN), the
// solar warp's lanes, the barrier, the point threads' phase 2
template <typename T>
void surface_forcing_rows(const SfIO<T>& io, int nlat) {
  for (int j = 0; j < nlat; ++j) {
    SfRow<T> row;
    memset(&row, 0xff, sizeof row);
    for (int c = 0; c < io.nlon; ++c) sf_block_points(io, j, c);
    if (!io.frc) continue;
    for (int lane = 0; lane < 32; ++lane) sf_block_solar(io, row, j, lane);
    for (int c = 0; c < io.nlon; ++c) sf_block_solar_store(io, row, j, c);
  }
}

// K17 as the per-point body (block 0) or as the kernel's row blocks
// (block 1)
template <typename T>
void surface_forcing(int block, int nlat, int nlon, const void* const* in,
                     void* sfc, void* frc, const double* scal,
                     const int* ix) {
  const SfIO<T> io = surface_forcing_io<T>(nlat, nlon, in, sfc, frc, scal,
                                           ix);
  if (block)
    surface_forcing_rows(io, nlat);
  else
    for (long long i = 0; i < io.G; ++i) surface_forcing_at(io, i);
}

template <typename T>
void tisr(int nlat, int nlon, const void* slat, const void* clat, void* out,
          const double* scal) {
  SfScalars<T> s;
  for (int k = 0; k < SC_COUNT; ++k) s.v[k] = (T)scal[k];
  for (int k = 0; k < IX_COUNT; ++k) s.ix[k] = 0;
  const long long G = (long long)nlat * nlon;
  for (long long i = 0; i < G; ++i)
    tisr_at(s, (const T*)slat, (const T*)clat, nlon, (T*)out, i);
}

template <typename T, int K>
void inject(int mx, int nx, const void* spec, void* vor, void* div,
            void* tem, void* ps, void* tr, void* stk, const void* blob) {
  InjIO<T> io;
  io.spec = (const stack_c<T>*)spec;
  io.vor = (stack_c<T>*)vor;
  io.div = (stack_c<T>*)div;
  io.t = (stack_c<T>*)tem;
  io.ps = (stack_c<T>*)ps;
  io.tr = (stack_c<T>*)tr;
  io.stk = (stack_c<T>*)stk;
  io.mx = mx;
  io.nx = nx;
  const InjTab<T> tb((const T*)blob, mx, nx);
  std::unique_ptr<InjShared<T, K>> sh(new InjShared<T, K>);
  for (int m = 0; m < mx; ++m) {
    memset(sh.get(), 0xff, sizeof *sh);
    for (int k = 0; k < K; ++k)
      for (int n = 0; n < nx; ++n) inject_block_load(tb, io, *sh, m, n, k);
    for (int k = 0; k < K; ++k)
      for (int n = 0; n < nx; ++n) inject_block_vds(tb, io, *sh, m, n, k);
    for (int k = 0; k < K; ++k)
      for (int n = 0; n < nx; ++n) inject_block_uv(tb, io, *sh, m, n, k);
  }
}

template <typename T>
void gate(int K, long long G, const void* back, const double* bounds,
          void* ext, void* safe) {
  T e[GATE_EXTREMA], b[GATE_EXTREMA];
  for (int v = 0; v < GATE_VARS; ++v) {
    const T* f = (const T*)back + gate_offset(v, K, G);
    e[2 * v] = e[2 * v + 1] = f[0];
    for (long long i = 0; i < (long long)K * G; ++i) {
      e[2 * v] = gate_min(e[2 * v], f[i]);
      e[2 * v + 1] = gate_max(e[2 * v + 1], f[i]);
    }
  }
  for (int x = 0; x < GATE_EXTREMA; ++x) {
    ((T*)ext)[x] = e[x];
    b[x] = (T)bounds[x];
  }
  *(bool*)safe = gate_flag(e, b);
}

template <typename T>
void select_fields(int K, long long G, const void* out, const void* prev,
                   const void* safe, const void* atmo_in,
                   const void* logp_in, void* atmo, void* logp, void* ok) {
  SelIO<T> io;
  io.out = (const T*)out;
  io.prev = (const bool*)prev;
  io.safe = (const bool*)safe;
  io.atmo_in = (const T*)atmo_in;
  io.logp_in = (const T*)logp_in;
  io.atmo = (T*)atmo;
  io.logp = (T*)logp;
  io.ok = (bool*)ok;
  io.K = K;
  io.G = G;
  for (long long e = 0; e < (4LL * K + 1) * G; ++e)
    window_select_at(io, e);
}

}  // namespace

// K3 over its output elements, with the launch's arguments (src[4] null:
// the date form).
extern "C" int window_gather_host(void* const* src, long long atmo_size,
                                  long long grid_size, int n_classes,
                                  void* const* idx, void* const* mean,
                                  void* const* stdv, void* const* out,
                                  const long long* counts, const void* slat,
                                  const void* clat, const double* scal,
                                  int nlon) {
  if (n_classes < 1 || n_classes > MAX_CLASSES) return 1;
  const GatherArgs a =
      window_gather_args(src, atmo_size, grid_size, n_classes, idx, mean,
                         stdv, out, counts, slat, clat, scal, nlon);
  for (long long t = 0; t < a.start[n_classes]; ++t) window_gather_at(a, t);
  return 0;
}

// K17 over the grid: block 0, the per-point body; block 1, the kernel's
// row blocks.
extern "C" int surface_forcing_host(int is_double, int block, int nlat,
                                    int nlon, const void* const* in,
                                    void* sfc, void* frc, const double* scal,
                                    const int* ix) {
  if (is_double)
    surface_forcing<double>(block, nlat, nlon, in, sfc, frc, scal, ix);
  else
    surface_forcing<float>(block, nlat, nlon, in, sfc, frc, scal, ix);
  return 0;
}

// K17b over the grid.
extern "C" int tisr_host(int is_double, int nlat, int nlon, const void* slat,
                         const void* clat, void* out, const double* scal) {
  if (is_double)
    tisr<double>(nlat, nlon, slat, clat, out, scal);
  else
    tisr<float>(nlat, nlon, slat, clat, out, scal);
  return 0;
}

// K18's first-design blocks (K6_inject's reference: sht_host.cpp).
extern "C" int inject_block_host(int K, int is_double, int mx, int nx,
                                 const void* spec, void* vor, void* div,
                                 void* tem, void* ps, void* tr, void* stk,
                                 const void* blob) {
  if (nx > STACK_MAX_N) return 1;
#define CALL(T, KK) \
  inject<T, KK>(mx, nx, spec, vor, div, tem, ps, tr, stk, blob);
  switch (K) {
    case 5:
      if (is_double) CALL(double, 5) else CALL(float, 5)
      break;
    case 7:
      if (is_double) CALL(double, 7) else CALL(float, 7)
      break;
    case 8:
      if (is_double) CALL(double, 8) else CALL(float, 8)
      break;
    default:
      return 1;
  }
#undef CALL
  return 0;
}

// K19's reductions.
extern "C" int gate_host(int is_double, int K, long long G, const void* back,
                         const double* bounds, void* ext, void* safe) {
  if (is_double)
    gate<double>(K, G, back, bounds, ext, safe);
  else
    gate<float>(K, G, back, bounds, ext, safe);
  return 0;
}

// K20 over its output elements.
extern "C" int select_host(int is_double, int K, long long G,
                           const void* out, const void* prev,
                           const void* safe, const void* atmo_in,
                           const void* logp_in, void* atmo, void* logp,
                           void* ok) {
  if (is_double)
    select_fields<double>(K, G, out, prev, safe, atmo_in, logp_in, atmo,
                          logp, ok);
  else
    select_fields<float>(K, G, out, prev, safe, atmo_in, logp_in, atmo, logp,
                         ok);
  return 0;
}

// K21 over the grid points, with the launch's arguments; 1 for operands
// that do not fit the options.
extern "C" int slab_couple_host(int is_double, long long G,
                                const void* const* in, void* sfc, void* fx,
                                const double* scal, const int* ix,
                                double w_an, const int* op) {
  if (slab_check(in, sfc, fx, op)) return 1;
  if (is_double) {
    const SlabIO<double> io =
        slab_io<double>(G, in, sfc, fx, scal, ix, w_an, op);
    for (long long i = 0; i < G; ++i) slab_couple_at(io, i);
  } else {
    const SlabIO<float> io =
        slab_io<float>(G, in, sfc, fx, scal, ix, w_an, op);
    for (long long i = 0; i < G; ++i) slab_couple_at(io, i);
  }
  return 0;
}

// K22's push forms over every class's slot elements, with the launch's
// arguments; 1 for arguments that do not fit.
extern "C" int slab_ocean_push_host(int is_double, int n_classes,
                                    void* const* fb, void* const* idx,
                                    void* const* buf, void* const* mean,
                                    const long long* counts, const int* width,
                                    const int* fb_width, int W, int slot,
                                    double rw) {
  if (is_double) {
    SoPush<double> a;
    if (slab_push_args(&a, n_classes, fb, idx, buf, mean, counts, width,
                       fb_width, W, slot, rw))
      return 1;
    for (long long t = 0; t < a.start[n_classes]; ++t) slab_push_at(a, t);
  } else {
    SoPush<float> a;
    if (slab_push_args(&a, n_classes, fb, idx, buf, mean, counts, width,
                       fb_width, W, slot, rw))
      return 1;
    for (long long t = 0; t < a.start[n_classes]; ++t) slab_push_at(a, t);
  }
  return 0;
}

// K22's SST form over the grid points, with the launch's arguments; 1 for
// arguments that do not fit.
extern "C" int slab_ocean_sst_host(int is_double, int n_classes,
                                   void* const* out, void* const* mean_sst,
                                   void* const* std_sst,
                                   const long long* counts, const int* width,
                                   const void* src, const void* base,
                                   const void* land, long long G, double tmin,
                                   void* sst) {
  if (is_double) {
    SoSst<double> a;
    if (slab_sst_args(&a, n_classes, out, mean_sst, std_sst, counts, width,
                      src, base, land, G, tmin, sst))
      return 1;
    for (long long g = 0; g < G; ++g) slab_sst_at(a, g);
  } else {
    SoSst<float> a;
    if (slab_sst_args(&a, n_classes, out, mean_sst, std_sst, counts, width,
                      src, base, land, G, tmin, sst))
      return 1;
    for (long long g = 0; g < G; ++g) slab_sst_at(a, g);
  }
  return 0;
}

// K23 over the grid points, with the launch's arguments; 1 for a day
// outside the table.
extern "C" int sst_by_date_host(int is_double, const void* table,
                                long long n_days, long long day, long long G,
                                double bias, void* out) {
  if (G < 1 || day < 0 || day >= n_days) return 1;
  for (long long g = 0; g < G; ++g) {
    if (is_double)
      sst_by_date_at((const double*)table, day, G, bias, (double*)out, g);
    else
      sst_by_date_at((const float*)table, day, G, (float)bias, (float*)out,
                     g);
  }
  return 0;
}

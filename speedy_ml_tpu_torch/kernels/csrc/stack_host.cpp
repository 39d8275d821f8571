// Host build of K15's and K16's arithmetic (spectral_stack.cuh,
// flux_accumulate.cuh): K15's blocks with their threads written out as
// loops in phase order and their shared memory starting as NaN, so that a
// phase reading what the load phase did not write shows; K16's loop over
// the grid points.  It is not part of the kernel library; the CPU tests
// compile it with a host C++ compiler
//   g++ -O2 -ffp-contract=off -shared -fPIC stack_host.cpp -o lib.so
// and hold both against the plain PyTorch versions bit for bit.  The
// entry points take the launch's arguments less the device and the
// stream (the scalars as double, cast to the element type), and return
// 0, or 1 for a K or an nx that the kernel does not take.

#include <string.h>

#include <memory>

#include "flux_accumulate.cuh"
#include "spectral_stack.cuh"

namespace {

// One thread's outputs with a fault planted (a negative control the tests
// must see): 1, uvspec's n-1 and n+1 neighbours swapped; 2, the m = 0
// lapse-rate correction of phi left out.
template <typename T, int K>
void out_fault(const StackTab<T, K>& tb, const StackIO<T>& io,
               const StackShared<T, K>& sh, int m, int n, int k, int fault) {
  stack_block_out(tb, io, sh, m, n, k);
  const int nx = io.nx;
  const size_t MN = (size_t)io.mx * nx, c = (size_t)m * nx + n;
  if (fault == 1) {
    auto swapped = [&](const stack_c<T>(&vr)[K][STACK_MAX_N],
                       const stack_c<T>(&dv)[K][STACK_MAX_N], stack_c<T>* u,
                       stack_c<T>* v) {
      stack_uv(tb.uvdx[c], tb.uvdym[c], tb.uvdyp[c], tb.zrow[n],
               stack_at(vr[k], n + 1, nx), vr[k][n],
               stack_at(vr[k], n - 1, nx), stack_at(dv[k], n + 1, nx),
               dv[k][n], stack_at(dv[k], n - 1, nx), *u, *v);
    };
    if (io.dyn)
      swapped(sh.vor_d, sh.div_d, &io.dyn[(size_t)(4 * K + k) * MN + c],
              &io.dyn[(size_t)(5 * K + k) * MN + c]);
    if (io.phy)
      swapped(sh.vor_p, sh.div_p, &io.phy[(size_t)(3 * K + 1 + k) * MN + c],
              &io.phy[(size_t)(4 * K + 1 + k) * MN + c]);
  } else if (fault == 2 && io.phy) {
    io.phy[(size_t)(2 * K + k) * MN + c] =
        stack_phi(tb, io.phis[c], sh.t_p, n, k);
  }
}

template <typename T, int K>
void blocks(const StackIO<T>& io, const T* blob, int fault) {
  const StackTab<T, K> tb(blob, io.mx, io.nx);
  std::unique_ptr<StackShared<T, K>> sh(new StackShared<T, K>);
  for (int m = 0; m < io.mx; ++m) {
    memset(sh.get(), 0xff, sizeof *sh);
    for (int k = 0; k < K; ++k)
      for (int n = 0; n < io.nx; ++n) stack_block_load(io, *sh, m, n, k);
    for (int k = 0; k < K; ++k)
      for (int n = 0; n < io.nx; ++n) out_fault(tb, io, *sh, m, n, k, fault);
  }
}

template <typename T>
StackIO<T> stack_io(int mx, int nx, const void* vor, const void* div,
                    const void* tem, const void* ps, const void* tr,
                    const void* phis, int jd, int jp, void* dyn, void* phy) {
  StackIO<T> io;
  io.vor = (const stack_c<T>*)vor;
  io.div = (const stack_c<T>*)div;
  io.t = (const stack_c<T>*)tem;
  io.ps = (const stack_c<T>*)ps;
  io.tr = (const stack_c<T>*)tr;
  io.phis = (const stack_c<T>*)phis;
  io.dyn = (stack_c<T>*)dyn;
  io.phy = (stack_c<T>*)phy;
  io.jd = jd;
  io.jp = jp;
  io.mx = mx;
  io.nx = nx;
  return io;
}

template <typename T>
void fluxes(long long G, const void* const* acc, const void* const* diag,
            void* const* out, double rsteps, double delt2) {
  FluxIO<T> io;
  for (int f = 0; f < 4; ++f) {
    io.acc[f] = (const T*)acc[f];
    io.out[f] = (T*)out[f];
  }
  for (int f = 0; f < 5; ++f) io.diag[f] = (const T*)diag[f];
  io.rsteps = (T)rsteps;
  io.delt2 = (T)delt2;
  for (long long i = 0; i < G; ++i) flux_accumulate_at(io, i);
}

}  // namespace

// K15's blocks, with a fault planted in the output phase or none (0).
extern "C" int stack_block_host(int K, int is_double, int mx, int nx,
                                const void* vor, const void* div,
                                const void* tem, const void* ps,
                                const void* tr, const void* phis,
                                const void* blob, int jd, int jp, void* dyn,
                                void* phy, int fault) {
  if (nx > STACK_MAX_N) return 1;
#define CALL(T, KK)                                                         \
  blocks<T, KK>(stack_io<T>(mx, nx, vor, div, tem, ps, tr, phis, jd, jp,    \
                            dyn, phy),                                      \
                (const T*)blob, fault);
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

// K16 over G points.
extern "C" int flux_host(int is_double, long long G, const void* const* acc,
                         const void* const* diag, void* const* out,
                         double rsteps, double delt2) {
  if (is_double)
    fluxes<double>(G, acc, diag, out, rsteps, delt2);
  else
    fluxes<float>(G, acc, diag, out, rsteps, delt2);
  return 0;
}

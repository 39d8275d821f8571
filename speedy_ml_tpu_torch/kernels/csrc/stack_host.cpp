// Host build of K15's and K16's arithmetic (spectral_stack.cuh,
// flux_accumulate.cuh): K15's warps with their lanes written out as loops
// in phase order, the exchange of neighbours as copies and each lane's
// registers starting as NaN, so that a phase reading what the load phase
// did not set shows; K16's loop over the grid points.  It is not part of
// the kernel library; the CPU tests compile it with a host C++ compiler
//   g++ -O2 -ffp-contract=off -shared -fPIC stack_host.cpp -o lib.so
// and hold both against the plain PyTorch versions bit for bit.  The
// entry points take the launch's arguments less the device and the
// stream (the scalars as double, cast to the element type), and return
// 0, or 1 for a K or an nx that the kernel does not take.

#include <string.h>

#include <memory>
#include <utility>

#include "flux_accumulate.cuh"
#include "spectral_stack.cuh"

namespace {

// The lanes of every warp written out as loops, phase by phase, the
// exchange as a copy from the neighbouring lane, with a fault planted or
// none (0): 1, uvspec's n-1 and n+1 neighbours swapped; 2, the m = 0
// lapse-rate correction of phi left out (negative controls the tests must
// see).  A lane's struct starts as NaN bytes, so a phase reading what the
// load did not set shows.
template <typename T, int K>
void lanes(const StackIO<T>& io, const T* blob, int fault) {
  typedef StackLane<T, K> Ln;
  const StackTab<T, K> tb(blob, io.mx, io.nx);
  std::unique_ptr<Ln[]> L(new Ln[STACK_MAX_N]);
  std::unique_ptr<StackNb<T>[]> nb(new StackNb<T>[STACK_MAX_N]);
  for (int m = 0; m < io.mx; ++m)
    for (int k = 0; k < K; ++k) {
      memset(L.get(), 0xff, sizeof(Ln) * STACK_MAX_N);
      memset(nb.get(), 0xff, sizeof(StackNb<T>) * STACK_MAX_N);
      for (int n = 0; n < STACK_MAX_N; ++n)
        stack_lane_load(L[n], io, tb, m, n, k);
      for (int n = 0; n < STACK_MAX_N; ++n) {
        // a shuffle outside the warp returns the lane's own value
        auto xch = [&](stack_c<T> Ln::*f, int d) {
          const int j = n + d;
          return (j >= 0 && j < STACK_MAX_N) ? L[j].*f : L[n].*f;
        };
        stack_exchange(L[n], io, xch, nb[n]);
        if (fault == 1) {
          StackNb<T>& b = nb[n];
          for (stack_c<T>* d : {b.vd, b.dd, b.vp, b.dp}) std::swap(d[0], d[1]);
        }
      }
      for (int n = 0; n < STACK_MAX_N; ++n) {
        stack_lane_out(L[n], nb[n], io);
        if (fault == 2 && io.phy && L[n].live)
          io.phy[(size_t)(2 * K + k) * io.mx * io.nx + (size_t)m * io.nx +
                 n] = stack_lane_phi(L[n]);
      }
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

// K15's warps, with a fault planted or none (0).
extern "C" int stack_lanes_host(int K, int is_double, int mx, int nx,
                                const void* vor, const void* div,
                                const void* tem, const void* ps,
                                const void* tr, const void* phis,
                                const void* blob, int jd, int jp, void* dyn,
                                void* phy, int fault) {
  if (nx > STACK_MAX_N) return 1;
#define CALL(T, KK)                                                         \
  lanes<T, KK>(stack_io<T>(mx, nx, vor, div, tem, ps, tr, phis, jd, jp,    \
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

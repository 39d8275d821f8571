// Host build of K7's arithmetic (grid_dynamics.cuh): the first design's
// per-column loop, and the kernel's block (16 columns x K levels) with its
// threads written out as loops and its shared memory starting as NaN, so
// that a phase reading what no earlier phase wrote shows.  It is not part
// of the kernel library; the CPU tests compile it with a host C++
// compiler
//   g++ -O2 -ffp-contract=off -shared -fPIC grid_host.cpp -o lib.so
// and hold the per-column body against the plain PyTorch version and the
// block against the per-column body bit for bit.  The entry points take
// the launch's arguments less the device and the stream (rgas and akap
// as double, cast to the element type), and return 0, or 1 for a K that
// is not compiled.

#include <string.h>

#include <memory>
#include <vector>

#include "grid_dynamics.cuh"

namespace {

constexpr int C = 16;   // columns a block, as the kernel's

template <typename T>
GridIO<T> grid_io(const void* gall, const void* pu, const void* pv,
                  const void* pt, const void* pq, int nlat, int nlon,
                  void* out) {
  GridIO<T> io;
  io.gall = (const T*)gall;
  io.pu = (const T*)pu;
  io.pv = (const T*)pv;
  io.pt = (const T*)pt;
  io.pq = (const T*)pq;
  io.nlon = nlon;
  io.G = nlat * nlon;
  io.out = (T*)out;
  return io;
}

// The block's phases, thread (x, k) after thread.  fault (a negative
// control the tests must see; 0: none): 1, sigdt summed from the bottom
// half level up instead of from the top down; 2, sigdt read one half
// level off by the level phase.
template <typename T, int K>
void blocks(const GridTab<T, K>& tb, const GridIO<T>& io, int fault) {
  std::unique_ptr<GridShared<T, K, C>> sh(new GridShared<T, K, C>);
  std::vector<GridReg<T>> r(K * C);
  for (int b = 0; b * C < io.G; ++b) {
    memset(sh.get(), 0xff, sizeof *sh);
    for (int k = 0; k < K; ++k)
      for (int x = 0; x < C; ++x)
        grid_block_load(io, *sh, r[k * C + x], b * C + x, x, k);
    for (int x = 0; x < C; ++x) grid_block_sums(tb, io, *sh, b * C + x, x);
    for (int x = 0; x < C && b * C + x < io.G; ++x) {
      if (fault == 1) {
        // sigdt[j] = sum of the increments of levels j-1 .. 0, in that
        // order: the same terms, summed the other way round
        for (int j = 1; j <= K; ++j) {
          T s = T(0);
          for (int l = j - 1; l >= 0; --l) {
            const T puv = sh->puv[l][x];
            s = gd_add(s, gd_mul(-tb.dhs[l],
                                 gd_sub(gd_add(puv, sh->dv[l][x]),
                                        sh->dmean[x])));
          }
          sh->sigdt[j][x] = s;
        }
      } else if (fault == 2) {
        for (int j = 1; j < K; ++j) sh->sigdt[j][x] = sh->sigdt[j + 1][x];
      }
    }
    for (int k = 0; k < K; ++k)
      for (int x = 0; x < C; ++x)
        grid_block_level(tb, io, *sh, r[k * C + x], b * C + x, x, k);
  }
}

}  // namespace

#define GRID_DISPATCH(CALL)            \
  switch (K) {                         \
    case 5:                            \
      if (is_double) CALL(double, 5)   \
      else CALL(float, 5)              \
      break;                           \
    case 7:                            \
      if (is_double) CALL(double, 7)   \
      else CALL(float, 7)              \
      break;                           \
    case 8:                            \
      if (is_double) CALL(double, 8)   \
      else CALL(float, 8)              \
      break;                           \
    default:                           \
      return 1;                        \
  }

// The first design: one column after the other.
extern "C" int grid_column_host(int K, int is_double, const void* gall,
                                const void* pu, const void* pv,
                                const void* pt, const void* pq,
                                const void* blob, double rgas, double akap,
                                int nlat, int nlon, void* out) {
#define CALL(T, KK)                                                        \
  {                                                                        \
    const GridTab<T, KK> tb((const T*)blob, nlat, (T)rgas, (T)akap);       \
    const GridIO<T> io = grid_io<T>(gall, pu, pv, pt, pq, nlat, nlon, out); \
    for (int c = 0; c < io.G; ++c) grid_column_at(tb, io, c);              \
  }
  GRID_DISPATCH(CALL)
#undef CALL
  return 0;
}

// The kernel's blocks, with a fault injected between the phases or none.
extern "C" int grid_block_host(int K, int is_double, const void* gall,
                               const void* pu, const void* pv,
                               const void* pt, const void* pq,
                               const void* blob, double rgas, double akap,
                               int nlat, int nlon, void* out, int fault) {
#define CALL(T, KK)                                                        \
  {                                                                        \
    const GridTab<T, KK> tb((const T*)blob, nlat, (T)rgas, (T)akap);       \
    blocks<T, KK>(tb, grid_io<T>(gall, pu, pv, pt, pq, nlat, nlon, out),   \
                  fault);                                                  \
  }
  GRID_DISPATCH(CALL)
#undef CALL
  return 0;
}

// K14's index arithmetic, shared by the CUDA kernels (gram_update.cu) and
// their host build (dense_host.cpp, which the CPU tests compile with g++):
// the operand panel, the list of output tiles of one region and where
// each tile's sums go.
//
// The panel P (R, C, W) holds, for region r and sample c, the tiles'
// operands side by side: columns [0, Ap) are aug = [model (S) ; states
// with the odd nodes squared (n)] (A = S + n), zero past A; columns
// [Ap, W) are target (O), zero past O.  Ap and W - Ap round A and O up to
// whole tiles, so every tile reads whole, aligned rows of P.
//
// The outputs of a region are ss (A, A) and st (O, A).  A tile (I, J) is
// TILE x TILE outputs: rows I of ss or st, columns J; edge tiles are
// ragged.  Two lists: the full one (all of ss's T x T tiles, T =
// ceil(A / TILE), then st's ceil(O / TILE) x T) and the symmetric one,
// which keeps only ss's tiles with J >= I (T (T + 1) / 2 of them, then
// st's): an off-diagonal one adds its sums into ss[I, J] and their
// transpose into ss[J, I].  The products a_i a_j and a_j a_i round alike,
// so both lists give the same bits, and ss stays exactly symmetric when
// it starts so.

#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#define GU_HD __host__ __device__ __forceinline__
#else
#define GU_HD inline
#endif

#define GU_SS 0
#define GU_ST 1

struct GuTile {
  int kind;     // GU_SS or GU_ST
  int I;        // block row of ss or st
  int J;        // block column
  bool mirror;  // also adds the transpose into ss[J, I]
};

GU_HD int gu_blocks(int len, int tile) { return (len + tile - 1) / tile; }

// Tiles of one region: ss's (all, or those with J >= I), then st's
GU_HD int gu_tiles(int A, int O, int tile, bool sym) {
  const int T = gu_blocks(A, tile);
  return (sym ? T * (T + 1) / 2 : T * T) + gu_blocks(O, tile) * T;
}

GU_HD GuTile gu_decode(int t, int A, int tile, bool sym) {
  const int T = gu_blocks(A, tile);
  const int nss = sym ? T * (T + 1) / 2 : T * T;
  GuTile g;
  g.kind = GU_SS;
  if (t >= nss) {
    t -= nss;
    g.kind = GU_ST;
    g.I = t / T;
    g.J = t % T;
  } else if (!sym) {
    g.I = t / T;
    g.J = t % T;
  } else {
    int I = 0;
    while (t >= T - I) {
      t -= T - I;
      ++I;
    }
    g.I = I;
    g.J = I + t;
  }
  g.mirror = sym && g.kind == GU_SS && g.I < g.J;
  return g;
}

GU_HD int gu_min(int a, int b) { return a < b ? a : b; }

// Rows and columns of the tile inside ss or st
GU_HD int gu_rows(const GuTile& g, int A, int O, int tile) {
  return gu_min(tile, (g.kind == GU_SS ? A : O) - g.I * tile);
}
GU_HD int gu_cols(const GuTile& g, int A, int tile) {
  return gu_min(tile, A - g.J * tile);
}

// Offset of the tile's output (ii, jj) of region r in ss (GU_SS) or st
GU_HD size_t gu_direct(const GuTile& g, int r, int ii, int jj, int A, int O,
                       int tile) {
  const size_t rows = g.kind == GU_SS ? (size_t)A : (size_t)O;
  return ((size_t)r * rows + (size_t)g.I * tile + ii) * A +
         (size_t)g.J * tile + jj;
}
// Offset in ss of the transpose of output (ii, jj) of a mirrored tile
GU_HD size_t gu_mirror(const GuTile& g, int r, int ii, int jj, int A,
                       int tile) {
  return ((size_t)r * A + (size_t)g.J * tile + jj) * A + (size_t)g.I * tile +
         ii;
}

// The panel's aug width Ap and full width W
GU_HD int gu_panel_aug(int A, int tile) { return gu_blocks(A, tile) * tile; }
GU_HD int gu_panel_width(int A, int O, int tile) {
  return gu_panel_aug(A, tile) + gu_blocks(O, tile) * tile;
}

// P[r, c, w] from states (C, R, n), model (C, R, S) and target (C, R, O)
template <typename T>
GU_HD T gu_panel(const T* states, const T* model, const T* target, int R,
                 int n, int S, int O, int Ap, int r, int c, int w) {
  const size_t row = (size_t)c * R + r;
  if (w >= Ap) {
    const int o = w - Ap;
    return o < O ? target[row * O + o] : T(0);
  }
  if (w < S) return model[row * S + w];
  const int k = w - S;
  if (k >= n) return T(0);
  const T v = states[row * n + k];
  return (k & 1) ? v * v : v;
}

// First panel column of the tile's left operand (aug rows of ss, target
// rows of st) and of its right operand (aug)
GU_HD int gu_left_col(const GuTile& g, int Ap, int tile) {
  return (g.kind == GU_SS ? 0 : Ap) + g.I * tile;
}
GU_HD int gu_right_col(const GuTile& g, int tile) { return g.J * tile; }

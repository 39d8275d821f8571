// K20: the SPEEDY window's exit, for float and double, as CUDA device code
// and as plain C++ (glue_host.cpp compiles this very file for the CPU
// tests).
//
// Replaces (JAX package) the exit of speedy_ml_tpu/hybrid/model.py:
// 466-474 speedy_window (the grid fields stacked as (t, u, v, q) and
// logp) and the cycle's select on the gate (:632-639; the port's cycle
// selects rather than branches): from K6's synthesis of K15's physics
// stack at level 0, out (5K + 1, lat, lon) = [t, q, phi (K each), logp |
// u, v (K each)], one pass that writes
//   atmo (4, K, lat, lon) = [t, u, v, q], logp (lat, lon)
// and, given the previous state's flag and the gate's, ok = prev & safe
// with atmo = ok ? window : injected (the same for logp) and the flag
// ok.  Nothing is computed: every output is one of its inputs.
#pragma once

#include "column_common.cuh"

// out (5K + 1, G); prev, safe: one bool each, or null (no select; then
// atmo_in, logp_in and ok are not read or written); atmo_in (4, K, G),
// logp_in (G); atmo (4, K, G), logp (G), ok: one bool.
template <typename T>
struct SelIO {
  const T* out;
  const bool *prev, *safe;
  const T *atmo_in, *logp_in;
  T *atmo, *logp;
  bool* ok;
  int K;
  long long G;
};

// the field of `out` that gives variable v (0 t, 1 u, 2 v, 3 q) at level k
COL_HD long long sel_field(int var, int K, int k) {
  return var == 0 ? k : var == 1 ? 3 * K + 1 + k : var == 2 ? 4 * K + 1 + k
                                                            : K + k;
}

// output element e of the (4K + 1) G: plane p = e / G (the 4K planes of
// atmo, then logp), point i = e % G; element 0 also writes the flag
template <typename T>
COL_HD void window_select_at(const SelIO<T>& io, long long e) {
  const int K = io.K;
  const long long G = io.G;
  const int p = (int)(e / G);
  const long long i = e - (long long)p * G;
  const bool sel = io.prev != nullptr;
  const bool ok = sel && *io.prev && *io.safe;
  const long long src = p < 4 * K ? sel_field(p / K, K, p % K) : 3 * K;
  const T w = io.out[src * G + i];
  if (p < 4 * K)
    io.atmo[e] = (!sel || ok) ? w : io.atmo_in[e];
  else
    io.logp[i] = (!sel || ok) ? w : io.logp_in[i];
  if (sel && e == 0) *io.ok = ok;
}

// K19: the injection's safety gate, for float and double, as CUDA device
// code and as plain C++ (glue_host.cpp compiles this very file for the
// CPU tests).
//
// Replaces (JAX package) the gate of speedy_ml_tpu/hybrid/model.py:
// 423-426 (ppo_iogrid.f90:563-577): the smallest and the largest value of
// each of u, v, t and q on the grid after the double transform, and the
// flag
//   u_min >= -150 & u_max <= 150 & v_min >= -120 & v_max <= 120
//   & t_min >= 160 & t_max <= 330 & q_min >= -6 & q_max <= 30.
// torch.amin and torch.amax propagate a NaN, so a NaN anywhere makes
// its extrema NaN and the flag false; CUDA's fminf and fmaxf drop a NaN,
// so the reductions here use gate_min and gate_max, which keep it.  The
// extrema are exact whatever the order of the reduction.
#pragma once

#include "column_common.cuh"

// the extrema, in the gate's order: u, v, t, q (min, max) each
enum { GATE_U, GATE_V, GATE_T, GATE_Q, GATE_VARS };
#define GATE_EXTREMA (2 * GATE_VARS)

// min and max that keep a NaN of either operand
template <typename T>
COL_HD T gate_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T>
COL_HD T gate_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// The stack K6 returned, (4K, lat, lon) = [t, q, u, v] (K levels each):
// the first element of variable v (GATE_*) in it.
COL_HD long long gate_offset(int var, int K, long long G) {
  // t at 0, q at K, u at 2K, v at 3K fields
  const int field = var == GATE_T ? 0 : var == GATE_Q ? K
                    : var == GATE_U ? 2 * K : 3 * K;
  return (long long)field * G;
}

// ext[2 v] min, ext[2 v + 1] max of variable v; the bounds lo/hi of v at
// bounds[2 v], bounds[2 v + 1]
template <typename T>
COL_HD bool gate_flag(const T* ext, const T* bounds) {
  bool ok = true;
  for (int v = 0; v < GATE_VARS; ++v)
    ok = ok && ext[2 * v] >= bounds[2 * v] &&
         ext[2 * v + 1] <= bounds[2 * v + 1];
  return ok;
}

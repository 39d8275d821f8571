// K16: the window's flux sums of one leapfrog step, for float and double,
// as CUDA device code and as plain C++ (stack_host.cpp compiles this very
// file for the CPU tests).
//
// Replaces (JAX package) speedy_ml_tpu/gcm.py:273-280, the
// FluxAccumulator update of GCM.leapfrog.  Per grid point:
//   hflux_x + diag.hflux_x * rsteps      (x = l, s, i; rsteps = 1/nsteps_day)
//   precip + ((precnv + precls) * delt2) / 2
// into new fields (the accumulator stays immutable).  Every operation is
// rounded apart (gd_add, gd_mul), in the plain version's order, so the
// two agree bit for bit; the division by 2 is the multiplication by 0.5,
// the same correctly rounded value.
#pragma once

#include "column_common.cuh"

// acc: hflux_l, hflux_s, hflux_i, precip; diag: hflux_l, hflux_s,
// hflux_i, precnv, precls; out: the four new sums (G points each).
template <typename T>
struct FluxIO {
  const T* acc[4];
  const T* diag[5];
  T* out[4];
  T rsteps, delt2;
};

template <typename T>
COL_HD void flux_accumulate_at(const FluxIO<T>& io, long long i) {
#pragma unroll
  for (int f = 0; f < 3; ++f)
    io.out[f][i] = gd_add(io.acc[f][i], gd_mul(io.diag[f][i], io.rsteps));
  const T pr = gd_add(io.diag[3][i], io.diag[4][i]);
  io.out[3][i] =
      gd_add(io.acc[3][i], gd_mul(gd_mul(pr, io.delt2), T(0.5)));
}

// The window's flux sums of one leapfrog step, for float and double, as
// CUDA device code and as plain C++ (column_host.cpp and stack_host.cpp
// compile this very file for the CPU tests).  On the card they are a
// phase of K12_pbl_flux (column_pbl.cuh pbl_block_load): the warp that
// forms the sea-ice flux forms the four sums of its columns.
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

// One heat-flux sum: acc + diag * rsteps.
template <typename T>
COL_HD T flux_heat_sum(T acc, T diag, T rsteps) {
  return gd_add(acc, gd_mul(diag, rsteps));
}

// The precipitation sum: acc + ((precnv + precls) * delt2) * 0.5.
template <typename T>
COL_HD T flux_precip_sum(T acc, T precnv, T precls, T delt2) {
  const T pr = gd_add(precnv, precls);
  return gd_add(acc, gd_mul(gd_mul(pr, delt2), T(0.5)));
}

// acc: hflux_l, hflux_s, hflux_i, precip; diag: hflux_l, hflux_s,
// hflux_i, precnv, precls; out: the four new sums (G points each).
template <typename T>
struct FluxIO {
  const T* acc[4];
  const T* diag[5];
  T* out[4];
  T rsteps, delt2;
};

// Point i of the four sums, through memory (the host reference loop).
template <typename T>
COL_HD void flux_accumulate_at(const FluxIO<T>& io, long long i) {
#pragma unroll
  for (int f = 0; f < 3; ++f)
    io.out[f][i] = flux_heat_sum(io.acc[f][i], io.diag[f][i], io.rsteps);
  io.out[3][i] = flux_precip_sum(io.acc[3][i], io.diag[3][i], io.diag[4][i],
                                 io.delt2);
}

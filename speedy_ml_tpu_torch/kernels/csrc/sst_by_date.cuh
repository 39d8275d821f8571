// K23 (the daily SST of a climatology table with the bias ramp), for
// float and double, as CUDA device code and as plain C++ (glue_host.cpp
// compiles this very file for the CPU tests).
//
// Replaces (JAX package) HybridAtmosphere.sst_by_date,
// speedy_ml_tpu/hybrid/model.py:546-553 (get_sst_by_date,
// mpires.f90:1679-1725): the table's day (hour_of_year // 24) % 365,
// dynamic_index_in_dim, then where(sst > 273, sst + bias, sst), the bias
// cast to the table's type first (jnp.asarray(sst_bias, dtype)).
//
// One grid point g: out[g] = v > 273 ? v + bias : v, v = table[day * G +
// g].  The comparison keeps NaN (NaN > 273 is false), as jnp.where does.
#pragma once

#include "column_common.cuh"

// the temperature above which the bias applies: open water (the
// non_stationary_ocn_climo ramp of get_sst_by_date)
#define SBD_T_OPEN 273.0

template <typename T>
COL_HD T sst_by_date_v(T v, T bias) {
  return v > T(SBD_T_OPEN) ? v + bias : v;
}

// Point g of the day's plane: table (n_days, G) flattened, day in [0,
// n_days)
template <typename T>
COL_HD void sst_by_date_at(const T* table, long long day, long long G,
                           T bias, T* out, long long g) {
  out[g] = sst_by_date_v(table[day * G + g], bias);
}

// Shared by the column-physics bodies (column_moist.cuh,
// column_longwave.cuh): they compile as CUDA device code and, with a
// host C++ compiler, as plain functions.  Only exp and rint leave the
// four basic operations; both have a float and a double form.
#pragma once

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#define COL_HD __host__ __device__ __forceinline__
#else
#define COL_HD inline
#endif

COL_HD float col_exp(float x) { return expf(x); }
COL_HD double col_exp(double x) { return exp(x); }
// round half to even, as torch.round does
COL_HD float col_rint(float x) { return rintf(x); }
COL_HD double col_rint(double x) { return rint(x); }

template <typename T>
COL_HD T col_max(T a, T b) {
  return a > b ? a : b;
}
template <typename T>
COL_HD T col_min(T a, T b) {
  return a < b ? a : b;
}

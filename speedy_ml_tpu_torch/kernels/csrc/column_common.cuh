// Shared by the column-physics bodies (column_moist.cuh,
// column_longwave.cuh, column_surface.cuh, column_pbl.cuh,
// column_shortwave.cuh) and the headers of K7, K15-K20
// (grid_dynamics.cuh, spectral_stack.cuh, flux_accumulate.cuh,
// surface_forcing.cuh, inject_spectral.cuh, gate_check.cuh,
// window_select.cuh): they compile as CUDA device code and, with a host
// C++ compiler, as plain functions.  Only exp, sqrt, pow, rint, cos, sin
// and acos leave the four basic operations; each has a float and a
// double form, the function PyTorch's own kernel calls for the same
// operation.
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
COL_HD float col_sqrt(float x) { return sqrtf(x); }
COL_HD double col_sqrt(double x) { return sqrt(x); }
// torch.pow(x, e) for a scalar e other than 2 and 3, which PyTorch
// computes as the products x*x and x*x*x: powf / pow
COL_HD float col_pow(float x, float e) { return powf(x, e); }
COL_HD double col_pow(double x, double e) { return pow(x, e); }
// round half to even, as torch.round does
COL_HD float col_rint(float x) { return rintf(x); }
COL_HD double col_rint(double x) { return rint(x); }
COL_HD float col_cos(float x) { return cosf(x); }
COL_HD double col_cos(double x) { return cos(x); }
COL_HD float col_sin(float x) { return sinf(x); }
COL_HD double col_sin(double x) { return sin(x); }
COL_HD float col_acos(float x) { return acosf(x); }
COL_HD double col_acos(double x) { return acos(x); }

// The four basic operations rounded apart: the _rn intrinsics on the
// device, which are never contracted into an FMA whatever the source's
// flags; plain operators on the host (built with -ffp-contract=off).
// K7, K15 and K16 write every operation with them, in the order of their
// plain versions.
COL_HD float gd_add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
COL_HD float gd_sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
COL_HD float gd_mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
COL_HD double gd_add(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}
COL_HD double gd_sub(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dsub_rn(a, b);
#else
  return a - b;
#endif
}
COL_HD double gd_mul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

template <typename T>
COL_HD T col_max(T a, T b) {
  return a > b ? a : b;
}
template <typename T>
COL_HD T col_min(T a, T b) {
  return a < b ? a : b;
}

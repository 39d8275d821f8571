// K24 (SPPT: the AR(1) spectral pattern and the perturbation of the
// physics tendencies), for float and double, as CUDA device code and as
// plain C++ (optional_host.cpp compiles this very file for the CPU tests).
//
// Replaces (JAX package) speedy_ml_tpu/physics/sppt.py:54-68
// (SPPT.init_state, step, grid_pattern), physics/driver.py:290-296 (the
// (1 + pattern) factor on the four tendencies) and the pattern's taper in
// gcm.py:252-268, which XLA fused into the leapfrog step.
//
// Every operation is rounded apart (gd_add/gd_mul), in the order of the
// plain versions (kernels/sppt.py): the AR(1) step phi * s + sigma *
// clip(eta), on the real and the imaginary part alike; the perturbation
// (1 + clip(p, -1, 1) * mu[k]) * t.  The clips keep NaN, as torch.clamp
// does.
#pragma once

#include "column_common.cuh"

template <typename T>
COL_HD T sppt_clip(T v, T lim) {
  return v < -lim ? -lim : (v > lim ? lim : v);
}

// Element e (a real or imaginary part) of the pattern: s, eta interleaved
// (re, im) of (K, MN) coefficients, sigma (MN,) per coefficient.
template <typename T>
COL_HD void sppt_ar1_at(const T* s, const T* eta, const T* sigma, T phi,
                        T clip, T* out, long long e, long long MN) {
  const T sg = sigma[(e >> 1) % MN];
  out[e] = gd_add(gd_mul(phi, s[e]), gd_mul(sg, sppt_clip(eta[e], clip)));
}

// The factor of grid point g of level k: 1 + clip(p, -1, 1) * mu[k], or
// 1 + p without mu (a tapered pattern).
template <typename T>
COL_HD T sppt_factor(const T* pattern, const T* mu, int k, long long at) {
  const T p = pattern[at];
  const T r = mu ? gd_mul(sppt_clip(p, T(1)), mu[k]) : p;
  return gd_add(T(1), r);
}

// Level k, point g of each of the four tendencies, in place.
template <typename T>
COL_HD void sppt_perturb_at(const T* pattern, const T* mu, T* const* tends,
                            int k, long long G, long long g) {
  const long long at = (long long)k * G + g;
  const T f = sppt_factor(pattern, mu, k, at);
  for (int i = 0; i < 4; ++i) tends[i][at] = gd_mul(f, tends[i][at]);
}

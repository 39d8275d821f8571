// K24: SPPT, in two forms (the arithmetic: sppt.cuh, which says what is
// computed).  With sppt_on and a state carrying the pattern, each leapfrog
// step launches the AR(1) form once (before the pattern's K6 synthesis)
// and the perturbation form once (after the physics step's last column
// kernel, and after K25 when RDF is on).
//
// Replaces (JAX package) speedy_ml_tpu/physics/sppt.py:54-68 and
// physics/driver.py:290-296 (gcm.py:252-268), fused by XLA into the step.
// In/out at T30L8: the AR(1) form reads the pattern, the draw (7,936
// complex coefficients each, 63 KB in float32) and sigma, writes 63 KB;
// the perturbation form reads the grid pattern and four (8, 48, 96)
// tendencies (5 x 147 KB in float32) and writes the four.
//
// Bound on an H100 SXM: memory, 0.19 MB (AR(1), 0.00006 ms) and 1.33 MB
// (perturbation, 0.0004 ms) at 3.35 TB/s: launch floors.  Design: the
// first, simple one; a thread a real element of the pattern, or a grid
// point and level, neighbouring threads on neighbouring elements.

#include "common.cuh"
#include "sppt.cuh"

constexpr int kSpptBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kSpptBlock)
    sppt_ar1_kernel(const T* __restrict__ s, const T* __restrict__ eta,
                    const T* __restrict__ sigma, T phi, T clip,
                    T* __restrict__ out, long long n, long long MN) {
  const long long e = (long long)blockIdx.x * kSpptBlock + threadIdx.x;
  if (e < n) sppt_ar1_at(s, eta, sigma, phi, clip, out, e, MN);
}

template <typename T>
struct SpptTends {
  T* t[4];
};

template <typename T>
__global__ void __launch_bounds__(kSpptBlock)
    sppt_perturb_kernel(const T* __restrict__ pattern,
                        const T* __restrict__ mu, SpptTends<T> tends, int K,
                        long long G) {
  const long long i = (long long)blockIdx.x * kSpptBlock + threadIdx.x;
  if (i >= (long long)K * G) return;
  sppt_perturb_at(pattern, mu, tends.t, (int)(i / G), G, i % G);
}

// state, eta, out: (K, MN) complex of the element type (is_double:
// double, else float), sigma (MN,) real; phi and clip cast to the type.
SPEEDY_API int sppt_ar1_launch(int device, int is_double, int K,
                               long long MN, const void* state,
                               const void* eta, const void* sigma,
                               double phi, double clip, void* out,
                               void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || MN < 1 || !state || !eta || !sigma || !out)
    return (int)cudaErrorInvalidValue;
  const long long n = 2LL * K * MN;
  const unsigned grid = (unsigned)((n + kSpptBlock - 1) / kSpptBlock);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    sppt_ar1_kernel<double><<<grid, kSpptBlock, 0, s>>>(
        (const double*)state, (const double*)eta, (const double*)sigma, phi,
        clip, (double*)out, n, MN);
  else
    sppt_ar1_kernel<float><<<grid, kSpptBlock, 0, s>>>(
        (const float*)state, (const float*)eta, (const float*)sigma,
        (float)phi, (float)clip, (float*)out, n, MN);
  return (int)cudaGetLastError();
}

// pattern (K, G), mu (K,) or null, tends: four (K, G) tendencies written
// in place.
template <typename T>
static int perturb(const void* pattern, const void* mu, void* const* tends,
                   int K, long long G, cudaStream_t s) {
  SpptTends<T> t;
  for (int i = 0; i < 4; ++i) {
    if (!tends[i]) return (int)cudaErrorInvalidValue;
    t.t[i] = (T*)tends[i];
  }
  const long long n = (long long)K * G;
  const unsigned grid = (unsigned)((n + kSpptBlock - 1) / kSpptBlock);
  sppt_perturb_kernel<T><<<grid, kSpptBlock, 0, s>>>(
      (const T*)pattern, (const T*)mu, t, K, G);
  return (int)cudaGetLastError();
}

SPEEDY_API int sppt_perturb_launch(int device, int is_double, int K,
                                   long long G, const void* pattern,
                                   const void* mu, void* const* tends,
                                   void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || G < 1 || !pattern || !tends) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? perturb<double>(pattern, mu, tends, K, G, s)
                   : perturb<float>(pattern, mu, tends, K, G, s);
}

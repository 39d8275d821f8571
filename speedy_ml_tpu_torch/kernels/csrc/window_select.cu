// K20: the SPEEDY window's exit, one thread per output element (what it
// writes: window_select.cuh).
//
// Replaces (JAX package) speedy_ml_tpu/hybrid/model.py:466-474, the
// stack of speedy_window's grid fields, and the cycle's select on the
// gate (:632-639).  In: 41 fields of 4,608 floats at T30L8 (the
// synthesis of the physics stack; phi's 8 are not read) and, with the
// select, the injected 33 fields and two flags; out: 33 fields and a
// flag.
//
// Bound on an H100 SXM: memory, and latency-sized: 33 fields read and
// written (0.61 MB each way), 0.36 us at 3.35 TB/s, plus the injected 33
// fields read where ok is false.  Design: one thread per output element
// (152,064 at T30L8, blocks of 256), each one load and one store,
// coalesced within a field.  (A first version, a thread per grid point
// walking its 33 fields, took 8.3 us on an H100: its loads waited on the
// stores before them.)

#include "common.cuh"
#include "window_select.cuh"

constexpr int kSelBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kSelBlock)
    window_select_kernel(const SelIO<T> io, long long n) {
  const long long e = (long long)blockIdx.x * kSelBlock + threadIdx.x;
  if (e < n) window_select_at(io, e);
}

template <typename T>
static void launch(int K, long long G, const void* out, const void* prev,
                   const void* safe, const void* atmo_in,
                   const void* logp_in, void* atmo, void* logp, void* ok,
                   cudaStream_t s) {
  SelIO<T> io;
  io.out = (const T*)out;
  io.prev = (const bool*)prev;
  io.safe = (const bool*)safe;
  io.atmo_in = (const T*)atmo_in;
  io.logp_in = (const T*)logp_in;
  io.atmo = (T*)atmo;
  io.logp = (T*)logp;
  io.ok = (bool*)ok;
  io.K = K;
  io.G = G;
  const long long n = (4LL * K + 1) * G;
  const unsigned grid = (unsigned)((n + kSelBlock - 1) / kSelBlock);
  window_select_kernel<T><<<grid, kSelBlock, 0, s>>>(io, n);
}

// out (5K + 1, G) of the element type (is_double: double); prev, safe:
// one bool each, both null for no select (then atmo_in, logp_in and ok
// may be null too); atmo_in, atmo (4, K, G); logp_in, logp (G).
SPEEDY_API int window_select_launch(int device, int is_double, int K,
                                    long long G, const void* out,
                                    const void* prev, const void* safe,
                                    const void* atmo_in, const void* logp_in,
                                    void* atmo, void* logp, void* ok,
                                    void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0 || G <= 0 || (!prev) != (!safe) ||
      (prev && (!atmo_in || !logp_in || !ok)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    launch<double>(K, G, out, prev, safe, atmo_in, logp_in, atmo, logp, ok,
                   s);
  else
    launch<float>(K, G, out, prev, safe, atmo_in, logp_in, atmo, logp, ok,
                  s);
  return (int)cudaGetLastError();
}

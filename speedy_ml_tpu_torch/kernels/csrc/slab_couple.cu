// K21: the persistent surface's flux accumulation and the daily slab
// coupler, one thread per grid point (the arithmetic: slab_couple.cuh,
// which says what is computed).  The coupled cycle with persist_surface
// launches it once after its window (accumulate, or on every fourth cycle
// couple), GCM.run_days once a day (the day form).
//
// Replaces (JAX package) speedy_ml_tpu/physics/land_sea.py:244-331
// couple_daily + sstan_for_window, and the accumulation and selects of
// hybrid/model.py:640-659 (with gcm.py:322-332, the day loop's exchange).
// In: at T30 ~27 planes of 4,608 values when coupling (the months that
// forin5 and forint read, the carry, six coefficients, the sums and the
// window's sums), 8 when accumulating; out: 10 surface planes and 4 sums.
//
// Bound on an H100 SXM: memory, and launch-sized: ~41 planes of float32,
// 0.76 MB, 0.0002 ms at 3.35 TB/s.  Design: the first, simple one; a
// thread per point issues every load of its point, then forms the sums,
// the climatology and the slab models in registers and stores once.
// Every operation is rounded apart in the plain version's order
// (compiled without FMA contraction, SOURCE_FLAGS in kernels/build.py).
// The device-scalar form reads the month indices and weights from device
// memory: a captured CUDA graph of the cycle (hybrid/graph.py) refills
// them before each replay.

#include "common.cuh"
#include "slab_couple.cuh"

constexpr int kSlabBlock = 128;

// DEV: the device-scalar form, which reads K17's scalars and month
// indices from sdev (sf_scalars_from) in place of io.s: one thread
// copies the operands into shared memory with them filled in, and the
// block reads them there (0.0027 ms; a copy in each thread's local
// memory took 0.0034, the by-value form 0.0021: PERF.md)
template <typename T, bool DEV>
__global__ void __launch_bounds__(kSlabBlock)
    slab_couple_kernel(const SlabIO<T> io, const double* __restrict__ sdev) {
  const long long i = (long long)blockIdx.x * kSlabBlock + threadIdx.x;
  if constexpr (DEV) {
    __shared__ SlabIO<T> d;
    if (threadIdx.x == 0) {
      d = io;
      sf_scalars_from(d.s, sdev);
    }
    __syncthreads();
    if (i < d.G) slab_couple_at(d, i);
  } else {
    if (i < io.G) slab_couple_at(io, i);
  }
}

template <typename T>
static void launch(long long G, const void* const* in, void* sfc, void* fx,
                   const double* scal, const int* ix, double w_an,
                   const int* op, const double* sdev, cudaStream_t stream) {
  static const double kNoScal[SC_COUNT] = {};
  static const int kNoIx[IX_COUNT] = {};
  const SlabIO<T> io = slab_io<T>(G, in, sfc, fx, sdev ? kNoScal : scal,
                                  sdev ? kNoIx : ix, w_an, op);
  const unsigned grid = (unsigned)((G + kSlabBlock - 1) / kSlabBlock);
  if (sdev)
    slab_couple_kernel<T, true><<<grid, kSlabBlock, 0, stream>>>(io, sdev);
  else
    slab_couple_kernel<T, false><<<grid, kSlabBlock, 0, stream>>>(io,
                                                                  nullptr);
}

// in: IN_COUNT pointers (slab_couple.cuh IN_* order), the ones a form
// does not read null; sfc (SL_PLANES, G) when coupling, fx (FX_PLANES, G)
// when a window is given; scal: K17's SC_COUNT doubles, ix: its IX_COUNT
// ints (kernels/surface_forcing.py), w_an: the anomaly's forint weight,
// op: OP_COUNT ints (kernels/slab_couple.py OPTIONS).  sdev: null, or the
// device-scalar form's SC_COUNT + IX_COUNT doubles in device memory
// (sf_scalars_from), with scal and ix null.
SPEEDY_API int slab_couple_launch(int device, int is_double, long long G,
                                  const void* const* in, void* sfc,
                                  void* fx, const double* scal,
                                  const int* ix, double w_an, const int* op,
                                  const double* sdev, void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G <= 0 || !in || (sdev ? (scal || ix) : (!scal || !ix)) || !op ||
      slab_check(in, sfc, fx, op))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    launch<double>(G, in, sfc, fx, scal, ix, w_an, op, sdev, s);
  else
    launch<float>(G, in, sfc, fx, scal, ix, w_an, op, sdev, s);
  return (int)cudaGetLastError();
}

// K23: the day's SST of a daily climatology table with the bias ramp (the
// arithmetic: sst_by_date.cuh, which says what is computed).  The hybrid
// cycle with an SST table, an hour of the year and no slab ocean launches
// it once, before anything reads the cycle's SST grid.
//
// Replaces (JAX package) speedy_ml_tpu/hybrid/model.py:546-553,
// HybridAtmosphere.sst_by_date, and its use in _cycle_jit (:590-596),
// which XLA fused into the cycle.
// In/out at full width (T30, 48 x 96 = 4,608 points): reads one plane of
// the (365, 48, 96) table and writes one plane, 18.4 KB each in float32.
//
// Bound on an H100 SXM: memory, 36.9 KB, 0.000011 ms at 3.35 TB/s: a
// launch floor.  Design: the first, simple one; one thread a grid point,
// neighbouring threads on neighbouring points (coalesced).  The day and the
// bias are host numbers, kernel arguments; in the device-scalar form, which
// a captured CUDA graph of the cycle replays (hybrid/graph.py), two
// doubles in device memory.

#include "common.cuh"
#include "sst_by_date.cuh"

constexpr int kSbdBlock = 128;

template <typename T>
__global__ void __launch_bounds__(kSbdBlock)
    sst_by_date_kernel(const T* __restrict__ table, long long day,
                       long long G, T bias, T* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kSbdBlock + threadIdx.x;
  if (g < G) sst_by_date_at(table, day, G, bias, out, g);
}

// The device-scalar form: the day and the bias read from dev[0], dev[1]
// (a row of the captured cycle's per-cycle block, hybrid/graph.py), the
// bias rounded to the type as the by-value form's argument is; a day
// outside the table writes NaN
template <typename T>
__global__ void __launch_bounds__(kSbdBlock)
    sst_by_date_dev_kernel(const T* __restrict__ table, long long n_days,
                           long long G, const double* __restrict__ dev,
                           T* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kSbdBlock + threadIdx.x;
  if (g >= G) return;
  const long long day = (long long)dev[0];
  if (day < 0 || day >= n_days)
    out[g] = (T)__longlong_as_double(0x7ff8000000000000LL);
  else
    sst_by_date_at(table, day, G, (T)dev[1], out, g);
}

template <typename T>
static int launch(const void* table, long long n_days, long long day,
                  long long G, double bias, const double* dev, void* out,
                  cudaStream_t stream) {
  const unsigned grid = (unsigned)((G + kSbdBlock - 1) / kSbdBlock);
  if (dev)
    sst_by_date_dev_kernel<T><<<grid, kSbdBlock, 0, stream>>>(
        (const T*)table, n_days, G, dev, (T*)out);
  else
    sst_by_date_kernel<T><<<grid, kSbdBlock, 0, stream>>>(
        (const T*)table, day, G, (T)bias, (T*)out);
  return (int)cudaGetLastError();
}

// table (n_days, G) and out (G,) of the element type (is_double: double,
// else float); day in [0, n_days); bias cast to the type.  dev: null, or
// the device-scalar form's [day, bias] (two doubles in device memory),
// read in place of day and bias.
SPEEDY_API int sst_by_date_launch(int device, int is_double,
                                  const void* table, long long n_days,
                                  long long day, long long G, double bias,
                                  const double* dev, void* out,
                                  void* stream) {
  cudaError_t err = speedy_set_device(device);
  if (err != cudaSuccess) return (int)err;
  if (G < 1 || (!dev && (day < 0 || day >= n_days)) || !table || !out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_double ? launch<double>(table, n_days, day, G, bias, dev, out, s)
                   : launch<float>(table, n_days, day, G, bias, dev, out, s);
}

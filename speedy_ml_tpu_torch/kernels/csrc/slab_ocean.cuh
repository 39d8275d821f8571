// K22 (the slab ocean's per-cycle glue), for float and double, as CUDA
// device code and as plain C++ (glue_host.cpp compiles this very file for
// the CPU tests).
//
// Replaces (JAX package) the slab-ocean branch of the hybrid cycle,
// speedy_ml_tpu/hybrid/model.py:678-726: the rolling buffer's concatenate
// and mean, out * std_sst + mean_sst, scatter_core, the land where, the
// maximum with 272 K and the where(do_step).
//
// Each class c has a ring of W = SLAB_STRIDE - 1 slots (W, Rc, I_o): slot
// k holds the ocean inputs pushed at the cycles = k (mod W), so the ring
// is the JAX buffer rolled by step mod W and a push writes one slot, not
// the whole buffer.  Three forms, two launches:
//   - push (every cycle): buf_c[slot, r, j] = fb_c[r, idx_c[j]], fb_c the
//     bottom pack's standardized feedback, idx_c the ocean index map;
//   - push_mean (a slab step): the same write, then the mean of the W
//     slots in logical order, oldest first (slots slot+1, ..., slot, the
//     last the value just written), summed one after the other and
//     multiplied by rw = 1/W: the plain version's order and operations;
//   - sst (a slab step, after the slab readout): one point g of the new
//     SST grid: its source (class c, element k = r * O + j of the
//     class's (Rc, O) readout), or none (-1: 0, as JAX's zero grid);
//     v = out_c[k] * std_c[r] + mean_c[r]; v = land[g] ? base[g] : v;
//     v = max(v, 272) with NaN kept.
// Every operation is rounded apart (compiled without FMA contraction, as
// K21), so on the card the kernel gives the plain version's bits.
#pragma once

#include <string.h>

#include "column_common.cuh"

// region classes one launch covers (the T30 layout has 3)
#define SO_MAX_CLASSES 8

template <typename T>
COL_HD T so_nan() {
#ifdef __CUDA_ARCH__
  return T(__longlong_as_double(0x7ff8000000000000ll));
#else
  const unsigned long long bits = 0x7ff8000000000000ull;
  double v;
  memcpy(&v, &bits, sizeof v);
  return T(v);
#endif
}

// Index of the class whose half-open [start[c], start[c+1]) holds t.
COL_HD int so_class_of(long long t, const long long* start, int n_classes) {
  int c = 0;
  while (c + 1 < n_classes && t >= start[c + 1]) ++c;
  return c;
}

// The push forms.  Per class: fb (Rc, fb_width), idx (width) int32, buf
// (W, Rc, width), mean (Rc, width) or null (the push form); start: the
// running sums of Rc * width.
template <typename T>
struct SoPush {
  const T* fb[SO_MAX_CLASSES];
  const int* idx[SO_MAX_CLASSES];
  T* buf[SO_MAX_CLASSES];
  T* mean[SO_MAX_CLASSES];
  long long start[SO_MAX_CLASSES + 1];
  int width[SO_MAX_CLASSES];
  int fb_width[SO_MAX_CLASSES];
  int n_classes, W, slot;
  T rw;
};

// element t of all the classes' slots, in class order, at ring slot `slot`
// (a.slot, or the device-scalar form's)
template <typename T>
COL_HD void slab_push_at(const SoPush<T>& a, long long t, int slot) {
  const int c = so_class_of(t, a.start, a.n_classes);
  const long long k = t - a.start[c];
  const long long size = a.start[c + 1] - a.start[c];
  const long long r = k / a.width[c];
  const int j = (int)(k - r * a.width[c]);
  const T v = a.fb[c][r * a.fb_width[c] + a.idx[c][j]];
  T* buf = a.buf[c];
  buf[(long long)slot * size + k] = v;
  if (!a.mean[c]) return;
  // oldest first: slot + 1, ..., W - 1, 0, ..., slot (v, just written)
  int o = slot + 1 == a.W ? 0 : slot + 1;
  T s = o == slot ? v : buf[(long long)o * size + k];
  for (int n = 1; n < a.W; ++n) {
    o = o + 1 == a.W ? 0 : o + 1;
    s = s + (o == slot ? v : buf[(long long)o * size + k]);
  }
  a.mean[c][k] = s * a.rw;
}

template <typename T>
COL_HD void slab_push_at(const SoPush<T>& a, long long t) {
  slab_push_at(a, t, a.slot);
}

// The SST form.  Per class: out (Rc, width) the standardized slab
// readout, mean_sst and std_sst (Rc,); start: the running sums of
// Rc * width.  src (G,) int32: the point's offset into the concatenation
// of the classes' outputs, -1 for none; base (G,) and land (G,) bool, or
// both null; sst (G,) the new grid; tmin the floor (272 K).
template <typename T>
struct SoSst {
  const T* out[SO_MAX_CLASSES];
  const T* mean_sst[SO_MAX_CLASSES];
  const T* std_sst[SO_MAX_CLASSES];
  long long start[SO_MAX_CLASSES + 1];
  int width[SO_MAX_CLASSES];
  int n_classes;
  const int* src;
  const T* base;
  const bool* land;
  T* sst;
  long long G;
  T tmin;
};

template <typename T>
COL_HD void slab_sst_at(const SoSst<T>& a, long long g) {
  const long long s = a.src[g];
  T v = T(0);
  if (s >= a.start[a.n_classes]) {
    v = so_nan<T>();
  } else if (s >= 0) {
    const int c = so_class_of(s, a.start, a.n_classes);
    const long long k = s - a.start[c];
    const long long r = k / a.width[c];
    v = a.out[c][k] * a.std_sst[c][r] + a.mean_sst[c][r];
  }
  if (a.land && a.land[g]) v = a.base[g];
  a.sst[g] = v < a.tmin ? a.tmin : v;
}

// The launch's arguments as SoPush / SoSst, on the host; 1 if they do
// not fit (the class count, the ring, the mean pointers all given or all
// null), else 0.
template <typename T>
inline int slab_push_args(SoPush<T>* a, int n_classes, void* const* fb,
                          void* const* idx, void* const* buf,
                          void* const* mean, const long long* counts,
                          const int* width, const int* fb_width, int W,
                          int slot, double rw) {
  if (n_classes < 1 || n_classes > SO_MAX_CLASSES || W < 1 || slot < 0 ||
      slot >= W)
    return 1;
  memset(a, 0, sizeof *a);
  for (int c = 0; c < n_classes; ++c) {
    if (!fb[c] || !idx[c] || !buf[c] || width[c] < 1 || fb_width[c] < 1 ||
        (mean[c] == nullptr) != (mean[0] == nullptr))
      return 1;
    a->fb[c] = (const T*)fb[c];
    a->idx[c] = (const int*)idx[c];
    a->buf[c] = (T*)buf[c];
    a->mean[c] = (T*)mean[c];
    a->width[c] = width[c];
    a->fb_width[c] = fb_width[c];
    a->start[c + 1] = a->start[c] + counts[c];
  }
  a->n_classes = n_classes;
  a->W = W;
  a->slot = slot;
  a->rw = (T)rw;
  return 0;
}

template <typename T>
inline int slab_sst_args(SoSst<T>* a, int n_classes, void* const* out,
                         void* const* mean_sst, void* const* std_sst,
                         const long long* counts, const int* width,
                         const void* src, const void* base, const void* land,
                         long long G, double tmin, void* sst) {
  if (n_classes < 1 || n_classes > SO_MAX_CLASSES || !src || !sst ||
      G < 1 || (base == nullptr) != (land == nullptr))
    return 1;
  memset(a, 0, sizeof *a);
  for (int c = 0; c < n_classes; ++c) {
    if (!out[c] || !mean_sst[c] || !std_sst[c] || width[c] < 1) return 1;
    a->out[c] = (const T*)out[c];
    a->mean_sst[c] = (const T*)mean_sst[c];
    a->std_sst[c] = (const T*)std_sst[c];
    a->width[c] = width[c];
    a->start[c + 1] = a->start[c] + counts[c];
  }
  a->n_classes = n_classes;
  a->src = (const int*)src;
  a->base = (const T*)base;
  a->land = (const bool*)land;
  a->sst = (T*)sst;
  a->G = G;
  a->tmin = (T)tmin;
  return 0;
}

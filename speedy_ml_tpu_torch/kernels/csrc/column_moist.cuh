// K9: humidity, convection and large-scale condensation of grid columns,
// for float and double, as CUDA device code and as plain C++ (the host
// build of the CPU tests compiles this very file).
//
// Replaces (JAX package) the prologue of PhysicsModel.compute
// (speedy_ml_tpu/physics/driver.py:192-216) with qsat_from_t
// (physics/humidity.py:12), convmf (physics/convection.py:19) and lscond
// (physics/condensation.py:14).  Every operation stands in the order of
// the plain PyTorch version (kernels/column_moist.py column_moist_plain)
// and is rounded apart (the sources that include this file are compiled
// without FMA contraction): convmf decides by comparing sums, and a
// one-ulp difference would flip a near-tie column.
//
// The arithmetic is four pieces: the prologue of one level (moist_level),
// convmf up the column (moist_convmf, the only serial part), lscond of one
// level (moist_lscond_level) and the column's close (moist_close: itop
// and the precls sum).  Two callers use them: column_moist_at, one
// column in a row (the first design, kept for the host build), and the
// moist_block_* phases of the kernel's block, C columns x K warps, warp k
// on level k, the pieces handing on through shared memory.  Both give
// the same bits.  K9_moist_shortwave's block runs the same four phases,
// then the shortwave's (column_shortwave.cuh).  Levels in registers are indexed only by unrolled
// loops: the lookups at the convective top are selects.
#pragma once

#include "column_common.cuh"

// The table blob (MoistTables.blob in kernels/column_moist.py), all of
// type T: eight (K,) tables, then the scalars.
template <typename T, int K>
struct MoistTab {
  const T *sig, *wvi2, *entr, *grdsig, *grdscp, *rhref, *dqmax, *dsig;
  T cp, alhc, fm0, rdps, psmin, rhbl, rhil, smf, rtlsc, tfact, prg;
  COL_HD explicit MoistTab(const T* b)
      : sig(b), wvi2(b + K), entr(b + 2 * K), grdsig(b + 3 * K),
        grdscp(b + 4 * K), rhref(b + 5 * K), dqmax(b + 6 * K),
        dsig(b + 7 * K) {
    const T* s = b + 8 * K;
    cp = s[0]; alhc = s[1]; fm0 = s[2]; rdps = s[3]; psmin = s[4];
    rhbl = s[5]; rhil = s[6]; smf = s[7]; rtlsc = s[8]; tfact = s[9];
    prg = s[10];
  }
};

// Saturation specific humidity [g/kg] (humidity.py qsat_from_t).
template <typename T>
COL_HD T qsat_from_t(T ta, T p) {
  const T e0 = T(6.108e-3), c1 = T(17.269), c2 = T(21.875);
  const T t0 = T(273.16), t1 = T(35.86), t2 = T(7.66);
  const T es = ta >= t0 ? e0 * col_exp(c1 * (ta - t0) / (ta - t1))
                        : e0 * col_exp(c2 * (ta - t0) / (ta - t2));
  return T(622.0) * es / (p - T(0.378) * es);
}

// ---- the pieces, in the order of the plain version.  The per-column
// loop (column_moist_body) and K9's block (the moist_block_* phases)
// both call these, so they run the same operations.

// Level k of the prologue (driver.py): q clamped at 0, the dry static
// energy, the saturation humidity, the relative humidity, and the
// saturation moist static energy convmf compares.
template <typename T, int K>
COL_HD void moist_level(const MoistTab<T, K>& tb, int k, T tg, T q_raw,
                        T phi, T psg, T& q, T& se, T& qsat, T& rh, T& mss) {
  q = col_max(q_raw, T(0));
  se = tb.cp * tg + phi;
  qsat = qsat_from_t(tg, tb.sig[k] * psg);
  rh = q / qsat;
  mss = se + tb.alhc * qsat;
}

// convmf: the trigger, the cloud base, the entrainment up the column and
// the top layer, level after level.  Out: itop (K where no convection
// runs), cbmf, precnv, and the flux divergences dfse, dfqa.
template <typename T, int K>
COL_HD void moist_convmf(const MoistTab<T, K>& tb, T psg, const T (&se)[K],
                         const T (&q)[K], const T (&qsat)[K],
                         const T (&mss)[K], int& itop_out, T& cbmf,
                         T& precnv, T (&dfse)[K], T (&dfqa)[K]) {
  constexpr int nl1 = K - 1;
  const T zero = T(0);
  const T alhc = tb.alhc;

  // ---- convmf 1: trigger conditions
  const T mse0 = se[nl1] + alhc * q[nl1];
  const T mse1 = col_min(mse0, se[nl1 - 1] + alhc * q[nl1 - 1]);
  const T mss0 = col_max(mse0, mss[nl1]);
  int ktop1 = K - 1, ktop2 = K - 1;
  T msthr = zero;
#pragma unroll
  for (int k = K - 4; k > 1; --k) {
    const T mss2 = mss[k] + tb.wvi2[k] * (mss[k + 1] - mss[k]);
    if (mss0 > mss2) ktop1 = k;
    if (mse1 > mss2) {
      msthr = mss2;
      ktop2 = k;
    }
  }
  const T qthr0 = tb.rhbl * qsat[nl1];
  const T qthr1 = tb.rhbl * qsat[nl1 - 1];
  const bool lqthr = (q[nl1] > qthr0) && (q[nl1 - 1] > qthr1);
  const bool base_ok = (psg > tb.psmin) && (ktop1 < K - 1);
  const bool deep = base_ok && (ktop2 < K - 1);
  const bool shallow = base_ok && !(ktop2 < K - 1) && lqthr;
  const bool conv = deep || shallow;
  const int itop = conv ? ktop1 : K;
  const T qdif = deep ? col_max(q[nl1] - qthr0, (mse0 - msthr) / alhc)
                      : q[nl1] - qthr0;

  // ---- convmf 2: cloud-base layer
  const T qmax = col_max(T(1.01) * q[nl1], qsat[nl1]);
  const T sb = se[nl1 - 1] + tb.wvi2[nl1 - 1] * (se[nl1] - se[nl1 - 1]);
  const T qb = col_min(
      q[nl1 - 1] + tb.wvi2[nl1 - 1] * (q[nl1] - q[nl1 - 1]), q[nl1]);
  const T fpsa = psg * col_min((psg - tb.psmin) * tb.rdps, T(1));
  // qdif / (qmax - qb) may be inf or NaN where no convection runs: the
  // select writes zero there, as the plain version's torch.where does
  T fmass = conv ? tb.fm0 * fpsa * col_min(qdif / (qmax - qb), T(5.0))
                 : zero;
  cbmf = fmass;
  T fus = fmass * se[nl1], fuq = fmass * qmax;
  T fds = fmass * sb, fdq = fmass * qb;
#pragma unroll
  for (int k = 0; k < K; ++k) dfse[k] = dfqa[k] = zero;
  dfse[nl1] = fds - fus;
  dfqa[nl1] = fdq - fuq;

  // ---- convmf 3: intermediate layers with entrainment
#pragma unroll
  for (int k = K - 2; k > 1; --k) {
    const bool active = (k > itop) && conv;
    const T lower_se = fus - fds, lower_qa = fuq - fdq;
    const T enmass = tb.entr[k] * psg * cbmf;
    const T fmass_n = fmass + enmass;
    const T fus_n = fus + enmass * se[k];
    const T fuq_n = fuq + enmass * q[k];
    const T sb_k = se[k - 1] + tb.wvi2[k - 1] * (se[k] - se[k - 1]);
    const T qb_k = q[k - 1] + tb.wvi2[k - 1] * (q[k] - q[k - 1]);
    const T fds_n = fmass_n * sb_k;
    const T fdq_n = fmass_n * qb_k;
    const T delq = tb.rhil * qsat[k] - q[k];
    const T fsq = (active && delq > zero) ? tb.smf * cbmf * delq : zero;
    if (active) {
      dfse[k] = lower_se + fds_n - fus_n;
      dfqa[k] = lower_qa + fdq_n - fuq_n + fsq;
    }
    dfqa[nl1] = dfqa[nl1] - fsq;
    if (active) {
      fmass = fmass_n;
      fus = fus_n;
      fuq = fuq_n;
      fds = fds_n;
      fdq = fdq_n;
    }
  }

  // ---- convmf 4: top layer, condensation and detrainment.  The level
  // itop_c = clamp(itop, 0, K-2) is selected, not indexed.
  const int itop_c = itop < 0 ? 0 : (itop > K - 2 ? K - 2 : itop);
  T qsat_top = zero, qsat_top1 = zero, wtop = zero;
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    if (k == itop_c) {
      qsat_top = qsat[k];
      qsat_top1 = qsat[k + 1];
      wtop = tb.wvi2[k];
    }
  }
  const T qsatb = qsat_top + wtop * (qsat_top1 - qsat_top);
  precnv = conv ? col_max(fuq - fmass * qsatb, zero) : zero;
  const T top_se = fus - fds + alhc * precnv;
  const T top_qa = fuq - fdq - precnv;
#pragma unroll
  for (int k = 2; k < K - 1; ++k) {
    if (itop == k) {
      dfse[k] = top_se;
      dfqa[k] = top_qa;
    }
  }
  itop_out = itop;
}

// Level k of lscond and the sums of physics/driver.py: cond, whether the
// level condenses; dqlsc; ttend = tt_cnv + tt_lsc, qtend = qt_cnv + qt_lsc.
template <typename T, int K>
COL_HD void moist_lscond_level(const MoistTab<T, K>& tb, int k, T psg, T rps,
                               T q, T qsat, T dfse, T dfqa, bool& cond,
                               T& dqlsc, T& ttend, T& qtend) {
  const T zero = T(0);
  if (k == 0) {
    cond = false;
    dqlsc = zero;
    ttend = dfse * rps * tb.grdscp[0] + zero;
    qtend = dfqa * rps * tb.grdsig[0] + zero;
    return;
  }
  const T psa2 = psg * psg;
  const T dqa = tb.rhref[k] * qsat - q;
  cond = dqa < zero;
  dqlsc = cond ? dqa * tb.rtlsc : zero;
  const T dtlsc =
      cond ? tb.tfact * col_min(-dqa * tb.rtlsc, tb.dqmax[k] * psa2) : zero;
  ttend = dfse * rps * tb.grdscp[k] + dtlsc;
  qtend = dfqa * rps * tb.grdsig[k] + dqlsc;
}

// The column's close of lscond: itop lowered to the highest condensing
// level below it, and precls, the column sum over levels 1..K-1 in level
// order.
template <typename T, int K>
COL_HD void moist_close(const MoistTab<T, K>& tb, T psg, int itop,
                        const bool (&cond)[K], const T (&dqlsc)[K],
                        int& itop_out, T& precls) {
  int it = itop;
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (cond[k] && k < it) it = k;
  itop_out = it;
  T col = tb.dsig[1] * dqlsc[1];
#pragma unroll
  for (int k = 2; k < K; ++k) col = col + tb.dsig[k] * dqlsc[k];
  precls = -tb.prg * col * psg;
}

// One column, the pieces in a row.  q comes in raw and leaves clamped at
// 0.  Out: psg, rps, se, qsat, rh; itop (after lscond), icnv = K-1 -
// convmf's itop; cbmf, precnv, precls; ttend, qtend.
template <typename T, int K>
COL_HD void column_moist_body(const MoistTab<T, K>& tb, const T (&tg)[K],
                              T (&q)[K], const T (&phi)[K], T psl, T& psg,
                              T& rps, T (&se)[K], T (&qsat)[K], T (&rh)[K],
                              int& itop_out, int& icnv, T& cbmf, T& precnv,
                              T& precls, T (&ttend)[K], T (&qtend)[K]) {
  psg = col_exp(psl);
  rps = T(1) / psg;
  T mss[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    moist_level(tb, k, tg[k], q[k], phi[k], psg, q[k], se[k], qsat[k], rh[k],
                mss[k]);
  int itop;
  T dfse[K], dfqa[K];
  moist_convmf(tb, psg, se, q, qsat, mss, itop, cbmf, precnv, dfse, dfqa);
  icnv = (K - 1) - itop;
  bool cond[K];
  T dqlsc[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    moist_lscond_level(tb, k, psg, rps, q[k], qsat[k], dfse[k], dfqa[k],
                       cond[k], dqlsc[k], ttend[k], qtend[k]);
  moist_close(tb, psg, itop, cond, dqlsc, itop_out, precls);
}

// Column c of G: load, body, store.  Fields are (levels, G) with the
// column fastest.  out_f: q, se, qsat, rh, ttend, qtend (K, G each),
// then psg, rps, cbmf, precnv, precls (G each); out_i: itop, icnv.
template <typename T, int K>
COL_HD void column_moist_at(int c, int G, const T* tg, const T* qg,
                            const T* phig, const T* pslg, const T* blob,
                            T* out_f, long long* out_i) {
  const MoistTab<T, K> tb(blob);
  T t[K], q[K], phi[K], se[K], qsat[K], rh[K], ttend[K], qtend[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    t[k] = tg[(size_t)k * G + c];
    q[k] = qg[(size_t)k * G + c];
    phi[k] = phig[(size_t)k * G + c];
  }
  T psg, rps, cbmf, precnv, precls;
  int itop, icnv;
  column_moist_body<T, K>(tb, t, q, phi, pslg[c], psg, rps, se, qsat, rh,
                          itop, icnv, cbmf, precnv, precls, ttend, qtend);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t i = (size_t)k * G + c;
    out_f[(size_t)(0 * K) * G + i] = q[k];
    out_f[(size_t)(1 * K) * G + i] = se[k];
    out_f[(size_t)(2 * K) * G + i] = qsat[k];
    out_f[(size_t)(3 * K) * G + i] = rh[k];
    out_f[(size_t)(4 * K) * G + i] = ttend[k];
    out_f[(size_t)(5 * K) * G + i] = qtend[k];
  }
  T* planes = out_f + (size_t)(6 * K) * G;
  planes[(size_t)0 * G + c] = psg;
  planes[(size_t)1 * G + c] = rps;
  planes[(size_t)2 * G + c] = cbmf;
  planes[(size_t)3 * G + c] = precnv;
  planes[(size_t)4 * G + c] = precls;
  out_i[c] = itop;
  out_i[(size_t)G + c] = icnv;
}

// ---- K9's block: C neighbouring columns, one warp (threadIdx.y) per
// level.  What one phase hands to the next lies in MoistShared; each
// moist_block_* function is what thread (x, k) of the block does between
// two barriers (x: the column in the block, c: the column in the grid).

template <typename T, int K, int C>
struct MoistShared {
  T se[K][C], q[K][C], qsat[K][C], mss[K][C];  // levels -> convmf, lscond
  T dfse[K][C], dfqa[K][C];                     // convmf -> lscond
  T dqlsc[K][C];                                // lscond -> close
  unsigned char cond[K][C];
  int itop[C];                                  // convmf -> close
  T cbmf[C], precnv[C];
};

// The kernel's operands (column_moist_at's, as a struct).
template <typename T>
struct MoistIO {
  const T *tg, *qg, *phig, *pslg;
  int G;
  T* out_f;
  long long* out_i;
};

// Phase 1, every warp: level k of the prologue; q, se, qsat, rh stored,
// and rh returned (K9_moist_shortwave keeps it for its clouds).  Every
// phase computes psg (and rps) from pslg itself: the same operations give
// the same bits, and handing them on through shared memory ran ~0.1 us
// slower on an H100.
template <typename T, int K, int C>
COL_HD T moist_block_levels(const MoistTab<T, K>& tb, const MoistIO<T>& io,
                            MoistShared<T, K, C>& sh, int c, int x, int k) {
  if (c >= io.G) return T(0);
  const size_t G = io.G, i = (size_t)k * G + c;
  const T psg = col_exp(io.pslg[c]);
  T q, se, qsat, rh, mss;
  moist_level(tb, k, io.tg[i], io.qg[i], io.phig[i], psg, q, se, qsat, rh,
              mss);
  io.out_f[(size_t)(0 * K) * G + i] = q;
  io.out_f[(size_t)(1 * K) * G + i] = se;
  io.out_f[(size_t)(2 * K) * G + i] = qsat;
  io.out_f[(size_t)(3 * K) * G + i] = rh;
  sh.se[k][x] = se;
  sh.q[k][x] = q;
  sh.qsat[k][x] = qsat;
  sh.mss[k][x] = mss;
  return rh;
}

// Phase 2, one warp: convmf of column x.
template <typename T, int K, int C>
COL_HD void moist_block_convmf(const MoistTab<T, K>& tb, const MoistIO<T>& io,
                               MoistShared<T, K, C>& sh, int c, int x) {
  if (c >= io.G) return;
  const T psg = col_exp(io.pslg[c]);
  T se[K], q[K], qsat[K], mss[K], dfse[K], dfqa[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    se[k] = sh.se[k][x];
    q[k] = sh.q[k][x];
    qsat[k] = sh.qsat[k][x];
    mss[k] = sh.mss[k][x];
  }
  int itop;
  T cbmf, precnv;
  moist_convmf(tb, psg, se, q, qsat, mss, itop, cbmf, precnv, dfse, dfqa);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sh.dfse[k][x] = dfse[k];
    sh.dfqa[k][x] = dfqa[k];
  }
  sh.itop[x] = itop;
  sh.cbmf[x] = cbmf;
  sh.precnv[x] = precnv;
}

// Phase 3, every warp: lscond of level k; ttend, qtend stored.
template <typename T, int K, int C>
COL_HD void moist_block_lscond(const MoistTab<T, K>& tb, const MoistIO<T>& io,
                               MoistShared<T, K, C>& sh, int c, int x,
                               int k) {
  if (c >= io.G) return;
  const size_t G = io.G, i = (size_t)k * G + c;
  const T psg = col_exp(io.pslg[c]);
  const T rps = T(1) / psg;
  bool cond;
  T dqlsc, ttend, qtend;
  moist_lscond_level(tb, k, psg, rps, sh.q[k][x], sh.qsat[k][x],
                     sh.dfse[k][x], sh.dfqa[k][x], cond, dqlsc, ttend, qtend);
  io.out_f[(size_t)(4 * K) * G + i] = ttend;
  io.out_f[(size_t)(5 * K) * G + i] = qtend;
  sh.cond[k][x] = cond;
  sh.dqlsc[k][x] = dqlsc;
}

// Phase 4, one warp: the close of column x; the planes and the integers
// stored, itop and precls also returned (K9_moist_shortwave's clouds
// read them on the same warp).
template <typename T, int K, int C>
COL_HD void moist_block_close(const MoistTab<T, K>& tb, const MoistIO<T>& io,
                              MoistShared<T, K, C>& sh, int c, int x,
                              int& itop_out, T& precls_out) {
  if (c >= io.G) return;
  const size_t G = io.G;
  const T psg = col_exp(io.pslg[c]);
  bool cond[K];
  T dqlsc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cond[k] = sh.cond[k][x] != 0;
    dqlsc[k] = sh.dqlsc[k][x];
  }
  int itop;
  T precls;
  moist_close(tb, psg, sh.itop[x], cond, dqlsc, itop, precls);
  T* planes = io.out_f + (size_t)(6 * K) * G;
  planes[0 * G + c] = psg;
  planes[1 * G + c] = T(1) / psg;
  planes[2 * G + c] = sh.cbmf[x];
  planes[3 * G + c] = sh.precnv[x];
  planes[4 * G + c] = precls;
  io.out_i[c] = itop;
  io.out_i[G + c] = (K - 1) - sh.itop[x];
  itop_out = itop;
  precls_out = precls;
}

// K9 column body: humidity, convection and large-scale condensation of
// one grid column, for float and double, as CUDA device code and as
// plain C++ (the host build of the CPU tests compiles this very file).
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
// Levels live in registers: K is a template parameter and every level
// loop is unrolled.  A register array is never indexed by a level that
// depends on the data: the lookups at the convective top are selects
// inside an unrolled loop.
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

// One column.  q comes in raw and leaves clamped at 0.  Out: psg, rps,
// se, qsat, rh; itop (after lscond), icnv = K-1 - convmf's itop; cbmf,
// precnv, precls; ttend = tt_cnv + tt_lsc, qtend = qt_cnv + qt_lsc.
template <typename T, int K>
COL_HD void column_moist_body(const MoistTab<T, K>& tb, const T (&tg)[K],
                              T (&q)[K], const T (&phi)[K], T psl, T& psg,
                              T& rps, T (&se)[K], T (&qsat)[K], T (&rh)[K],
                              int& itop_out, int& icnv, T& cbmf, T& precnv,
                              T& precls, T (&ttend)[K], T (&qtend)[K]) {
  constexpr int nl1 = K - 1;
  const T zero = T(0);
  const T alhc = tb.alhc;

  // ---- prologue (driver.py)
  psg = col_exp(psl);
  rps = T(1) / psg;
  T mss[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    q[k] = col_max(q[k], zero);
    se[k] = tb.cp * tg[k] + phi[k];
    qsat[k] = qsat_from_t(tg[k], tb.sig[k] * psg);
    rh[k] = q[k] / qsat[k];
    mss[k] = se[k] + alhc * qsat[k];
  }

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
  T dfse[K], dfqa[K];
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
  icnv = (K - 1) - itop;

  // ---- lscond, and the sums of physics/driver.py
  const T psa2 = psg * psg;
  int itop_new = itop;
  T dqlsc[K];
  dqlsc[0] = zero;
  ttend[0] = dfse[0] * rps * tb.grdscp[0] + zero;
  qtend[0] = dfqa[0] * rps * tb.grdsig[0] + zero;
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const T dqa = tb.rhref[k] * qsat[k] - q[k];
    const bool cond = dqa < zero;
    dqlsc[k] = cond ? dqa * tb.rtlsc : zero;
    const T dtlsc =
        cond ? tb.tfact * col_min(-dqa * tb.rtlsc, tb.dqmax[k] * psa2) : zero;
    if (cond && k < itop_new) itop_new = k;
    ttend[k] = dfse[k] * rps * tb.grdscp[k] + dtlsc;
    qtend[k] = dfqa[k] * rps * tb.grdsig[k] + dqlsc[k];
  }
  itop_out = itop_new;
  // the column sum over levels 1..K-1, in level order
  T col = tb.dsig[1] * dqlsc[1];
#pragma unroll
  for (int k = 2; k < K; ++k) col = col + tb.dsig[k] * dqlsc[k];
  precls = -tb.prg * col * psg;
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

"""Large-scale condensation (reference: phy_lscond.f90).

Counterpart of the JAX package's physics/condensation.py: relax q toward
rhref*qsat with the latent heating capped; precipitation is the column
moisture sink.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.physics import constants as pc

RTLSC = 1.0 / (pc.TRLSC * 3600.0)


def lscond_tables(sig) -> tuple[list[float], list[float]]:
    """(rhref, dqmax), K Python floats each: the relative-humidity
    threshold and the cap on the moisture sink of every level (level 0
    takes no part and holds zeros)."""
    K = len(sig)
    qsmax = 10.0
    rhref, dqmax = [0.0], [0.0]
    for k in range(1, K):
        sig2 = float(sig[k]) ** 2
        rh = pc.RHLSC + pc.DRHLSC * (sig2 - 1.0)
        if k == K - 1:
            rh = max(rh, pc.RHBLSC)
        rhref.append(rh)
        dqmax.append(qsmax * sig2 * RTLSC)
    return rhref, dqmax


def lscond(psa, qa, qsat, itop, *, sig, dsig, p0, grav, cp, alhc):
    """Returns (itop_updated, precls, dtlsc, dqlsc); psa (...,), qa/qsat
    (K, ...), itop (...) from convmf; sig, dsig (K,) numpy."""
    K = qa.shape[0]
    rtlsc = RTLSC
    rhref, dqmax = lscond_tables(sig)
    tfact = alhc / cp
    prg = p0 / grav
    psa2 = psa * psa
    zero = torch.zeros_like(psa)
    dtlsc = [zero] * K
    dqlsc = [zero] * K
    itop_new = itop
    for k in range(1, K):
        dqa = rhref[k] * qsat[k] - qa[k]
        cond = dqa < 0.0
        dqlsc[k] = torch.where(cond, dqa * rtlsc, zero)
        dtlsc[k] = torch.where(
            cond, tfact * torch.minimum(-dqa * rtlsc, dqmax[k] * psa2), zero)
        itop_new = torch.where(cond, torch.clamp(itop_new, max=k), itop_new)
    dqlsc = torch.stack(dqlsc)
    dtlsc = torch.stack(dtlsc)
    # the column sum over levels 1..K-1 in level order; the weights are
    # host floats, so nothing is copied to the device per call
    col = float(dsig[1]) * dqlsc[1]
    for k in range(2, K):
        col = col + float(dsig[k]) * dqlsc[k]
    precls = -prg * col * psa
    return itop_new, precls, dtlsc, dqlsc

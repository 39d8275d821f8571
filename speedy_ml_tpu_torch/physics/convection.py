"""Simplified mass-flux convection (reference: phy_convmf.f90).

Counterpart of the JAX package's physics/convection.py: the per-column
searches and running fluxes as masked level loops over (lat, lon)
planes.  Level 0 is the model top; "no convection" is itop == nlev.  The
top-level lookups by the data-dependent itop are torch.gather calls, so
nothing is read back to the host.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.physics import constants as pc

RDPS = 2.0 / (1.0 - pc.PSMIN)


def entrainment_profile(sig) -> list[float]:
    """The entrainment profile, normalized to ENTMAX (phy_convmf.f90:80-88):
    K Python floats, zero at the top and the bottom level."""
    nl1 = len(sig) - 1
    entr = [max(0.0, float(s) - 0.5) ** 2 for s in sig]
    entr[0] = entr[nl1] = 0.0
    norm = sum(entr[1:nl1])
    return [e * (pc.ENTMAX / norm) for e in entr]


def cloud_base_flux(dsig, p0, grav) -> float:
    """fm0, the cloud-base mass flux per unit humidity excess."""
    return p0 * float(dsig[len(dsig) - 1]) / (grav * pc.TRCNV * 3600.0)


def convmf(psa, se, qa, qsat, *, sig, dsig, wvi2, p0, grav, alhc):
    """Convective fluxes of dry static energy and moisture.

    psa (...,) p/p0; se, qa, qsat (K, ...); sig, dsig: (K,) numpy;
    wvi2: (K,) tensor on the device of the fields.  Returns (itop, cbmf,
    precnv, dfse, dfqa), dfse/dfqa net fluxes per layer."""
    K = se.shape[0]
    nl1 = K - 1
    fqmax = 5.0
    fm0 = cloud_base_flux(dsig, p0, grav)
    rdps = RDPS
    zero = torch.zeros_like(psa)

    mss = se + alhc * qsat
    entr = entrainment_profile(sig)

    # ---- 1. trigger conditions (phy_convmf.f90:93-140)
    mse0 = se[nl1] + alhc * qa[nl1]
    mse1 = torch.minimum(mse0, se[nl1 - 1] + alhc * qa[nl1 - 1])
    mss0 = torch.maximum(mse0, mss[nl1])
    ktop1 = torch.full(psa.shape, K - 1, dtype=torch.int64,
                       device=psa.device)
    ktop2 = ktop1.clone()
    msthr = torch.zeros_like(mse0)
    for k in range(K - 4, 1, -1):
        mss2 = mss[k] + wvi2[k] * (mss[k + 1] - mss[k])
        c1 = mss0 > mss2
        c2 = mse1 > mss2
        ktop1 = torch.where(c1, k, ktop1)
        msthr = torch.where(c2, mss2, msthr)
        ktop2 = torch.where(c2, k, ktop2)

    qthr0 = pc.RHBL * qsat[nl1]
    qthr1 = pc.RHBL * qsat[nl1 - 1]
    lqthr = (qa[nl1] > qthr0) & (qa[nl1 - 1] > qthr1)
    base_ok = (psa > pc.PSMIN) & (ktop1 < K - 1)
    deep = base_ok & (ktop2 < K - 1)
    shallow = base_ok & ~(ktop2 < K - 1) & lqthr
    conv = deep | shallow
    itop = torch.where(conv, ktop1, K)
    qdif = torch.where(deep,
                       torch.maximum(qa[nl1] - qthr0, (mse0 - msthr) / alhc),
                       qa[nl1] - qthr0)

    # ---- 2. cloud-base layer (phy_convmf.f90:146-174)
    qmax = torch.maximum(1.01 * qa[nl1], qsat[nl1])
    sb = se[nl1 - 1] + wvi2[nl1 - 1] * (se[nl1] - se[nl1 - 1])
    qb = torch.minimum(qa[nl1 - 1] + wvi2[nl1 - 1] * (qa[nl1] - qa[nl1 - 1]),
                       qa[nl1])
    fpsa = psa * torch.clamp((psa - pc.PSMIN) * rdps, max=1.0)
    fmass = torch.where(conv, fm0 * fpsa * torch.clamp(qdif / (qmax - qb),
                                                       max=fqmax), zero)
    cbmf = fmass
    fus, fuq = fmass * se[nl1], fmass * qmax
    fds, fdq = fmass * sb, fmass * qb
    dfse = [zero] * K
    dfqa = [zero] * K
    dfse[nl1] = fds - fus
    dfqa[nl1] = fdq - fuq

    # ---- 3. intermediate layers with entrainment (phy_convmf.f90:177-209)
    for k in range(K - 2, 1, -1):
        active = (k > itop) & conv
        lower_se, lower_qa = fus - fds, fuq - fdq
        enmass = entr[k] * psa * cbmf
        fmass_n = fmass + enmass
        fus_n = fus + enmass * se[k]
        fuq_n = fuq + enmass * qa[k]
        sb_k = se[k - 1] + wvi2[k - 1] * (se[k] - se[k - 1])
        qb_k = qa[k - 1] + wvi2[k - 1] * (qa[k] - qa[k - 1])
        fds_n = fmass_n * sb_k
        fdq_n = fmass_n * qb_k
        delq = pc.RHIL * qsat[k] - qa[k]
        fsq = torch.where(active & (delq > 0.0), pc.SMF * cbmf * delq, zero)
        dfse[k] = torch.where(active, lower_se + fds_n - fus_n, dfse[k])
        dfqa[k] = torch.where(active, lower_qa + fdq_n - fuq_n + fsq,
                              dfqa[k])
        dfqa[nl1] = dfqa[nl1] - fsq
        fmass = torch.where(active, fmass_n, fmass)
        fus = torch.where(active, fus_n, fus)
        fuq = torch.where(active, fuq_n, fuq)
        fds = torch.where(active, fds_n, fds)
        fdq = torch.where(active, fdq_n, fdq)

    # ---- 4. top layer: condensation and detrainment (:211-222)
    itop_c = torch.clamp(itop, 0, K - 2)
    qsat_top = torch.gather(qsat, 0, itop_c[None])[0]
    qsat_top1 = torch.gather(qsat, 0, (itop_c + 1)[None])[0]
    qsatb = qsat_top + wvi2[itop_c] * (qsat_top1 - qsat_top)
    precnv = torch.where(conv, torch.clamp(fuq - fmass * qsatb, min=0.0),
                         zero)
    top_se = fus - fds + alhc * precnv
    top_qa = fuq - fdq - precnv
    for k in range(2, K - 1):
        at_top = itop == k
        dfse[k] = torch.where(at_top, top_se, dfse[k])
        dfqa[k] = torch.where(at_top, top_qa, dfqa[k])
    return itop, cbmf, precnv, torch.stack(dfse), torch.stack(dfqa)

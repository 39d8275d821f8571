"""Vertical diffusion and shallow convection (reference: phy_vdifsc.f90).

Counterpart of the JAX package's physics/vdiff.py: PBL shallow
convection, moisture diffusion above the PBL where the RH gradient is
steep, and damping of super-adiabatic lapse rates.
"""

from __future__ import annotations

import numpy as np
import torch

from speedy_ml_tpu_torch.physics import constants as pc


def vdifsc(ua, va, se, rh, qa, qsat, phi, icnv, *, sig, sigh, dsig, cp,
           alhc):
    """Returns (utend, vtend, ttend, qtend), all (K, lat, lon).

    sig, sigh (K+1,), dsig: numpy tables, sigh[0] = top.  icnv: (lat, lon)
    deep-convection depth indicator (nlev - 1 - itop of convmf)."""
    K = se.shape[0]
    nl1 = K - 2
    cshc = dsig[K - 1] / 3600.0
    cvdi = (sigh[K - 1] - sigh[1]) / ((K - 2) * 3600.0)
    fshcq = cshc / pc.TRSHC
    fshcse = cshc / (pc.TRSHC * cp)
    fvdiq = cvdi / pc.TRVDI
    fvdise = cvdi / (pc.TRVDS * cp)
    rsig = [float(x) for x in 1.0 / dsig]
    # rsig1 at full level k = 1/(1 - half sigma below layer k); the k=K-1
    # entry is unused
    denom = 1.0 - np.asarray(sigh[1:], dtype=np.float64)
    rsig1 = [float(x) for x in 1.0 / np.where(denom > 0, denom, 1.0)]

    zero = torch.zeros_like(se[0])
    utend = [zero] * K
    vtend = [zero] * K
    ttend = [zero] * K
    qtend = [zero] * K

    # 2. shallow convection between the two lowest layers
    drh0 = float(pc.RHGRAD * (sig[K - 1] - sig[nl1]))
    fvdiq2 = float(fvdiq * sigh[K - 1])
    dmse = (se[K - 1] - se[nl1]) + alhc * (qa[K - 1] - qsat[nl1])
    drh = rh[K - 1] - rh[nl1]
    # REDSHC where deep convection is active, else 1 (exact either way)
    fcnv = 1.0 - (1.0 - pc.REDSHC) * (icnv > 0).to(se.dtype)
    shallow = dmse >= 0.0
    fluxse = torch.where(shallow, fcnv * float(fshcse) * dmse, zero)
    ttend[nl1] = ttend[nl1] + fluxse * rsig[nl1]
    ttend[K - 1] = ttend[K - 1] - fluxse * rsig[K - 1]
    fluxq_sc = torch.where(shallow & (drh >= 0.0),
                           fcnv * float(fshcq) * qsat[K - 1] * drh, zero)
    fluxq_vd = torch.where(~shallow & (drh >= drh0),
                           fvdiq2 * qsat[nl1] * drh, zero)
    fluxq = fluxq_sc + fluxq_vd
    qtend[nl1] = qtend[nl1] + fluxq * rsig[nl1]
    qtend[K - 1] = qtend[K - 1] - fluxq * rsig[K - 1]

    # 3. moisture diffusion above the PBL (1-based k = 3..nlev-2)
    for k in range(2, K - 2):
        if sigh[k + 1] > 0.5:
            drh0k = float(pc.RHGRAD * (sig[k + 1] - sig[k]))
            fvdiq2k = float(fvdiq * sigh[k + 1])
            drhk = rh[k + 1] - rh[k]
            fq = torch.where(drhk >= drh0k, fvdiq2k * qsat[k] * drhk, zero)
            qtend[k] = qtend[k] + fq * rsig[k]
            qtend[k + 1] = qtend[k + 1] - fq * rsig[k + 1]

    # 4. damping of super-adiabatic lapse rate
    for k in range(K - 1):
        se0 = se[k + 1] + pc.SEGRAD * (phi[k] - phi[k + 1])
        fluxse = torch.where(se[k] < se0, float(fvdise) * (se0 - se[k]), zero)
        ttend[k] = ttend[k] + fluxse * rsig[k]
        for k1 in range(k + 1, K):
            ttend[k1] = ttend[k1] - fluxse * rsig1[k]
    return (torch.stack(utend), torch.stack(vtend), torch.stack(ttend),
            torch.stack(qtend))

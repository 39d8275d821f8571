"""Initial conditions: the reference atmosphere at rest.

Counterpart of the JAX package's dycore/init.py (ini_invars.f90:36-112).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from speedy_ml_tpu_torch.core.constants import (GAMMA_LAPSE, HSCALE, HSHUM,
                                                REFRH1)
from speedy_ml_tpu_torch.dycore.model import DycoreModel
from speedy_ml_tpu_torch.dycore.state import SpectralState


def rest_state(model: DycoreModel,
               orog_geopotential: Optional[torch.Tensor] = None
               ) -> tuple[SpectralState, torch.Tensor]:
    """Reference atmosphere at rest (ini_invars.f90:36-112).

    orog_geopotential: surface geopotential g*z on the grid (lat, lon), or
    None for a flat planet.  Returns (state, phis_spectral)."""
    g, c, sht = model.geom, model.const, model.sht
    dev, dt = model.device, model.dtype
    gam1 = GAMMA_LAPSE / (1000.0 * c.grav)
    trunc = g.nlon == 4 * g.nlat_half
    if orog_geopotential is None:
        orog_geopotential = torch.zeros((g.nlat, g.nlon), dtype=dt,
                                        device=dev)
    orog = torch.as_tensor(orog_geopotential, dtype=dt, device=dev)

    phis = sht.grid_to_spec(orog)
    if trunc:
        phis = sht.trunct(phis)
    phis0 = sht.spec_to_grid(phis)

    ccon = math.sqrt(2.0)
    tref_sfc, ttop = 288.0, 216.0
    gam2 = gam1 / tref_sfc
    rgam = c.rgas * gam1
    qexp = HSCALE / HSHUM
    fsg = np.asarray(g.full_sigma)

    state = SpectralState.zeros(g, cdtype=model.cdtype, device=dev)
    # temperature: isothermal stratosphere, constant-lapse troposphere
    surfs = (-gam1 * phis).clone()
    surfs[0, 0] = surfs[0, 0] + ccon * tref_sfc
    t = state.t.clone()
    for k in (0, 1):
        t[:, k, 0, 0] = ccon * ttop
    for k in range(2, g.nlev):
        t[:, k] = surfs[None] * float(fsg[k] ** rgam)

    # log(ps) consistent with the temperature profile; p_ref = 1013 hPa
    surfg = math.log(1.013) + (1.0 / rgam) * torch.log(1.0 - gam2 * phis0)
    ps1 = sht.grid_to_spec(surfg)
    if trunc:
        ps1 = sht.trunct(ps1)
    ps = torch.stack([ps1, ps1], dim=0)

    # tropospheric specific humidity (g/kg)
    qref = REFRH1 * 0.622 * 17.0
    qsurf = sht.grid_to_spec(qref * torch.exp(qexp * surfg))
    if trunc:
        qsurf = sht.trunct(qsurf)
    tr = state.tr.clone()
    for k in range(2, g.nlev):
        tr[:, 0, k] = qsurf[None] * float(fsg[k] ** qexp)
    return SpectralState(vor=state.vor, div=state.div, t=t, ps=ps,
                         tr=tr), phis

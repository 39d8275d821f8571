"""Surface fluxes of momentum, energy and moisture (reference:
phy_suflux.f90).

Counterpart of the JAX package's physics/surface.py: bulk formulas over
land and sea with a stability correction, the land skin temperature from
one energy-balance Newton step, and land/sea blending by the fractional
mask.  Elementwise over (lat, lon).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics.humidity import qsat_from_t


class SurfaceFluxes(NamedTuple):
    ustr: tuple      # (land, sea, weighted)
    vstr: tuple
    shf: tuple
    evap: tuple
    slru: tuple
    hfluxn: tuple    # (land, sea)
    tsfc: torch.Tensor
    tskin: torch.Tensor
    u0: torch.Tensor
    v0: torch.Tensor
    t0: torch.Tensor
    q0: torch.Tensor


def sflset(phi0_grid: np.ndarray, grav: float) -> np.ndarray:
    """Orographic land-drag factor (phy_suflux.f90:358-382), numpy."""
    rhdrag = 1.0 / (grav * pc.HDRAG)
    return 1.0 + pc.FHDRAG * (1.0 - np.exp(-np.maximum(phi0_grid, 0.0)
                                           * rhdrag))


def suflux(psa, ua, va, ta, qa, rh, phi, *, phi0, fmask, tland, tsea, swav,
           ssrd, slrd, forog, alb_l, alb_s, snowc, clat_row, sigl_bot,
           wvi2_bot, rd, cp, alhc, sbc):
    """Surface fluxes (see SurfaceFluxes); index K-1 is the lowest level.
    clat_row: (lat,) cos(latitude), broadcast over longitude."""
    K = ua.shape[0]
    nl1 = K - 2
    esbc = pc.EMISFC * sbc
    esbc4 = 4.0 * esbc
    clat2d = clat_row[:, None]

    # 1. extrapolation to the surface
    u0 = pc.FWIND0 * ua[K - 1]
    v0 = pc.FWIND0 * va[K - 1]
    gtemp0 = 1.0 - pc.FTEMP0
    rcp = 1.0 / cp
    rdphi0 = -1.0 / (rd * 288.0 * sigl_bot)
    dt1 = wvi2_bot * (ta[K - 1] - ta[nl1])
    t1_land = ta[K - 1] + dt1
    t1_sea = t1_land + phi0 * dt1 * rdphi0
    t2_sea = ta[K - 1] + rcp * phi[K - 1]
    t2_land = t2_sea - rcp * phi0
    unstable = ta[K - 1] > ta[nl1]
    t1_land = torch.where(unstable, pc.FTEMP0 * t1_land + gtemp0 * t2_land,
                          ta[K - 1])
    t1_sea = torch.where(unstable, pc.FTEMP0 * t1_sea + gtemp0 * t2_sea,
                         ta[K - 1])
    t0 = t1_sea + fmask * (t1_land - t1_sea)

    # density * wind speed with gustiness
    prd = 1.0e5 / rd
    vg2 = pc.VGUST ** 2
    denvvs0 = (prd * psa / t0) * torch.sqrt(u0 * u0 + v0 * v0 + vg2)

    # 2. land fluxes with the effective skin temperature
    tskin = tland + pc.CTDAY * torch.sqrt(clat2d) * ssrd * (1.0 - alb_l) * psa
    rdth = pc.FSTAB / pc.DTHETA
    astab = 0.5
    dthl = torch.where(tskin > t2_land,
                       torch.clamp(tskin - t2_land, max=pc.DTHETA),
                       torch.clamp(astab * (tskin - t2_land),
                                   min=-pc.DTHETA))
    denvvs1 = denvvs0 * (1.0 + dthl * rdth)
    cdldv = pc.CDL * denvvs0 * forog
    ustr_l = -cdldv * ua[K - 1]
    vstr_l = -cdldv * va[K - 1]
    chlcp = pc.CHL * cp
    shf_l = chlcp * denvvs1 * (tskin - t1_land)
    q1_land = qa[K - 1]       # FHUM0 = 0
    qsat_skin = qsat_from_t(tskin, psa)
    evap_l = pc.CHL * denvvs1 * torch.clamp(swav * qsat_skin - q1_land,
                                            min=0.0)

    # 3. land energy balance -> skin temperature Newton correction
    tsk3 = tskin ** 3
    dslr = esbc4 * tsk3
    slru_l = esbc * tsk3 * tskin
    hflux_l = ssrd * (1.0 - alb_l) + slrd - (slru_l + shf_l + alhc * evap_l)
    clamb = pc.CLAMBDA + snowc * (pc.CLAMBSN - pc.CLAMBDA)
    hflux_l = hflux_l - clamb * (tskin - tland)
    dqsat = torch.where(evap_l > 0.0,
                        swav * (qsat_from_t(tskin + 1.0, psa) - qsat_skin),
                        torch.zeros_like(evap_l))
    dhfdt = clamb + dslr + pc.CHL * denvvs1 * (cp + alhc * dqsat)
    dtskin = hflux_l / dhfdt
    tskin = tskin + dtskin
    shf_l = shf_l + chlcp * denvvs1 * dtskin
    evap_l = evap_l + pc.CHL * denvvs1 * dqsat * dtskin
    slru_l = slru_l + dslr * dtskin
    hflux_l = clamb * (tskin - tland)

    # 4. sea fluxes
    dths = torch.where(tsea > t2_sea,
                       torch.clamp(tsea - t2_sea, max=pc.DTHETA),
                       torch.clamp(astab * (tsea - t2_sea), min=-pc.DTHETA))
    denvvs2 = denvvs0 * (1.0 + dths * rdth)
    q1_sea = qa[K - 1]
    cdsdv = pc.CDS * denvvs2
    ustr_s = -cdsdv * ua[K - 1]
    vstr_s = -cdsdv * va[K - 1]
    chscp = pc.CHS * cp
    shf_s = chscp * denvvs2 * (tsea - t1_sea)
    evap_s = pc.CHS * denvvs2 * (qsat_from_t(tsea, psa) - q1_sea)
    slru_s = esbc * tsea ** 4
    hflux_s = ssrd * (1.0 - alb_s) + slrd - (slru_s + shf_s + alhc * evap_s)

    # 5. land/sea weighted averages
    w = fmask
    blend = lambda s, l: s + w * (l - s)
    return SurfaceFluxes(
        ustr=(ustr_l, ustr_s, blend(ustr_s, ustr_l)),
        vstr=(vstr_l, vstr_s, blend(vstr_s, vstr_l)),
        shf=(shf_l, shf_s, blend(shf_s, shf_l)),
        evap=(evap_l, evap_s, blend(evap_s, evap_l)),
        slru=(slru_l, slru_s, blend(slru_s, slru_l)),
        hfluxn=(hflux_l, hflux_s), tsfc=blend(tsea, tland),
        tskin=blend(tsea, tskin), u0=u0, v0=v0,
        t0=blend(t1_sea, t1_land), q0=blend(q1_sea, q1_land))

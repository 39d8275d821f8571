"""K11: the surface fluxes of one step, their tables and their plain
version.  The kernel is part of K10a_down_surface
(kernels/column_longwave.py `down_surface`, csrc/column_surface.cuh),
which forms the downward longwave at the surface, slrd, and the surface
fluxes in one launch.

The surface fluxes are the JAX package's physics/surface.py:40 suflux
per grid column: the wind, temperature and humidity extrapolated to the
surface, the land fluxes with the skin temperature from one Newton step
of the energy balance, the sea fluxes, and the land/sea blend.
`surface_fluxes_plain` takes what suflux takes (the unused rh left out;
ua, va, ta, qa, phi the (K, lat, lon) level fields, of which the kernel
reads the lowest two; clat the (lat,) cosines of latitude) and returns a
SurfaceFluxes, all 23 planes of it.

The scalars of suflux reach the kernel as one small buffer in the
model's dtype (SurfaceTables.blob), built once from the very Python
floats the plain version uses.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics.surface import SurfaceFluxes, suflux

N_PLANES = 23               # the SurfaceFluxes planes, see unpack
N_SCALARS = 24              # the blob, see blob_scalars
RD = 287.0                  # the gas constant suflux takes (driver.py)


class SurfaceTables(NamedTuple):
    sigl_bot: float         # log sigma of the lowest level
    wvi2_bot: float
    cp: float
    alhc: float
    sbc: float
    blob: torch.Tensor      # the kernel's scalars, see blob_scalars


def blob_scalars(sigl_bot, wvi2_bot, cp, alhc, sbc) -> list[float]:
    """The scalars of the blob, as suflux forms them (Python floats):
    FWIND0, rcp, rdphi0, wvi2_bot, FTEMP0, gtemp0, prd, vg2, CTDAY, rdth,
    astab, DTHETA, CDL, CHL, chlcp, esbc, esbc4, alhc, CLAMBDA,
    CLAMBSN - CLAMBDA, cp, CDS, CHS, chscp."""
    esbc = pc.EMISFC * sbc
    return [pc.FWIND0, 1.0 / cp, -1.0 / (RD * 288.0 * sigl_bot), wvi2_bot,
            pc.FTEMP0, 1.0 - pc.FTEMP0, 1.0e5 / RD, pc.VGUST ** 2,
            pc.CTDAY, pc.FSTAB / pc.DTHETA, 0.5, pc.DTHETA, pc.CDL, pc.CHL,
            pc.CHL * cp, esbc, 4.0 * esbc, alhc, pc.CLAMBDA,
            pc.CLAMBSN - pc.CLAMBDA, cp, pc.CDS, pc.CHS, pc.CHS * cp]


def surface_tables(sigl_bot: float, wvi2_bot: float, const, dtype,
                   device) -> SurfaceTables:
    """The tables of both versions; const holds cp, alhc, sbc."""
    vals = blob_scalars(sigl_bot, wvi2_bot, const.cp, const.alhc, const.sbc)
    blob = torch.tensor(vals, dtype=torch.float64).to(dtype).to(device)
    return SurfaceTables(sigl_bot=sigl_bot, wvi2_bot=wvi2_bot, cp=const.cp,
                         alhc=const.alhc, sbc=const.sbc, blob=blob)


def surface_fluxes_plain(psg, ua, va, ta, qa, phi, *, phi0, fmask, tland,
                         tsea, swav, ssrd, slrd, forog, alb_l, alb_s, snowc,
                         clat, tabs: SurfaceTables) -> SurfaceFluxes:
    """The plain PyTorch version of the kernel: suflux."""
    return suflux(psg, ua, va, ta, qa, None, phi, phi0=phi0, fmask=fmask,
                  tland=tland, tsea=tsea, swav=swav, ssrd=ssrd, slrd=slrd,
                  forog=forog, alb_l=alb_l, alb_s=alb_s, snowc=snowc,
                  clat_row=clat, sigl_bot=tabs.sigl_bot,
                  wvi2_bot=tabs.wvi2_bot, rd=RD, cp=tabs.cp, alhc=tabs.alhc,
                  sbc=tabs.sbc)


def unpack(out) -> SurfaceFluxes:
    """The kernel's 23 surface planes ((23, lat, lon), csrc/column_surface.cuh
    sfc_tail) as views."""
    three = lambda i: (out[i], out[i + 1], out[i + 2])
    return SurfaceFluxes(ustr=three(0), vstr=three(3), shf=three(6),
                         evap=three(9), slru=three(12),
                         hfluxn=(out[15], out[16]), tsfc=out[17],
                         tskin=out[18], u0=out[19], v0=out[20], t0=out[21],
                         q0=out[22])


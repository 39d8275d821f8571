"""K11: the surface fluxes of one step (csrc/column_surface.cu) and its
plain version.

`surface_fluxes` is the JAX package's physics/surface.py:40 suflux per
grid column: the wind, temperature and humidity extrapolated to the
surface, the land fluxes with the skin temperature from one Newton step
of the energy balance, the sea fluxes, and the land/sea blend.  It takes
what suflux takes (the unused rh left out; ua, va, ta, qa, phi the
(K, lat, lon) level fields, of which the kernel reads the lowest two;
clat the (lat,) cosines of latitude) and returns a SurfaceFluxes, all 23
planes of it.

The scalars of suflux reach the kernel as one small buffer in the
model's dtype (SurfaceTables.blob), built once from the very Python
floats the plain version uses.  The kernel is compiled for float32 (the
main path) and float64.

On a CPU tensor `surface_fluxes` runs `surface_fluxes_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics.surface import SurfaceFluxes, suflux

KERNEL_LEVELS = (5, 7, 8)   # K values compiled in csrc/column_surface.cu
N_PLANES = 23               # the SurfaceFluxes planes, see unpack
N_SCALARS = 24              # the blob, see blob_scalars
RD = 287.0                  # the gas constant suflux takes (driver.py)
# the operands, in the order of SurfaceIn (csrc/column_surface.cuh)
LEVEL_INPUTS = ("ua", "va", "ta", "qa", "phi")
PLANE_INPUTS = ("phi0", "fmask", "tland", "tsea", "swav", "ssrd", "slrd",
                "forog", "alb_l", "alb_s", "snowc")
INPUTS = ("psg",) + LEVEL_INPUTS + PLANE_INPUTS + ("clat",)


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


def operands(psg, ua, va, ta, qa, phi, *, tabs: SurfaceTables, **planes):
    """Validate the operands of either route: ta's floating dtype,
    contiguous, on ta's device.  Returns (K, nlat, nlon, the tensors in
    the kernel's order)."""
    K, nlat, nlon = kb.level_dims(ta, "ta")
    named = dict(psg=psg, ua=ua, va=va, ta=ta, qa=qa, phi=phi, **planes)
    shape = lambda nm: ((K, nlat, nlon) if nm in LEVEL_INPUTS
                        else (nlat,) if nm == "clat" else (nlat, nlon))
    for nm in INPUTS:
        kb.require(named[nm], nm, ta.dtype, shape(nm), ta.device)
    kb.require(tabs.blob, "tabs.blob", ta.dtype, (N_SCALARS,), ta.device)
    return K, nlat, nlon, [named[nm] for nm in INPUTS]


def surface_fluxes(psg, ua, va, ta, qa, phi, *, phi0, fmask, tland, tsea,
                   swav, ssrd, slrd, forog, alb_l, alb_s, snowc, clat,
                   tabs: SurfaceTables) -> SurfaceFluxes:
    """The surface fluxes of one step (see the module docstring)."""
    planes = dict(phi0=phi0, fmask=fmask, tland=tland, tsea=tsea, swav=swav,
                  ssrd=ssrd, slrd=slrd, forog=forog, alb_l=alb_l,
                  alb_s=alb_s, snowc=snowc, clat=clat)
    K, nlat, nlon, ins = operands(psg, ua, va, ta, qa, phi, tabs=tabs,
                                  **planes)
    if kb.column_route("surface_fluxes", ta.device, K,
                       KERNEL_LEVELS) == "cpu":
        return surface_fluxes_plain(psg, ua, va, ta, qa, phi, tabs=tabs,
                                    **planes)
    out = torch.empty((N_PLANES, nlat, nlon), dtype=ta.dtype,
                      device=ta.device)
    code = kb.library().surface_fluxes_launch(
        kb.device_index(ta), K, int(ta.dtype == torch.float64),
        kb.pointer_array(ins), len(ins), tabs.blob.data_ptr(), nlat * nlon,
        nlon, out.data_ptr(), kb.stream_of(ta))
    kb.check(code, "surface_fluxes")
    surface_fluxes.launches += 1
    return unpack(out)


def unpack(out) -> SurfaceFluxes:
    """The kernel's output buffer ((23, lat, lon),
    csrc/column_surface.cuh surface_fluxes_at) as views."""
    three = lambda i: (out[i], out[i + 1], out[i + 2])
    return SurfaceFluxes(ustr=three(0), vstr=three(3), shf=three(6),
                         evap=three(9), slru=three(12),
                         hfluxn=(out[15], out[16]), tsfc=out[17],
                         tskin=out[18], u0=out[19], v0=out[20], t0=out[21],
                         q0=out[22])


surface_fluxes.launches = 0

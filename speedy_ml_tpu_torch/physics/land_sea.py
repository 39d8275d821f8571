"""Slab land and sea(+ice) anomaly models, the coupled-surface state and
its climatological initialisation, and the daily coupler exchange.

Counterpart of the JAX package's physics/land_sea.py (the reference's
mod_cpl_land_model.f90, cpl_sea_model.f90, cpl_land.f90, cpl_sea.f90,
cpl_bcinterp.f90).  The month index imon and the month fraction fmon
are host numbers here (they come from the calendar), so the
interpolation weights are Python numbers and the month tables are
indexed without a device read.  The climatology is K17's
(kernels/surface_forcing.py, whose plain version holds forint and
forin5, named here too); the daily exchange (couple_daily) is K21
(kernels/slab_couple.py), whose plain version is its body on the CPU.
The slab coefficients and the sea-domain masks are host numpy, built
once (build_slab_coeffs puts them on the GCM's device).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from speedy_ml_tpu_torch.kernels.slab_couple import (FLUX_FIELDS,
                                                     SURFACE_FIELDS,
                                                     slab_couple)
from speedy_ml_tpu_torch.kernels.surface_forcing import (  # noqa: F401
    SURFACE, climatology_plain, forin5, forint,
    surface_forcing)   # forin5: re-exported
from speedy_ml_tpu_torch.physics.boundaries import BoundaryData

SLAB_SLICE = "the slab-ocean slice of the port (A10b: the slab-ocean " \
    "reservoirs and their trainers)"


@dataclasses.dataclass(frozen=True)
class CplFlags:
    """Coupling options (mod_cpl_flags.f90 + the cls_insea.h domain
    flags); defaults are the reference's production setting.  All host
    values: the branches are Python branches (kernel arguments on the
    card).

    icsea: <=1 observed SST (climatology, + obs anomaly when isstan>0);
           2 full ocean-model SST; 3 climatology + ocean-model anomaly;
           >=4 as 3 but blended toward the observed anomaly inside the
           elnino domain (sea2atm, cpl_sea.f90:150-201).
    icland / icice: prognostic slab land / sea-ice (0 = climatology).
    isstan: >0 = apply observed SST anomalies (sstan_ob).
    sea_domains: regional domains where SST/ice anomalies relax to the
    slab model ("globe", "northe", "natlan", "npacif", "tropic",
    "indian"); outside them cdsea/cdice = 0 (cpl_sea_model.f90:84-118)."""
    icland: int = 1
    icsea: int = 0
    icice: int = 1
    isstan: int = 0
    sea_domains: tuple = ("globe",)


@dataclasses.dataclass(frozen=True)
class SurfaceState:
    """Prognostic coupled-surface state + the atmospheric-side fields."""
    stl_lm: torch.Tensor     # land model surface temperature
    sst_om: torch.Tensor     # ocean model SST (0 when icsea=0)
    tice_om: torch.Tensor    # sea-ice temperature
    sice_om: torch.Tensor    # sea-ice fraction
    stl_am: torch.Tensor     # what suflux/fordate consume:
    snowd_am: torch.Tensor
    soilw_am: torch.Tensor
    sst_am: torch.Tensor
    sice_am: torch.Tensor
    tice_am: torch.Tensor


def sea_domain_mask(name: str, lat_deg: np.ndarray, nlon: int) -> np.ndarray:
    """Regional ocean-domain mask (sea_domain, cpl_sea_model.f90:208-301),
    host numpy.  Longitudes are 0..360 east, lon[i] = i*360/nlon, as in
    the reference's rlon = (i-1)*dlon."""
    nlat = lat_deg.shape[0]
    m = np.zeros((nlat, nlon))
    rlon = np.arange(nlon) * (360.0 / nlon)
    lat = np.asarray(lat_deg)[:, None]
    lon = rlon[None, :]
    if name == "globe":
        m[:] = 1.0
    elif name == "northe":
        m[:] = np.where(lat > 20.0, 1.0, 0.0)
    elif name == "natlan":
        m[:] = np.where((lat > 20.0) & (lat < 80.0)
                        & ((lon < 45.0) | (lon > 260.0)), 1.0, 0.0)
    elif name == "npacif":
        m[:] = np.where((lat > 20.0) & (lat < 65.0)
                        & (lon > 120.0) & (lon < 260.0), 1.0, 0.0)
    elif name == "tropic":
        m[:] = np.where((lat > -30.0) & (lat < 30.0), 1.0, 0.0)
    elif name == "indian":
        m[:] = np.where((lat > -30.0) & (lat < 30.0)
                        & (lon > 30.0) & (lon < 120.0), 1.0, 0.0)
    elif name == "elnino":
        arlat = np.abs(lat)
        wlat = np.where(arlat > 15.0, (0.1 * (25.0 - arlat)) ** 2, 1.0)
        rlonw = 300.0 - 2.0 * np.maximum(lat, 0.0)
        core = (lon > 165.0) & (lon < rlonw)
        ramp = (lon > 155.0) & (lon <= 165.0)
        m[:] = np.where(arlat < 25.0,
                        np.where(core, wlat,
                                 np.where(ramp, wlat * 0.1 * (lon - 155.0),
                                          0.0)),
                        0.0)
    else:
        raise ValueError(f"unknown sea domain {name!r}")
    return m


class SlabCoeffs(NamedTuple):
    """Constant heat capacities / damping (land_model_init,
    sea_model_init): (lat, lon) planes, views of one tensor."""
    rhcapl: torch.Tensor
    cdland: torch.Tensor
    rhcaps: torch.Tensor
    rhcapi: torch.Tensor
    cdsea: torch.Tensor
    cdice: torch.Tensor


def build_slab_coeffs(bd: BoundaryData, lat_deg: np.ndarray, dtype,
                      sea_domains: tuple = ("globe",),
                      device=None) -> SlabCoeffs:
    """The slab coefficients, worked out in host numpy from bd's land and
    sea masks and albedo, as views of one (6, lat, lon) tensor on
    `device` (default bd's) in `dtype`: one host-to-device copy, once."""
    as_np = lambda t: t.detach().cpu().numpy() if torch.is_tensor(t) \
        else np.asarray(t)
    fmask_l = as_np(bd.fmask_l)
    alb0 = as_np(bd.alb0)
    fmask_s = as_np(bd.fmask_s)

    # land (mod_cpl_land_model.f90:20-83)
    depth_soil, depth_lice, tdland, flandmin = 1.0, 5.0, 40.0, 1.0 / 3.0
    hcapl = depth_soil * 2.50e6
    hcapli = depth_lice * 1.93e6
    dmask_l = np.where(fmask_l < flandmin, 0.0, 1.0)
    rhcapl = np.where(alb0 < 0.4, 86400.0 / hcapl, 86400.0 / hcapli)
    rhcapl = np.broadcast_to(rhcapl, fmask_l.shape)
    cdland = dmask_l * tdland / (1.0 + dmask_l * tdland)

    # sea (cpl_sea_model.f90:1-115)
    depth_ml, dept0_ml = 60.0, 40.0
    depth_ice, dept0_ice = 2.5, 1.5
    tdsst, tdice, fseamin = 90.0, 30.0, 1.0 / 3.0
    coslat = np.cos(np.deg2rad(lat_deg))
    hcaps = 4.18e6 * (depth_ml + (dept0_ml - depth_ml) * coslat**3)
    hcapi = 1.93e6 * (depth_ice + (dept0_ice - depth_ice) * coslat**2)

    # domain mask: union of the selected regional domains
    # (cpl_sea_model.f90:84-96); "globe" short-circuits to all-ones
    if "globe" in sea_domains:
        dmask = np.ones_like(fmask_s)
    else:
        dmask = np.zeros_like(fmask_s)
        for name in sea_domains:
            dmask = np.maximum(dmask, sea_domain_mask(
                name, np.asarray(lat_deg), fmask_s.shape[1]))
    sm = dmask.copy()
    sm[1:-1] = 0.25 * (dmask[:-2] + 2 * dmask[1:-1] + dmask[2:])
    dmask = np.where(fmask_s < fseamin, 0.0, sm)

    rhcaps = np.broadcast_to(86400.0 / hcaps[:, None], fmask_s.shape)
    rhcapi = np.broadcast_to(86400.0 / hcapi[:, None], fmask_s.shape)
    cdsea = dmask * tdsst / (1.0 + dmask * tdsst)
    cdice = dmask * tdice / (1.0 + dmask * tdice)

    planes = np.stack([np.asarray(x, dtype=np.float64) for x in
                       (rhcapl, cdland, rhcaps, rhcapi, cdsea, cdice)])
    dev = bd.fmask_l.device if device is None and torch.is_tensor(
        bd.fmask_l) else device
    # each plane rounded once from the float64 host value, as the JAX
    # package's np.asarray(x, dtype) does
    t = torch.as_tensor(planes).to(device=dev, dtype=dtype)
    return SlabCoeffs(*t.unbind(0))


def surface_state(planes, icsea: int) -> SurfaceState:
    """The SurfaceState whose fields are the SURFACE planes of K17
    (kernels/surface_forcing.py), (8, lat, lon): icsea <= 0 starts the
    ocean-model SST at 0, icsea > 0 at the climatology."""
    p = dict(zip(SURFACE, planes))
    return SurfaceState(
        stl_lm=p["stl"], sst_om=p["sst"] if icsea > 0 else p["zero"],
        tice_om=p["tice"], sice_om=p["sice"], stl_am=p["stl"],
        snowd_am=p["snowd"], soilw_am=p["soilw"], sst_am=p["sst_am"],
        sice_am=p["sice"], tice_am=p["tice"])


def init_surface_state(bd: BoundaryData, imon: int, fmon: float,
                       sst_hybrid=None, sst_bias: float = 0.0,
                       flags: CplFlags = CplFlags()) -> SurfaceState:
    """ini_land + ini_sea (+ the hybrid SST injection, cpl_sea.f90:38-46):
    the date-interpolated climatology with the sea-ice adjustment
    (atm2sea/atm2land, cpl_sea.f90:92-114), one K17 launch on the card
    (kernels/surface_forcing.py)."""
    planes, _ = surface_forcing(bd, month=(imon, fmon),
                                sst_hybrid=sst_hybrid, sst_bias=sst_bias)
    return surface_state(planes, flags.icsea)


def coupled_state(planes) -> SurfaceState:
    """The SurfaceState whose fields are the planes of K21's surface
    output (kernels/slab_couple.py SURFACE_FIELDS), (10, lat, lon)."""
    return SurfaceState(**dict(zip(SURFACE_FIELDS, planes)))


# the date-interpolated climatology with the sea-ice adjustment, under
# the JAX package's name: (bd, imon, fmon) -> dict of stlcl, snowdcl,
# soilwcl, sstcl, sicecl, ticecl, sstcl0 (plain PyTorch; K17 and K21 make
# the same planes)
interp_climatology = climatology_plain


def couple_daily(state: SurfaceState, coeffs: SlabCoeffs, bd: BoundaryData,
                 fluxes, imon: int, fmon: float,
                 flags: CplFlags = CplFlags(),
                 sstan_ob: Optional[torch.Tensor] = None,
                 wsst_ob: Optional[torch.Tensor] = None,
                 sstom12: Optional[torch.Tensor] = None) -> SurfaceState:
    """agcm_to_coupler + coupler_to_agcm for one day: one K21 launch on the
    card (kernels/slab_couple.py, whose plain version this is on the CPU).

    fluxes: the daily-mean hflux_l, hflux_s, hflux_i (a dict or a
    FluxAccumulator); imon, fmon host numbers; the flag branches are host
    branches:
    - icland: prognostic slab land temperature vs climatology;
    - icsea / isstan: sea2atm SST modes (cpl_sea.f90:150-201);
    - icice: prognostic vs climatological sea ice;
    - sstan_ob: observed SST anomaly at this date (isstan>0 / icsea>=4);
    - wsst_ob: elnino-domain blend weights (icsea>=4);
    - sstom12: ocean-model monthly SST climatology (icsea>=3), by default
      the observed sst12."""
    get = (lambda k: fluxes[k]) if isinstance(fluxes, dict) \
        else (lambda k: getattr(fluxes, k))
    acc = [get(k) for k in FLUX_FIELDS[:3]] + [None]
    planes, _ = slab_couple(bd, coeffs, state, acc, (imon, fmon), flags,
                            sstan=sstan_ob, wsst=wsst_ob, sstom12=sstom12)
    return coupled_state(planes)


def sstan_for_window(sstan3, fmon: float):
    """Interpolate a 3-month (prev, this, next) observed-anomaly window to
    the date (atm2sea: forint(ngp, 2, tmonth, sstan3, ...),
    cpl_sea.f90:85-88); fmon a host number.  K21's day form does the same
    inside its launch."""
    return forint(sstan3, 1, fmon)

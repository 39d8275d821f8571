"""The coupled-surface state and its climatological initialisation.

Counterpart of the JAX package's physics/land_sea.py (the reference's
cpl_bcinterp.f90, cpl_sea.f90, cpl_land.f90).  The month index imon and
the month fraction fmon are host numbers here (they come from the
calendar), so the interpolation weights are Python branches and the
month tables are indexed without a device read.  The daily slab-model
exchange (couple_daily, build_slab_coeffs, sea_domain_mask,
sstan_for_window) comes with the cycle options.
"""

from __future__ import annotations

import dataclasses

import torch

from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics.boundaries import BoundaryData

SLAB_SLICE = "the cycle-options slice of the port (A10: slab land/sea " \
    "coupler, run_days)"


@dataclasses.dataclass(frozen=True)
class CplFlags:
    """Coupling options (mod_cpl_flags.f90); defaults are the reference's
    production setting.  This slice runs the climatological surface of
    a 6-h window; the flags matter to the daily coupler (A10)."""
    icland: int = 1
    icsea: int = 0
    icice: int = 1
    isstan: int = 0
    sea_domains: tuple = ("globe",)


def forint(for12, imon: int, fmon: float):
    """Linear interpolation of a monthly climatology (cpl_bcinterp.f90:
    1-23).  for12 (12, ...); imon 0-based; fmon in (0, 1)."""
    imon = int(imon)
    if fmon <= 0.5:
        imon2, wmon = (imon - 1) % 12, 0.5 - fmon
    else:
        imon2, wmon = (imon + 1) % 12, fmon - 0.5
    return for12[imon] + wmon * (for12[imon2] - for12[imon])


def forin5(for12, imon: int, fmon: float):
    """Mean-conserving nonlinear interpolation (cpl_bcinterp.f90:25-60)."""
    imon = int(imon)
    im2, im1 = (imon - 2) % 12, (imon - 1) % 12
    ip1, ip2 = (imon + 1) % 12, (imon + 2) % 12
    c0 = 1.0 / 12.0
    t0 = c0 * fmon
    t1 = c0 * (1.0 - fmon)
    t2 = 0.25 * fmon * (1.0 - fmon)
    wm2 = -t1 + t2
    wm1 = -c0 + 8 * t1 - 6 * t2
    w0 = 7 * c0 + 10 * t2
    wp1 = -c0 + 8 * t0 - 6 * t2
    wp2 = -t0 + t2
    return (wm2 * for12[im2] + wm1 * for12[im1] + w0 * for12[imon]
            + wp1 * for12[ip1] + wp2 * for12[ip2])


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


def interp_climatology(bd: BoundaryData, imon: int, fmon: float) -> dict:
    """Date-interpolated climatological surface fields + the sea-ice
    adjustment (atm2sea/atm2land, cpl_sea.f90:92-114)."""
    stlcl = forin5(bd.stl12, imon, fmon)
    snowdcl = forint(bd.snowd12, imon, fmon)
    soilwcl = forint(bd.soilw12, imon, fmon)
    sstcl = forin5(bd.sst12, imon, fmon)
    sicecl = forint(bd.sice12, imon, fmon)
    warm = sstcl > pc.SSTFR
    sicecl_w = torch.clamp(sicecl, max=0.5)
    ticecl_w = torch.full_like(sstcl, pc.SSTFR)
    sstcl_w = torch.where(sicecl_w > 0.0,
                          pc.SSTFR + (sstcl - pc.SSTFR) / (1.0 - sicecl_w),
                          sstcl)
    sicecl_c = torch.clamp(sicecl, min=0.5)
    ticecl_c = pc.SSTFR + (sstcl - pc.SSTFR) / sicecl_c
    sstcl_c = torch.full_like(sstcl, pc.SSTFR)
    return dict(stlcl=stlcl, snowdcl=snowdcl, soilwcl=soilwcl,
                sstcl=torch.where(warm, sstcl_w, sstcl_c),
                sicecl=torch.where(warm, sicecl_w, sicecl_c),
                ticecl=torch.where(warm, ticecl_w, ticecl_c), sstcl0=sstcl)


def init_surface_state(bd: BoundaryData, imon: int, fmon: float,
                       sst_hybrid=None, sst_bias: float = 0.0,
                       flags: CplFlags = CplFlags()) -> SurfaceState:
    """ini_land + ini_sea (+ the hybrid SST injection, cpl_sea.f90:38-46).
    icsea <= 0 starts the ocean-model SST at 0, icsea > 0 at the
    climatology."""
    cl = interp_climatology(bd, imon, fmon)
    sst_am, sice_am, tice_am = cl["sstcl"], cl["sicecl"], cl["ticecl"]
    if sst_hybrid is not None:
        diff = sst_am - sst_hybrid
        sst_am = torch.where(diff < 6.0, sst_hybrid, sst_am) + sst_bias
    sst_am = sst_am + sice_am * (tice_am - sst_am)
    sst_om = cl["sstcl"] if flags.icsea > 0 else torch.zeros_like(sst_am)
    return SurfaceState(
        stl_lm=cl["stlcl"], sst_om=sst_om, tice_om=cl["ticecl"],
        sice_om=cl["sicecl"], stl_am=cl["stlcl"], snowd_am=cl["snowdcl"],
        soilw_am=cl["soilwcl"], sst_am=sst_am, sice_am=sice_am,
        tice_am=tice_am)


def couple_daily(*args, **kwargs):
    raise NotImplementedError(f"the daily coupler comes with {SLAB_SLICE}")


def build_slab_coeffs(*args, **kwargs):
    raise NotImplementedError(f"slab coefficients come with {SLAB_SLICE}")


def sea_domain_mask(*args, **kwargs):
    raise NotImplementedError(f"sea-domain masks come with {SLAB_SLICE}")


def sstan_for_window(*args, **kwargs):
    raise NotImplementedError(f"SST anomalies come with {SLAB_SLICE}")

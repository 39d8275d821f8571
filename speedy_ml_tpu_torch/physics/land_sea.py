"""The coupled-surface state and its climatological initialisation.

Counterpart of the JAX package's physics/land_sea.py (the reference's
cpl_bcinterp.f90, cpl_sea.f90, cpl_land.f90).  The month index imon and
the month fraction fmon are host numbers here (they come from the
calendar), so the interpolation weights are Python numbers and the
month tables are indexed without a device read.  The arithmetic is
K17's (kernels/surface_forcing.py, whose plain version holds forint and
forin5, named here too).  The daily slab-model exchange (couple_daily,
build_slab_coeffs, sea_domain_mask, sstan_for_window) comes with the
cycle options.
"""

from __future__ import annotations

import dataclasses

import torch

from speedy_ml_tpu_torch.kernels.surface_forcing import (  # noqa: F401
    SURFACE, forin5, forint, surface_forcing)   # forin5, forint: re-exported
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


def couple_daily(*args, **kwargs):
    raise NotImplementedError(f"the daily coupler comes with {SLAB_SLICE}")


def build_slab_coeffs(*args, **kwargs):
    raise NotImplementedError(f"slab coefficients come with {SLAB_SLICE}")


def sea_domain_mask(*args, **kwargs):
    raise NotImplementedError(f"sea-domain masks come with {SLAB_SLICE}")


def sstan_for_window(*args, **kwargs):
    raise NotImplementedError(f"SST anomalies come with {SLAB_SLICE}")

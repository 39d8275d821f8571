"""Boundary-condition data: orography, masks, monthly climatologies.

Counterpart of the JAX package's physics/boundaries.py.  This slice has
the analytic boundaries (`synthetic_boundary_data`, the aquaplanet or
uniform land) and the .npz export/import; the reader of the reference's
fort.20-26 files comes once those files are in the repository.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.physics.surface import sflset

THRSH = 0.1   # land/sea fraction threshold
BC_FILES_SLICE = "a later slice of the port, once the reference's " \
    "fort.20-26 boundary files are in the repository"


@dataclasses.dataclass(frozen=True)
class BoundaryData:
    """Time-invariant surface fields + monthly climatologies (tensors)."""
    orog: torch.Tensor       # surface geopotential g*z (unfiltered)
    phis0: torch.Tensor      # spectrally truncated surface geopotential
    fmask: torch.Tensor      # fractional land-sea mask (1 = land)
    fmask_l: torch.Tensor    # model land fraction (thresholded)
    bmask_l: torch.Tensor
    fmask_s: torch.Tensor
    bmask_s: torch.Tensor
    alb0: torch.Tensor       # bare-land annual-mean albedo
    stl12: torch.Tensor      # (12, lat, lon) land surface temperature
    snowd12: torch.Tensor    # (12, lat, lon) snow depth [mm]
    soilw12: torch.Tensor    # (12, lat, lon) soil water availability
    sst12: torch.Tensor      # (12, lat, lon)
    sice12: torch.Tensor     # (12, lat, lon) sea-ice fraction
    forog: torch.Tensor      # orographic drag factor (sflset)

    def to(self, device=None, dtype=None) -> "BoundaryData":
        return BoundaryData(**{
            k: getattr(self, k).to(device=device, dtype=dtype)
            for k in self.__dataclass_fields__})


def fields_to_boundary(fields: dict, device, dtype) -> BoundaryData:
    """BoundaryData from numpy arrays by field name."""
    return BoundaryData(**{
        k: torch.as_tensor(np.asarray(fields[k], dtype=np.float64),
                           device=device).to(dtype)
        for k in BoundaryData.__dataclass_fields__})


def load_boundary_data(geom, sht=None, grav: float = 9.81, path=None):
    raise NotImplementedError(
        f"reading the fort.20-26 boundary files comes with {BC_FILES_SLICE}; "
        "pass bd=synthetic_boundary_data(...) or a BoundaryData")


def synthetic_boundary_data(geom, sht=None, grav: float = 9.81,
                            land: bool = False, *, dtype=None,
                            device=None) -> BoundaryData:
    """Analytic aquaplanet (or uniform-land) boundary data, as the JAX
    package's synthetic_boundary_data.  dtype/device default to sht's
    (sht is used for nothing else); without sht, float32 on the CPU."""
    dtype = dtype or (sht.dtype if sht is not None else torch.float32)
    device = device or (sht.device if sht is not None else "cpu")
    nlat, nlon = geom.nlat, geom.nlon
    zeros = np.zeros((nlat, nlon))
    ones = np.ones((nlat, nlon))
    fmask = ones.copy() if land else zeros.copy()
    lat = geom.lat_radians
    # zonally symmetric SST climatology with a mild seasonal cycle
    sst12 = np.stack([
        273.0 + 27.0 * np.cos(lat)[:, None] ** 2 * ones
        + 2.0 * np.sin(lat)[:, None] * np.cos(2 * np.pi * (m - 0.5) / 12)
        * ones for m in range(12)])
    sst12 = np.maximum(sst12, 271.4)
    return fields_to_boundary(dict(
        orog=zeros, phis0=zeros, fmask=fmask, fmask_l=fmask, bmask_l=fmask,
        fmask_s=1.0 - fmask, bmask_s=1.0 - fmask, alb0=0.1 * ones,
        stl12=sst12.copy(), snowd12=np.zeros((12, nlat, nlon)),
        soilw12=0.5 * np.ones((12, nlat, nlon)), sst12=sst12,
        sice12=np.zeros((12, nlat, nlon)), forog=sflset(zeros, grav)),
        device, dtype)


def save_npz(bd: BoundaryData, path: str):
    np.savez_compressed(path, **{
        k: getattr(bd, k).detach().cpu().numpy()
        for k in bd.__dataclass_fields__})


def load_npz(path: str, dtype=torch.float32, device=None) -> BoundaryData:
    """BoundaryData from save_npz's file, on `device` (default CUDA; raises
    without one unless device="cpu")."""
    device = resolve_device(device)
    z = np.load(path)
    return fields_to_boundary({k: z[k] for k in z.files}, device, dtype)

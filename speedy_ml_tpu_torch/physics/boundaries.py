"""Boundary-condition data: orography, masks, monthly climatologies.

Counterpart of the JAX package's physics/boundaries.py: the reader of
the reference's fort.2x direct-access boundary files (ini_inbcon.f90:
463-495 documents the record layout: one little-endian float32 row of
nlon per record, rows stored north->south), the analytic boundaries
(`synthetic_boundary_data`, the aquaplanet or uniform land) and the .npz
export/import.  The file fields are prepared in numpy (float64) and the
orography's spectral truncation runs on the CPU in the plain transforms,
so a GCM built on the card holds the same boundaries, bit for bit, as
one built on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics.surface import sflset

THRSH = 0.1   # land/sea fraction threshold
BC_PATH_ENV = "SPEEDY_ML_BC_PATH"


def read_boundary_records(path: str | Path, offset: int, nlon: int, nlat: int
                          ) -> np.ndarray:
    """Read one (nlat, nlon) field at record-group `offset`; south->north rows."""
    count = nlat * nlon
    size = Path(path).stat().st_size
    if size % (count * 4):
        raise ValueError(
            f"{path}: size {size} is not a multiple of {nlat}x{nlon} "
            "records — boundary file resolution does not match the grid")
    with open(path, "rb") as f:
        f.seek(offset * count * 4)
        raw = np.fromfile(f, dtype="<f4", count=count)
    if raw.size < count:
        raise ValueError(f"{path}: record {offset} out of range")
    field = raw.reshape(nlat, nlon)[::-1].astype(np.float64)  # file is N->S
    field[field <= -999] = 0.0
    return field


def fillsf(sf: np.ndarray, fmis: float = 0.0) -> np.ndarray:
    """Replace missing values working equator->poles (ini_inbcon.f90:412-461)."""
    sf = sf.copy()
    nlat, nlon = sf.shape
    halves = [range(nlat // 2 - 1, -1, -1), range(nlat // 2, nlat)]
    for rows in halves:
        for j in rows:
            row = sf[j]
            miss = row < fmis
            nmis = miss.sum()
            if nmis == 0:
                continue
            if nmis < nlon:
                fmean = row[~miss].sum() / (nlon - nmis)
            sf2 = np.where(miss, fmean, row)
            ext = np.concatenate([[sf2[-1]], sf2, [sf2[0]]])
            sf[j] = np.where(miss, 0.5 * (ext[:-2] + ext[2:]), row)
    return sf


def forchk(mask: np.ndarray, field: np.ndarray, fset: float) -> np.ndarray:
    """Set undefined (mask==0) points to fset (ini_inbcon.f90:283-313)."""
    return np.where(mask > 0.0, field, fset)


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


def boundary_path(path=None) -> Path:
    """The directory of fort.20-26: `path`, else $SPEEDY_ML_BC_PATH."""
    path = path or os.environ.get(BC_PATH_ENV)
    if not path:
        raise FileNotFoundError(
            f"no boundary files: pass the directory that holds fort.20-26 "
            f"(bc_path=, path=) or set ${BC_PATH_ENV}, or pass "
            f"bd=synthetic_boundary_data(...)")
    return Path(path)


def load_boundary_data(geom, sht=None, grav: float = 9.81, path=None, *,
                       dtype=None, device=None) -> BoundaryData:
    """Load the fort.20-26 boundary files and derive the masks and the
    filtered orography, as the JAX package's load_boundary_data.

    path defaults to $SPEEDY_ML_BC_PATH.  dtype and device default to
    sht's; without sht, float32 on CUDA (raises without one unless
    device="cpu").  The truncation of the orography runs on the CPU in
    the plain transforms at that dtype, wherever the fields go."""
    from speedy_ml_tpu_torch.core.spectral import SpectralTransform

    path = boundary_path(path)
    dtype = dtype or (sht.dtype if sht is not None else torch.float32)
    device = resolve_device(device or (sht.device if sht is not None
                                       else None))
    nlon, nlat = geom.nlon, geom.nlat
    rd = lambda unit, off: read_boundary_records(path / f"fort.{unit}", off,
                                                 nlon, nlat)

    orog_m = rd(20, 0)
    phi0 = grav * orog_m
    # spectral truncation of the surface geopotential (truncg at ntrun),
    # host-side prep on the CPU
    cpu_sht = SpectralTransform(
        geom, sht.radius if sht is not None else 6.371e6, dtype=dtype,
        device="cpu")
    phis_spec = cpu_sht.grid_to_spec(torch.as_tensor(phi0).to(dtype))
    phis0 = cpu_sht.spec_to_grid(cpu_sht.trunct(phis_spec)) \
        .to(torch.float64).numpy()

    fmask = rd(20, 1)
    fmask_l = fmask.copy()
    bmask_l = np.where(fmask_l >= THRSH, 1.0, 0.0)
    fmask_l = np.where(fmask_l >= THRSH,
                       np.where(fmask > 1.0 - THRSH, 1.0, fmask_l), 0.0)
    fmask_s = 1.0 - fmask
    bmask_s = np.where(fmask_s >= THRSH, 1.0, 0.0)
    fmask_s = np.where(fmask_s >= THRSH,
                       np.where(fmask_s > 1.0 - THRSH, 1.0, fmask_s), 0.0)

    alb0 = rd(20, 2)

    stl12 = np.stack([forchk(bmask_l, fillsf(rd(23, it)), 273.0)
                      for it in range(12)])
    snowd12 = np.stack([forchk(bmask_l, rd(24, it), 0.0) for it in range(12)])

    # soil water availability from layered soil moisture + vegetation
    veg = np.maximum(0.0, rd(20, 3) + 0.8 * rd(20, 4))
    idep2 = 3
    swwil2 = idep2 * pc.SWWIL
    rsw = 1.0 / (pc.SWCAP + idep2 * (pc.SWCAP - pc.SWWIL))
    soilw = []
    for it in range(12):
        swl1 = rd(26, 3 * it)
        swl2 = rd(26, 3 * it + 1)
        swroot = idep2 * swl2
        soilw.append(np.minimum(
            1.0, rsw * (swl1 + veg * np.maximum(0.0, swroot - swwil2))))
    soilw12 = np.stack([forchk(bmask_l, s, 0.0) for s in soilw])

    sst12 = np.stack([forchk(bmask_s, fillsf(rd(21, it)), 273.0)
                      for it in range(12)])
    sice12 = np.stack([forchk(bmask_s, np.maximum(rd(22, it), 0.0), 0.0)
                       for it in range(12)])

    # each float64 field rounded to dtype, as the JAX loader stores it
    return fields_to_boundary(dict(
        orog=phi0, phis0=phis0, fmask=fmask, fmask_l=fmask_l,
        bmask_l=bmask_l, fmask_s=fmask_s, bmask_s=bmask_s, alb0=alb0,
        stl12=stl12, snowd12=snowd12, soilw12=soilw12, sst12=sst12,
        sice12=sice12, forog=sflset(phis0, grav)), device, dtype)


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

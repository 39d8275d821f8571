"""K17: the SPEEDY window's entry (csrc/surface_forcing.cu), K17b: the
TISR plane, and their plain versions.

K17 is one launch over the grid.  For the date (imon, fmon) it makes the
climatological surface (the JAX package's land_sea.py interp_climatology
and init_surface_state, :191-243, with the hybrid SST): the SURFACE
planes.  For the day tyear it makes the grid part of the daily forcing
(driver.py:132-175 daily_forcing, with the zonal solar rows of
radiation.py sol_oz_traced as (lat, lon) planes): the FORCING planes,
whose first two, corh and REFRH1 (qref - qsfc), are the fields whose K5
analysis gives tcorh and qcorh.  A call makes either or both: the window
asks for both (the forcing then reads the surface made in the same
thread), init_surface_state for the surface, daily_forcing for the
forcing of a surface it is given.  The persistent surface's window
makes both in the carry form: its forcing reads the carried land
temperature (stl_carry) for stl_am.  K17b writes the plane of
solar_flux_traced, HybridAtmosphere.tisr_field; the ML-only cycle hands
K3 the date instead (TisrDate), and K3 works out the plane's elements
where it reads them.

The month indices and weights, tyear and the constants that Python works
out reach the kernel as host numbers (kernel arguments), so a call reads
nothing back from the card.  K17's device-scalar form (scalars=) reads
the same numbers from a float64 tensor on the card (scalar_values' list,
a row of the captured cycle's per-cycle block, hybrid/graph.py), so that
a replayed CUDA graph takes each cycle's date; TisrDate.dev does the same
for K3's date form.

On CPU tensors `surface_forcing` and `tisr_plane` run the plain versions;
on CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from speedy_ml_tpu_torch.core.constants import REFRH1
from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics import radiation as rad
from speedy_ml_tpu_torch.physics.humidity import qsat_from_t

# the planes of the two outputs (csrc/surface_forcing.cuh SF_*, FC_*)
SURFACE = ("stl", "snowd", "soilw", "sst", "sice", "tice", "sst_am", "zero")
FORCING = ("corh", "qcorr", "fsol", "ozupp", "ozone", "zenit", "stratz",
           "alb_l", "alb_s", "albsfc", "snowc")
# the kernel's scalar and integer arguments (csrc/surface_forcing.cuh SC_*,
# IX_*), in this order
SCALARS = ("wint", "wm2", "wm1", "w0", "wp1", "wp2", "sstfr", "sst_bias",
           "tyear", "two_pi", "day10", "pi", "oz_a", "oz_b", "csolp",
           "albice_sea", "gamlat", "pexp")
INDICES = ("imon", "imon2", "im2", "im1", "ip1", "ip2")
CSOL = 4.0 * pc.SOLC   # the Hartmann insolation's solar constant


class TisrDate(NamedTuple):
    """The TISR plane of a date, as K3's date form takes it: tyear (a
    host number) and the latitudes' sines and cosines (lat,); the plane
    is tisr_plain(tyear, slat, clat, nlon).  dev: None, or the date's
    scalar_values as a float64 tensor on the latitudes' device, which K3's
    device-scalar form reads in place of tyear."""
    tyear: float
    slat: torch.Tensor
    clat: torch.Tensor
    dev: object = None


class DayArgs(NamedTuple):
    """What the forcing needs besides the surface: tyear (a host number;
    a 0-d tensor only on the CPU), the latitudes' sines and cosines (lat,)
    and the diffusion corrections' constants (PhysicsModel.gamlat and
    .pexp)."""
    tyear: object
    slat: torch.Tensor
    clat: torch.Tensor
    gamlat: float
    pexp: float


# ---- the monthly interpolations (cpl_bcinterp.f90), host numbers

def forint_weights(imon: int, fmon: float) -> tuple[int, int, float]:
    """forint's (imon, imon2, wmon)."""
    imon = int(imon)
    if fmon <= 0.5:
        return imon, (imon - 1) % 12, 0.5 - fmon
    return imon, (imon + 1) % 12, fmon - 0.5


def forin5_weights(imon: int, fmon: float) -> tuple[tuple, tuple]:
    """forin5's months (imon-2, imon-1, imon, imon+1, imon+2) mod 12 and
    their weights."""
    imon = int(imon)
    c0 = 1.0 / 12.0
    t0 = c0 * fmon
    t1 = c0 * (1.0 - fmon)
    t2 = 0.25 * fmon * (1.0 - fmon)
    months = tuple((imon + d) % 12 for d in (-2, -1, 0, 1, 2))
    weights = (-t1 + t2, -c0 + 8 * t1 - 6 * t2, 7 * c0 + 10 * t2,
               -c0 + 8 * t0 - 6 * t2, -t0 + t2)
    return months, weights


def forint(for12, imon: int, fmon: float):
    """Linear interpolation of a monthly climatology (cpl_bcinterp.f90:
    1-23).  for12 (12, ...); imon 0-based; fmon in (0, 1)."""
    i0, i1, w = forint_weights(imon, fmon)
    return for12[i0] + w * (for12[i1] - for12[i0])


def forin5(for12, imon: int, fmon: float):
    """Mean-conserving nonlinear interpolation (cpl_bcinterp.f90:25-60)."""
    (im2, im1, i0, ip1, ip2), (wm2, wm1, w0, wp1, wp2) = \
        forin5_weights(imon, fmon)
    return (wm2 * for12[im2] + wm1 * for12[im1] + w0 * for12[i0]
            + wp1 * for12[ip1] + wp2 * for12[ip2])


# ---- the plain versions

def climatology_plain(bd, imon: int, fmon: float) -> dict:
    """The date-interpolated climatology with the sea-ice adjustment
    (interp_climatology; atm2sea/atm2land, cpl_sea.f90:92-114): stlcl,
    snowdcl, soilwcl, sstcl, sicecl, ticecl and sstcl0, the SST before
    the adjustment."""
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


def surface_plain(bd, imon: int, fmon: float, sst_hybrid=None,
                  sst_bias: float = 0.0) -> torch.Tensor:
    """The SURFACE planes (plain PyTorch): the date-interpolated
    climatology with the sea-ice adjustment (climatology_plain), the
    hybrid SST injection (cpl_sea.f90:38-46) and the ice blend."""
    cl = climatology_plain(bd, imon, fmon)
    stlcl, snowdcl, soilwcl = cl["stlcl"], cl["snowdcl"], cl["soilwcl"]
    sst, sice, tice = cl["sstcl"], cl["sicecl"], cl["ticecl"]
    sst_am = sst
    if sst_hybrid is not None:
        diff = sst_am - sst_hybrid
        sst_am = torch.where(diff < 6.0, sst_hybrid, sst_am) + sst_bias
    sst_am = sst_am + sice * (tice - sst_am)
    return torch.stack([stlcl, snowdcl, soilwcl, sst, sice, tice, sst_am,
                        torch.zeros_like(sst_am)])


def forcing_plain(bd, stl_am, snowd_am, sst_am, sice_am, day: DayArgs,
                  nlon: int) -> torch.Tensor:
    """The FORCING planes (plain PyTorch) of the surface (stl_am,
    snowd_am, sst_am, sice_am): fordate's solar forcing, surface albedo
    and the fields of the diffusion corrections (ini_fordate.f90:72-113)."""
    tyear = day.tyear
    if not torch.is_tensor(tyear):
        # a device fill, not a host->device copy
        tyear = torch.full((), float(tyear), dtype=day.slat.dtype,
                           device=day.slat.device)
    sol = rad.sol_oz_traced(tyear, day.slat, day.clat, nlon)
    snowc = torch.clamp(snowd_am / pc.SD2SC, max=1.0)
    alb_l = bd.alb0 + snowc * (pc.ALBSN - bd.alb0)
    alb_s = pc.ALBSEA + sice_am * (pc.ALBICE - pc.ALBSEA)
    albsfc = alb_s + bd.fmask_l * (alb_l - alb_s)
    corh = day.gamlat * bd.phis0
    tsfc = bd.fmask_l * stl_am + bd.fmask_s * sst_am
    tref_s = tsfc + corh
    psfc = (tsfc / tref_s) ** day.pexp
    qref = qsat_from_t(tref_s, torch.ones_like(tref_s))
    qsfc = qsat_from_t(tsfc, psfc)
    return torch.stack([corh, REFRH1 * (qref - qsfc), *sol, alb_l, alb_s,
                        albsfc, snowc])


def tisr_plain(tyear, slat, clat, nlon: int) -> torch.Tensor:
    """The TISR plane (plain PyTorch): solar_flux_traced of each latitude,
    (lat, lon)."""
    if not torch.is_tensor(tyear):
        tyear = torch.full((), float(tyear), dtype=slat.dtype,
                           device=slat.device)
    row = rad.solar_flux_traced(tyear, CSOL, slat, clat)
    return row[:, None].expand(slat.shape[0], nlon).contiguous()


# ---- the wrappers

def scalar_values(month, sst_bias: float, tyear, gamlat: float,
                  pexp: float) -> tuple[list, list | None]:
    """The kernel's scalars (SCALARS order) and integers (INDICES order;
    None without a month) as Python numbers."""
    vals = dict(sstfr=pc.SSTFR, sst_bias=float(sst_bias),
                two_pi=2.0 * math.pi, day10=10.0 / 365.0, pi=math.pi,
                oz_a=0.4 * pc.EPSSW, oz_b=0.5 * pc.EPSSW,
                csolp=CSOL / math.pi, albice_sea=pc.ALBICE - pc.ALBSEA,
                gamlat=gamlat, pexp=pexp)
    if tyear is not None:
        if torch.is_tensor(tyear):
            raise TypeError("surface_forcing: on the card tyear is a host "
                            "number, not a tensor")
        vals["tyear"] = float(tyear)
    ix = None
    if month is not None:
        i0, i1, w = forint_weights(*month)
        m5, w5 = forin5_weights(*month)
        vals.update(zip(("wint", "wm2", "wm1", "w0", "wp1", "wp2"),
                        (w,) + w5))
        ix = [i0, i1, m5[0], m5[1], m5[3], m5[4]]
    return [float(vals.get(k, 0.0)) for k in SCALARS], ix


def _scalars(month, sst_bias: float, tyear, gamlat: float, pexp: float):
    """The kernel's scalars and integers as C arrays (None for the
    integers without a month)."""
    v, ix = scalar_values(month, sst_bias, tyear, gamlat, pexp)
    return ((ctypes.c_double * len(SCALARS))(*v),
            None if ix is None else (ctypes.c_int * len(INDICES))(*ix))


def require_scalars(t, name: str, dev):
    """Check a device-scalar form's float64 operand: scalar_values' list
    (SCALARS then INDICES), contiguous, on `dev`."""
    kb.require(t, name, torch.float64, (len(SCALARS) + len(INDICES),), dev)


def tisr_scalars(tyear):
    """The scalars of the TISR plane at tyear as a C array (the kernels'
    SfScalars; K17b and K3's date form read tyear, 2 pi and 4 SOLC / pi)."""
    return _scalars(None, 0.0, tyear, 0.0, 0.0)[0]


def surface_forcing(bd, *, month=None, sst_hybrid=None, sst_bias=0.0,
                    sfc=None, day: DayArgs | None = None, stl_carry=None,
                    scalars=None):
    """(the SURFACE planes (8, lat, lon) or None, the FORCING planes (11,
    lat, lon) or None).

    month: (imon, fmon), host numbers: make the surface (with sst_hybrid,
    a (lat, lon) field or None, and sst_bias).  day: make the forcing,
    from the surface made in the same call or, without a month, from
    `sfc` (a SurfaceState).  stl_carry: the carry form (with month and
    day): the forcing reads this (lat, lon) land temperature for stl_am,
    the persistent surface's carried stl_lm; the surface planes stay as
    computed.  scalars: None, or the device-scalar form's float64
    tensor on the card (scalar_values of this call's month, sst_bias,
    tyear, gamlat and pexp, then the indices): the kernel reads the date
    from it; the CPU route reads the host numbers."""
    if month is None and day is None:
        raise ValueError("surface_forcing: ask for the surface (month=) or "
                         "the forcing (day=)")
    if day is not None and month is None and sfc is None:
        raise ValueError("surface_forcing: the forcing without a month "
                         "needs the surface sfc=")
    if stl_carry is not None and (month is None or day is None):
        raise ValueError("surface_forcing: the carry form (stl_carry=) "
                         "makes the surface and the forcing")
    dev = bd.sst12.device
    nlat, nlon = bd.sst12.shape[-2:]
    if dev.type == "cpu":
        planes = None if month is None else surface_plain(
            bd, *month, sst_hybrid=sst_hybrid, sst_bias=sst_bias)
        frc = None
        if day is not None:
            p = dict(zip(SURFACE, planes)) if planes is not None else dict(
                stl=sfc.stl_am, snowd=sfc.snowd_am, sst_am=sfc.sst_am,
                sice=sfc.sice_am)
            if stl_carry is not None:
                p["stl"] = stl_carry
            frc = forcing_plain(bd, p["stl"], p["snowd"], p["sst_am"],
                                p["sice"], day, nlon)
        return planes, frc
    if dev.type != "cuda":
        raise ValueError(f"surface_forcing: no kernel for device {dev}")
    dt = bd.sst12.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"surface_forcing: dtype {dt}, the kernel takes "
                        "float32 or float64")
    grid = (nlat, nlon)
    ins = [None] * 17
    if month is not None:
        for i, nm in enumerate(("stl12", "snowd12", "soilw12", "sst12",
                                "sice12")):
            ins[i] = getattr(bd, nm)
            kb.require(ins[i], f"bd.{nm}", dt, (12,) + grid, dev)
        if sst_hybrid is not None:
            kb.require(sst_hybrid, "sst_hybrid", dt, grid, dev)
            ins[5] = sst_hybrid
    if day is not None:
        for i, nm in enumerate(("alb0", "fmask_l", "fmask_s", "phis0"), 6):
            ins[i] = getattr(bd, nm)
            kb.require(ins[i], f"bd.{nm}", dt, grid, dev)
        if month is None:
            for i, nm in enumerate(("stl_am", "snowd_am", "sst_am",
                                    "sice_am"), 10):
                ins[i] = getattr(sfc, nm)
                kb.require(ins[i], f"sfc.{nm}", dt, grid, dev)
        kb.require(day.slat, "slat", dt, (nlat,), dev)
        kb.require(day.clat, "clat", dt, (nlat,), dev)
        ins[14], ins[15] = day.slat, day.clat
        if stl_carry is not None:
            kb.require(stl_carry, "stl_carry", dt, grid, dev)
            ins[16] = stl_carry
    if scalars is None:
        scal, ix = _scalars(month, sst_bias,
                            None if day is None else day.tyear,
                            0.0 if day is None else day.gamlat,
                            0.0 if day is None else day.pexp)
    else:
        require_scalars(scalars, "scalars", dev)
        scal = ix = None
    planes = None if month is None else torch.empty(
        (len(SURFACE),) + grid, dtype=dt, device=dev)
    frc = None if day is None else torch.empty((len(FORCING),) + grid,
                                               dtype=dt, device=dev)
    ptrs = (ctypes.c_void_p * 17)(*[None if t is None else t.data_ptr()
                                    for t in ins])
    ptr = lambda t: None if t is None else t.data_ptr()
    code = kb.library().surface_forcing_launch(
        kb.device_index(bd.sst12), int(dt == torch.float64), nlat, nlon, ptrs,
        ptr(planes), ptr(frc), scal, ix, ptr(scalars),
        kb.stream_of(bd.sst12))
    kb.check(code, "surface_forcing")
    surface_forcing.launches += 1
    surface_forcing.dev_launches += scalars is not None
    return planes, frc


def tisr_plane(tyear, slat, clat, nlon: int) -> torch.Tensor:
    """The TISR plane (lat, lon) at tyear: solar_flux_traced of each
    latitude, with the solar constant 4 SOLC."""
    dev = slat.device
    if dev.type == "cpu":
        return tisr_plain(tyear, slat, clat, nlon)
    if dev.type != "cuda":
        raise ValueError(f"tisr_plane: no kernel for device {dev}")
    dt = slat.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"tisr_plane: dtype {dt}, the kernel takes float32 "
                        "or float64")
    nlat = slat.shape[0]
    kb.require(slat, "slat", dt, (nlat,), dev)
    kb.require(clat, "clat", dt, (nlat,), dev)
    scal = tisr_scalars(tyear)
    out = torch.empty((nlat, nlon), dtype=dt, device=dev)
    code = kb.library().tisr_launch(
        kb.device_index(slat), int(dt == torch.float64), nlat, nlon,
        slat.data_ptr(), clat.data_ptr(), out.data_ptr(), scal,
        kb.stream_of(slat))
    kb.check(code, "tisr_plane")
    tisr_plane.launches += 1
    return out


surface_forcing.launches = 0
surface_forcing.dev_launches = 0   # of them, the device-scalar form's
tisr_plane.launches = 0

"""K10: the longwave radiation of one step (csrc/column_longwave.cu), two
entry points, and their plain versions.

`down_surface` (K10a_down_surface) is the downward pass and the surface
fluxes in one launch; `radlw_up` (K10b) is the upward pass, which needs
the surface fluxes' skin temperature and emission, hence two launches.
The passes are the column recursions of the JAX package's
physics/radiation.py:318 radlw_down and :381 radlw_up with the band
fractions of :38 _fband_lookup: the half-level temperatures and Planck
terms, then the 4-band, K-level flux recursion downward, and the same
recursion upward from the surface emission with the stratospheric
corrections; the surface fluxes are physics/surface.py:40 suflux
(kernels/surface_fluxes.py), which takes the downward flux at the
surface, slrd, from the downward pass of the same column.  Each wrapper
takes and returns what its plain version takes and returns
(`down_surface_plain`: physics/radiation.py radlw_down, then
surface_fluxes_plain on its slrd; radlw_up of the port); the keyword
constants of those travel in a LongwaveTables and a SurfaceTables.  The
longwave heating tt_rlw = dfabs * rps * grdscp stays with the caller.

The tables (wvi2, dsig) and the constants reach the kernels as small
buffers in the model's dtype (LongwaveTables.blob, SurfaceTables.blob),
built once from the Python floats the plain versions use.  The kernels
are compiled for float32 (the main path) and float64.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels import surface_fluxes as sf
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics import radiation as rad

KERNEL_LEVELS = (5, 7, 8)   # K values compiled in csrc/column_longwave.cu
N_TABLES, N_SCALARS = 2, 6  # the blob: (K,) tables, then scalars
# down_surface's operands, in the order of DownSurfaceIn
# (csrc/column_longwave.cuh); the level fields are (K, lat, lon), of
# which the surface fluxes read the lowest two levels
LEVEL_INPUTS = ("ta", "ua", "va", "qa", "phi")
SURFACE_PLANES = ("phi0", "fmask", "tland", "tsea", "swav", "ssrd", "forog",
                  "alb_l", "alb_s", "snowc")
INPUTS = ("ta", "tau2", "psg", "ua", "va", "qa", "phi") + SURFACE_PLANES \
    + ("clat",)


class LongwaveTables(NamedTuple):
    fband: np.ndarray       # build_fband(), kept for the plain signature
    wvi2: np.ndarray        # (K,) host, in the model's precision
    dsig: np.ndarray        # (K,) float64, host
    sbc: float
    blob: torch.Tensor      # the kernels' tables, see longwave_tables


def blob_scalars(sbc: float) -> list[float]:
    """The scalars that close the blob, as the plain versions form them
    (Python floats): sbc, 1 - EPSLW, EMISFC, 1 - EMISFC, EPSLW,
    EPSLW * EMISFC."""
    return [sbc, 1.0 - pc.EPSLW, pc.EMISFC, 1.0 - pc.EMISFC, pc.EPSLW,
            pc.EPSLW * pc.EMISFC]


def longwave_tables(wvi2, dsig, sbc, fband, dtype, device) -> LongwaveTables:
    """The tables of both versions.  wvi2: (K,) numpy in the model's
    precision; dsig: (K,) float64 numpy.  The blob, in `dtype`, in the
    order csrc/column_longwave.cuh reads it: wvi2, dsig (K each), then
    blob_scalars."""
    vals = [float(v) for v in wvi2] + [float(v) for v in dsig] \
        + blob_scalars(sbc)
    blob = torch.tensor(vals, dtype=torch.float64).to(dtype).to(device)
    return LongwaveTables(fband=fband, wvi2=wvi2, dsig=dsig, sbc=sbc,
                          blob=blob)


def _route(name: str, ta: torch.Tensor, operands, tabs: LongwaveTables,
           blob_name: str = "tabs.blob"):
    """Validate the operands of either route ((name, tensor, shape) each:
    ta's dtype, contiguous, on ta's device) and say where the call goes:
    "cpu" or "cuda"."""
    K = ta.shape[0]
    for nm, t, shape in operands:
        kb.require(t, nm, ta.dtype, shape, ta.device)
    kb.require(tabs.blob, blob_name, ta.dtype, (N_TABLES * K + N_SCALARS,),
               ta.device)
    return kb.column_route(name, ta.device, K, KERNEL_LEVELS)


def down_surface_plain(ta, tau2, psg, ua, va, qa, phi, *, phi0, fmask,
                       tland, tsea, swav, ssrd, forog, alb_l, alb_s, snowc,
                       clat, lw_tabs: LongwaveTables,
                       sfc_tabs: sf.SurfaceTables):
    """The plain PyTorch version of K10a_down_surface: radlw_down, then
    suflux on its slrd."""
    down = rad.radlw_down(ta, tau2, lw_tabs.fband, wvi2=lw_tabs.wvi2,
                          dsig=lw_tabs.dsig, sbc=lw_tabs.sbc)
    fx = sf.surface_fluxes_plain(
        psg, ua, va, ta, qa, phi, phi0=phi0, fmask=fmask, tland=tland,
        tsea=tsea, swav=swav, ssrd=ssrd, slrd=down[0], forog=forog,
        alb_l=alb_l, alb_s=alb_s, snowc=snowc, clat=clat, tabs=sfc_tabs)
    return down, fx


def down_surface(ta, tau2, psg, ua, va, qa, phi, *, phi0, fmask, tland,
                 tsea, swav, ssrd, forog, alb_l, alb_s, snowc, clat,
                 lw_tabs: LongwaveTables, sfc_tabs: sf.SurfaceTables):
    """Downward longwave and the surface fluxes of one step.  ta, ua, va,
    qa, phi (K, lat, lon), tau2 (K, 4, lat, lon), psg and the planes
    (lat, lon), clat (lat,).  Returns ((slrd, dfabs, flux_bands,
    (st4a_mean, st4a_grad)), SurfaceFluxes): what radlw_down and suflux
    return."""
    K, nlat, nlon = kb.level_dims(ta, "ta")
    named = dict(ta=ta, tau2=tau2, psg=psg, ua=ua, va=va, qa=qa, phi=phi,
                 phi0=phi0, fmask=fmask, tland=tland, tsea=tsea, swav=swav,
                 ssrd=ssrd, forog=forog, alb_l=alb_l, alb_s=alb_s,
                 snowc=snowc, clat=clat)
    shape = lambda nm: ((K, nlat, nlon) if nm in LEVEL_INPUTS
                        else (K, 4, nlat, nlon) if nm == "tau2"
                        else (nlat,) if nm == "clat" else (nlat, nlon))
    kind = _route("down_surface", ta,
                  [(nm, named[nm], shape(nm)) for nm in INPUTS], lw_tabs,
                  "lw_tabs.blob")
    kb.require(sfc_tabs.blob, "sfc_tabs.blob", ta.dtype, (sf.N_SCALARS,),
               ta.device)
    if kind == "cpu":
        return down_surface_plain(**named, lw_tabs=lw_tabs,
                                  sfc_tabs=sfc_tabs)
    out = torch.empty((3 * K + 5 + sf.N_PLANES, nlat, nlon), dtype=ta.dtype,
                      device=ta.device)
    ins = [named[nm] for nm in INPUTS]
    code = kb.library().down_surface_launch(
        kb.device_index(ta), K, int(ta.dtype == torch.float64),
        kb.pointer_array(ins), len(ins), lw_tabs.blob.data_ptr(),
        sfc_tabs.blob.data_ptr(), nlat * nlon, nlon, out.data_ptr(),
        kb.stream_of(ta))
    kb.check(code, "down_surface")
    down_surface.launches += 1
    return unpack_down_surface(out, K)


def unpack_down_surface(out, K: int):
    """down_surface's output buffer ((3K + 28, lat, lon),
    csrc/column_longwave.cuh dnsfc_block_load) as views: radlw_down's
    tuple and the SurfaceFluxes."""
    return unpack_down(out[:3 * K + 5], K), sf.unpack(out[3 * K + 5:])


def unpack_down(out, K: int):
    """The downward pass's planes ((3K + 5, lat, lon): slrd, dfabs,
    flux_bands, st4a_mean, st4a_grad) as radlw_down's tuple of views."""
    return (out[0], out[1:K + 1], out[K + 1:K + 5],
            (out[K + 5:2 * K + 5], out[2 * K + 5:]))


def radlw_up(ta, ts, slrd, slru_sfc, dfabs, flux_bands, st4a, tau2, stratc,
             tabs: LongwaveTables):
    """Upward longwave from the downward pass's results, the surface
    temperature ts and emission slru_sfc, and stratc (2, lat, lon).  Returns
    (slr, olr, dfabs)."""
    K, nlat, nlon = kb.level_dims(ta, "ta")
    plane, lev = (nlat, nlon), (K, nlat, nlon)
    st4a_mean, st4a_grad = st4a
    kind = _route("radlw_up", ta, (
        ("ta", ta, lev), ("ts", ts, plane), ("slrd", slrd, plane),
        ("slru_sfc", slru_sfc, plane), ("dfabs", dfabs, lev),
        ("flux_bands", flux_bands, (4, nlat, nlon)),
        ("st4a[0]", st4a_mean, lev), ("st4a[1]", st4a_grad, lev),
        ("tau2", tau2, (K, 4, nlat, nlon)),
        ("stratc", stratc, (2, nlat, nlon))), tabs)
    if kind == "cpu":
        return rad.radlw_up(ta, ts, slrd, slru_sfc, dfabs, flux_bands, st4a,
                            tau2, stratc, tabs.fband, dsig=tabs.dsig,
                            sbc=tabs.sbc)
    out = torch.empty((K + 2, nlat, nlon), dtype=ta.dtype, device=ta.device)
    code = kb.library().radlw_up_launch(
        kb.device_index(ta), K, int(ta.dtype == torch.float64),
        ta.data_ptr(), ts.data_ptr(), slrd.data_ptr(), slru_sfc.data_ptr(),
        dfabs.data_ptr(), flux_bands.data_ptr(), st4a_mean.data_ptr(),
        st4a_grad.data_ptr(), tau2.data_ptr(), stratc.data_ptr(),
        tabs.blob.data_ptr(), nlat * nlon, out.data_ptr(), kb.stream_of(ta))
    kb.check(code, "radlw_up")
    radlw_up.launches += 1
    return out[0], out[1], out[2:]


down_surface.launches = 0
radlw_up.launches = 0

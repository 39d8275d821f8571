"""K10: the longwave radiation of one step (csrc/column_longwave.cu), two
entry points, and their plain versions.

`radlw_down` (before the surface fluxes) and `radlw_up` (after them, which
is why they are two launches) are the column recursions of the JAX
package's physics/radiation.py:318 radlw_down and :381 radlw_up with the
band fractions of :38 _fband_lookup: the half-level temperatures and
Planck terms, then the 4-band, K-level flux recursion downward, and the
same recursion upward from the surface emission with the stratospheric
corrections.  They take and return what the plain versions
(physics/radiation.py radlw_down, radlw_up of the port) take and return;
the keyword constants of those travel in a LongwaveTables.  The
longwave heating tt_rlw = dfabs * rps * grdscp stays with the caller.

The tables (wvi2, dsig) and the constants reach the kernels as one small
buffer in the model's dtype (LongwaveTables.blob), built once from the
Python floats the plain versions use.  The kernels are compiled for
float32 (the main path) and float64.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics import radiation as rad

KERNEL_LEVELS = (5, 7, 8)   # K values compiled in csrc/column_longwave.cu
N_TABLES, N_SCALARS = 2, 6  # the blob: (K,) tables, then scalars


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


def _route(name: str, ta: torch.Tensor, operands, tabs: LongwaveTables):
    """Validate the operands of either route ((name, tensor, shape) each:
    ta's dtype, contiguous, on ta's device) and say where the call goes:
    "cpu" or "cuda"."""
    K = ta.shape[0]
    for nm, t, shape in operands:
        kb.require(t, nm, ta.dtype, shape, ta.device)
    kb.require(tabs.blob, "tabs.blob", ta.dtype,
               (N_TABLES * K + N_SCALARS,), ta.device)
    return kb.column_route(name, ta.device, K, KERNEL_LEVELS)


def radlw_down(ta, tau2, tabs: LongwaveTables):
    """Downward longwave.  ta (K, lat, lon), tau2 (K, 4, lat, lon).
    Returns (slrd, dfabs, flux_bands, (st4a_mean, st4a_grad))."""
    K, nlat, nlon = kb.level_dims(ta, "ta")
    kind = _route("radlw_down", ta, (
        ("ta", ta, (K, nlat, nlon)), ("tau2", tau2, (K, 4, nlat, nlon))),
        tabs)
    if kind == "cpu":
        return rad.radlw_down(ta, tau2, tabs.fband, wvi2=tabs.wvi2,
                              dsig=tabs.dsig, sbc=tabs.sbc)
    out = torch.empty((3 * K + 5, nlat, nlon), dtype=ta.dtype,
                      device=ta.device)
    code = kb.library().radlw_down_launch(
        kb.device_index(ta), K, int(ta.dtype == torch.float64),
        ta.data_ptr(), tau2.data_ptr(), tabs.blob.data_ptr(), nlat * nlon,
        out.data_ptr(), kb.stream_of(ta))
    kb.check(code, "radlw_down")
    radlw_down.launches += 1
    return unpack_down(out, K)


def unpack_down(out, K: int):
    """radlw_down's output buffer ((3K + 5, lat, lon),
    csrc/column_longwave.cuh radlw_down_at) as views."""
    return (out[0], out[1:K + 1], out[K + 1:K + 5],
            (out[K + 5:2 * K + 5], out[2 * K + 5:]))


def radlw_up(ta, ts, slrd, slru_sfc, dfabs, flux_bands, st4a, tau2, stratc,
             tabs: LongwaveTables):
    """Upward longwave from radlw_down's results, the surface temperature
    ts and emission slru_sfc, and stratc (2, lat, lon).  Returns
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


radlw_down.launches = 0
radlw_up.launches = 0

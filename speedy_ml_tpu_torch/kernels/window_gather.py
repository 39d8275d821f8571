"""K3: the window-gather + standardize kernel (csrc/window_gather.cu)
and its plain version.

For every class c: out_c = (src[idx_c] - in_mean_c) / in_std_c, where
src is the flat concatenation [atmo (V, K, lat, lon), logp, precip, sst,
tisr] and idx_c (Rc, I) int32 is the class's RegionLayout.pack_table.
All classes go in one launch.  The kernel writes NaN for an index outside
the source (the plain version raises).  The TISR field is a plane (lat,
lon), or its date (surface_forcing.TisrDate): the kernel then works out
each TISR element it reads as K17b's point does (csrc/window_gather.cuh),
and no plane is made.  The device-scalar forms, which a captured CUDA
graph of the cycle replays (hybrid/graph.py), read from the card what
the host otherwise hands over: the date (TisrDate.dev), or the row of a
TISR table (a TisrRow: the table and its row as a float64 tensor).

On CPU tensors `window_gather` runs `window_gather_plain` (with a date,
on the plane tisr_plain makes); on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from typing import NamedTuple

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels.surface_forcing import (SCALARS,
                                                         TisrDate,
                                                         require_scalars,
                                                         tisr_plain,
                                                         tisr_scalars)

MAX_CLASSES = 8   # csrc/window_gather.cuh


class TisrRow(NamedTuple):
    """A row of a TISR table as K3's device-scalar plane form reads it:
    the table (n, lat, lon), contiguous, and the row's index as a float64
    tensor of one element on the table's device."""
    table: torch.Tensor
    row: torch.Tensor


def window_gather_plain(fields, idx, in_mean, in_std) -> list:
    """The plain PyTorch version of the kernel.  fields: (atmo, logp,
    precip, sst, tisr); idx/in_mean/in_std: one (Rc, I) tensor per class."""
    src = torch.cat([f.reshape(-1) for f in fields])
    return [(src[i.long()] - m) / s for i, m, s in zip(idx, in_mean, in_std)]


def window_gather(fields, idx, in_mean, in_std) -> list:
    """Standardized packed input vectors (Rc, I) of every class.  fields:
    (atmo, logp, precip, sst, tisr), tisr a (lat, lon) plane, a TisrDate
    or a TisrRow."""
    if not (len(idx) == len(in_mean) == len(in_std)):
        raise ValueError("window_gather: one idx/in_mean/in_std per class")
    if len(fields) != 5:
        raise ValueError("window_gather: fields are (atmo, logp, precip, "
                         "sst, tisr)")
    atmo, tisr = fields[0], fields[4]
    date = isinstance(tisr, TisrDate)
    row = isinstance(tisr, TisrRow)
    if atmo.device.type == "cpu":
        if date:
            tyear = tisr.tyear if tisr.dev is None else float(
                tisr.dev[SCALARS.index("tyear")])
            fields = (*fields[:4], tisr_plain(tyear, tisr.slat, tisr.clat,
                                              atmo.shape[-1]))
        elif row:
            fields = (*fields[:4], tisr.table[int(tisr.row[0])])
        return window_gather_plain(fields, idx, in_mean, in_std)
    if atmo.device.type != "cuda":
        raise ValueError(f"window_gather: no kernel for device {atmo.device}")
    nc = len(idx)
    if not 1 <= nc <= MAX_CLASSES:
        raise ValueError(f"window_gather: {nc} classes, kernel takes 1 to "
                         f"{MAX_CLASSES}")
    dev = atmo.device
    f32 = torch.float32
    kb.require(atmo, "atmo", f32, None, dev)
    if atmo.ndim != 4:
        raise ValueError(f"window_gather: atmo shape {tuple(atmo.shape)}, "
                         "expected (V, K, lat, lon)")
    grid = tuple(atmo.shape[-2:])
    planes = fields[1:4] if date or row else fields[1:]
    for name, f in zip(("logp", "precip", "sst", "tisr"), planes):
        kb.require(f, name, f32, grid, dev)
    slat = clat = scal = date_dev = row_dev = None
    if date:
        kb.require(tisr.slat, "tisr.slat", f32, grid[:1], dev)
        kb.require(tisr.clat, "tisr.clat", f32, grid[:1], dev)
        slat, clat = tisr.slat.data_ptr(), tisr.clat.data_ptr()
        if tisr.dev is None:
            scal = tisr_scalars(tisr.tyear)
        else:
            require_scalars(tisr.dev, "tisr.dev", dev)
            date_dev = tisr.dev.data_ptr()
    if row:
        kb.require(tisr.table, "tisr.table", f32,
                   (tisr.table.shape[0],) + grid, dev)
        kb.require(tisr.row, "tisr.row", torch.float64, (1,), dev)
        planes = (*planes, tisr.table)
        row_dev = tisr.row.data_ptr()
    G = grid[0] * grid[1]
    outs = []
    for c in range(nc):
        shape = tuple(idx[c].shape)
        kb.require(idx[c], f"idx[{c}]", torch.int32, shape, dev)
        kb.require(in_mean[c], f"in_mean[{c}]", f32, shape, dev)
        kb.require(in_std[c], f"in_std[{c}]", f32, shape, dev)
        outs.append(torch.empty(shape, dtype=f32, device=dev))
    vp = ctypes.c_void_p
    arr = lambda ts: (vp * nc)(*[t.data_ptr() for t in ts])
    code = kb.library().window_gather_launch(
        kb.device_index(atmo),
        (vp * 5)(*[f.data_ptr() for f in (atmo, *planes)], *[None] * date),
        atmo.numel(), G, nc, arr(idx), arr(in_mean), arr(in_std), arr(outs),
        (ctypes.c_longlong * nc)(*[t.numel() for t in idx]), slat, clat,
        scal, grid[1] if date else 0, date_dev, row_dev, kb.stream_of(atmo))
    kb.check(code, "window_gather")
    window_gather.launches += 1
    window_gather.dev_launches += date_dev is not None or row
    return outs


window_gather.launches = 0
window_gather.dev_launches = 0   # of them, the device-scalar forms'

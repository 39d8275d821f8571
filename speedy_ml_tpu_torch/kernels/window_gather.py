"""K3: the window-gather + standardize kernel (csrc/window_gather.cu)
and its plain version.

For every class c: out_c = (src[idx_c] - in_mean_c) / in_std_c, where
src is the flat concatenation [atmo (V, K, lat, lon), logp, precip, sst,
tisr] and idx_c (Rc, I) int32 is the class's RegionLayout.pack_table.
All classes go in one launch.  The kernel writes NaN for an index outside
the source (the plain version raises).  The TISR field is a plane (lat,
lon), or its date (surface_forcing.TisrDate): the kernel then works out
each TISR element it reads as K17b's point does (csrc/window_gather.cuh),
and no plane is made.

On CPU tensors `window_gather` runs `window_gather_plain` (with a date,
on the plane tisr_plain makes); on CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels.surface_forcing import (TisrDate,
                                                         tisr_plain,
                                                         tisr_scalars)

MAX_CLASSES = 8   # csrc/window_gather.cuh


def window_gather_plain(fields, idx, in_mean, in_std) -> list:
    """The plain PyTorch version of the kernel.  fields: (atmo, logp,
    precip, sst, tisr); idx/in_mean/in_std: one (Rc, I) tensor per class."""
    src = torch.cat([f.reshape(-1) for f in fields])
    return [(src[i.long()] - m) / s for i, m, s in zip(idx, in_mean, in_std)]


def window_gather(fields, idx, in_mean, in_std) -> list:
    """Standardized packed input vectors (Rc, I) of every class.  fields:
    (atmo, logp, precip, sst, tisr), tisr a (lat, lon) plane or a
    TisrDate."""
    if not (len(idx) == len(in_mean) == len(in_std)):
        raise ValueError("window_gather: one idx/in_mean/in_std per class")
    if len(fields) != 5:
        raise ValueError("window_gather: fields are (atmo, logp, precip, "
                         "sst, tisr)")
    atmo, tisr = fields[0], fields[4]
    date = isinstance(tisr, TisrDate)
    if atmo.device.type == "cpu":
        if date:
            fields = (*fields[:4], tisr_plain(tisr.tyear, tisr.slat,
                                              tisr.clat, atmo.shape[-1]))
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
    planes = fields[1:4] if date else fields[1:]
    for name, f in zip(("logp", "precip", "sst", "tisr"), planes):
        kb.require(f, name, f32, grid, dev)
    slat = clat = scal = None
    if date:
        kb.require(tisr.slat, "tisr.slat", f32, grid[:1], dev)
        kb.require(tisr.clat, "tisr.clat", f32, grid[:1], dev)
        slat, clat = tisr.slat.data_ptr(), tisr.clat.data_ptr()
        scal = tisr_scalars(tisr.tyear)
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
        scal, grid[1] if date else 0, kb.stream_of(atmo))
    kb.check(code, "window_gather")
    window_gather.launches += 1
    return outs


window_gather.launches = 0

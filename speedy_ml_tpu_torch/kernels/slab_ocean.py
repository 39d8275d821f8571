"""K22: the slab ocean's per-cycle glue (csrc/slab_ocean.cu) and its
plain version.

The JAX cycle's slab-ocean branch (hybrid/model.py:678-726) keeps a
buffer of the last W = SLAB_STRIDE - 1 ocean input vectors per class,
shifts it every cycle, and on a slab step averages it, runs the slab ESN
and readout and scatters the unstandardized SST cores into a new SST
grid, with the land fill and the 272 K floor.  The port keeps each
class's buffer as a ring (W, Rc, I_o): slot k holds the inputs pushed at
the cycles = k (mod W), which is the JAX buffer rolled by step mod W
(ring_to_buffer, buffer_to_ring); a cycle writes one slot.  Forms:
  - "push" (every cycle but a slab step): the bottom feedback's ocean
    inputs fb_c[:, idx_c] into slot step mod W, in place;
  - "push_mean" (a slab step): the same write, then returns each class's
    mean of the W slots, summed in logical order (oldest first) and
    multiplied by 1/W;
  - "sst" (a slab step, after the slab readout): the new (lat, lon) SST
    grid from the classes' standardized readouts, through an SstTable.
The slab ESN step and readout between the two launches of a slab step are
K1 and K2.  step is a host int, so the slot and the logical order are
kernel arguments; in the push forms' device-scalar form (slot=), which a
captured CUDA graph of the cycle replays (hybrid/graph.py), the slot is
read on the card.

On CPU tensors `slab_ocean` runs `slab_ocean_plain`; on CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from speedy_ml_tpu_torch.kernels import build as kb

MAX_CLASSES = 8       # SO_MAX_CLASSES of csrc/slab_ocean.cuh
SST_MIN = 272.0       # the freezing floor of the ML SST grid (mpires.f90:458-472)
FORMS = ("push", "push_mean", "sst")


class SstTable(NamedTuple):
    """The SST form's static tables.  core_index: per class its (Rc, O)
    int64 grid points (RegionLayout.window_index of the core, flattened;
    the plain version scatters through it); src: (lat * lon,) int32, the
    offset of each point's value in the concatenation of the classes'
    flattened (Rc, O) readouts, -1 where no core covers it (the kernel
    gathers through it); base: the land fill (lat, lon) and land:
    (lat, lon) bool (sea_mask > 0: land), or both None; shape (lat,
    lon)."""
    core_index: list
    src: torch.Tensor
    base: Optional[torch.Tensor]
    land: Optional[torch.Tensor]
    shape: tuple


def sst_table(layout, classes, base_sst=None, sea_mask=None, *, device,
              dtype) -> SstTable:
    """The SstTable of `classes` (one ocean pack each, in order) on
    `device`: built once, on the host."""
    g = layout.geom
    G = g.nlat * g.nlon
    src = np.full(G, -1, dtype=np.int64)
    cores, start = [], 0
    for cls in classes:
        w = np.asarray(layout.window_index(cls, core_only=True)).reshape(
            cls.count, -1)
        if np.any(src[w] >= 0):
            raise ValueError(f"sst_table: class {cls.name}'s cores overlap "
                             "an earlier class's")
        src[w] = start + np.arange(w.size).reshape(w.shape)
        start += w.size
        cores.append(torch.as_tensor(w, dtype=torch.long, device=device))
    if start >= 2 ** 31:
        raise ValueError("sst_table: offset exceeds int32")
    if (base_sst is None) != (sea_mask is None):
        raise ValueError("sst_table: pass both base_sst and sea_mask or "
                         "neither")
    base = land = None
    if base_sst is not None:
        base = torch.as_tensor(base_sst).to(device=device,
                                            dtype=dtype).contiguous()
        land = (torch.as_tensor(sea_mask).to(device) > 0).contiguous()
    return SstTable(cores, torch.as_tensor(src.astype(np.int32),
                                           device=device), base, land,
                    (g.nlat, g.nlon))


def ring_order(step: int, W: int) -> list:
    """The ring's slots in logical order, oldest first, after the push of
    cycle `step` (the last is slot step mod W)."""
    slot = step % W
    return [(slot + 1 + k) % W for k in range(W)]


def ring_to_buffer(ring: torch.Tensor, step: int) -> torch.Tensor:
    """The JAX package's buffer (oldest first) of a ring at `step` (the
    cycle about to run)."""
    return torch.roll(ring, -(step % ring.shape[0]), dims=0)


def buffer_to_ring(buffer: torch.Tensor, step: int) -> torch.Tensor:
    """The ring of the JAX package's buffer at `step`."""
    return torch.roll(buffer, step % buffer.shape[0], dims=0)


def slab_ocean_plain(form: str, *, bufs=None, step: int = 0, fbs=None,
                     idx_maps=None, outs=None, mean_sst=None, std_sst=None,
                     table: SstTable = None):
    """The plain PyTorch version of the kernel: the arguments of
    slab_ocean."""
    if form == "sst":
        dt, dev = outs[0].dtype, outs[0].device
        sst = torch.zeros(table.shape[0] * table.shape[1], dtype=dt,
                          device=dev)
        for out, m, s, core in zip(outs, mean_sst, std_sst,
                                   table.core_index):
            v = out * s.reshape(-1, 1) + m.reshape(-1, 1)
            sst[core.reshape(-1)] = v.reshape(-1)
        sst = sst.view(table.shape)
        if table.land is not None:
            sst = torch.where(table.land, table.base, sst)
        return torch.clamp_min(sst, SST_MIN)
    W = bufs[0].shape[0]
    slot = step % W
    for fb, idx, buf in zip(fbs, idx_maps, bufs):
        buf[slot] = fb[:, idx.long()]
    if form == "push":
        return None
    order = ring_order(step, W)
    means = []
    for buf in bufs:
        s = buf[order[0]].clone()
        for o in order[1:]:
            s = s + buf[o]
        means.append(s * (1.0 / W))
    return means


def slab_ocean(form: str, *, bufs=None, step: int = 0, fbs=None,
               idx_maps=None, outs=None, mean_sst=None, std_sst=None,
               table: SstTable = None, slot=None):
    """K22 in one of its forms, for all classes in one launch.

    push, push_mean: bufs, per class the ring (W, Rc, I_o), written in
    place at slot step % W; fbs, the bottom pack's feedback (Rc, I_fb);
    idx_maps, the ocean index map (I_o,) int32.  push returns None,
    push_mean the W slots' means (Rc, I_o) per class.
    sst: outs, per class the standardized slab readout (Rc, O); mean_sst
    and std_sst, (Rc, 1) each; table, the SstTable.  Returns the new SST
    grid (lat, lon), a tensor of its own.
    slot (push forms): None, or the device-scalar form's slot, step % W
    as a float64 tensor of one element on the rings' device, read in place
    of step's."""
    if form not in FORMS:
        raise ValueError(f"slab_ocean: form {form!r}, one of {FORMS}")
    lead = outs[0] if form == "sst" else bufs[0]
    kw = dict(bufs=bufs, step=step, fbs=fbs, idx_maps=idx_maps, outs=outs,
              mean_sst=mean_sst, std_sst=std_sst, table=table)
    if lead.device.type == "cpu":
        if slot is not None and form != "sst":
            kw["step"] = int(slot[0])   # the same slot and order
        return slab_ocean_plain(form, **kw)
    if lead.device.type != "cuda":
        raise ValueError(f"slab_ocean: no kernel for device {lead.device}")
    dt, dev = lead.dtype, lead.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"slab_ocean: dtype {dt}, the kernel takes float32 "
                        "or float64")
    vp = ctypes.c_void_p
    arr = lambda ts: (vp * len(ts))(*[None if t is None else t.data_ptr()
                                      for t in ts])
    ints = lambda xs: (ctypes.c_int * len(xs))(*xs)
    counts = lambda ts: (ctypes.c_longlong * len(ts))(*[t.numel()
                                                        for t in ts])
    if form == "sst":
        nc = len(outs)
        if not (nc == len(mean_sst) == len(std_sst)
                == len(table.core_index)) or not 1 <= nc <= MAX_CLASSES:
            raise ValueError(f"slab_ocean: {nc} classes, one mean_sst, "
                             f"std_sst and table entry each, 1 to "
                             f"{MAX_CLASSES}")
        G = table.shape[0] * table.shape[1]
        for c, (o, m, s, core) in enumerate(zip(outs, mean_sst, std_sst,
                                                table.core_index)):
            kb.require(o, f"outs[{c}]", dt, tuple(core.shape), dev)
            kb.require(m, f"mean_sst[{c}]", dt, (core.shape[0], 1), dev)
            kb.require(s, f"std_sst[{c}]", dt, (core.shape[0], 1), dev)
        kb.require(table.src, "table.src", torch.int32, (G,), dev)
        if table.land is not None:
            kb.require(table.base, "table.base", dt, table.shape, dev)
            kb.require(table.land, "table.land", torch.bool, table.shape,
                       dev)
        sst = torch.empty(table.shape, dtype=dt, device=dev)
        ptr = lambda t: None if t is None else t.data_ptr()
        code = kb.library().slab_ocean_sst_launch(
            kb.device_index(lead), int(dt == torch.float64), nc, arr(outs),
            arr(mean_sst), arr(std_sst), counts(outs),
            ints([o.shape[1] for o in outs]), table.src.data_ptr(),
            ptr(table.base), ptr(table.land), G, SST_MIN, sst.data_ptr(),
            kb.stream_of(lead))
        kb.check(code, "slab_ocean")
        slab_ocean.launches += 1
        return sst
    nc = len(bufs)
    if not (nc == len(fbs) == len(idx_maps)) or not 1 <= nc <= MAX_CLASSES:
        raise ValueError(f"slab_ocean: {nc} classes, one fb and idx_map "
                         f"each, 1 to {MAX_CLASSES}")
    W = bufs[0].shape[0]
    for c, (fb, idx, buf) in enumerate(zip(fbs, idx_maps, bufs)):
        if buf.dim() != 3 or buf.shape[0] != W:
            raise ValueError(f"slab_ocean: bufs[{c}] shape "
                             f"{tuple(buf.shape)}, expected ({W}, Rc, I_o)")
        kb.require(buf, f"bufs[{c}]", dt, None, dev)
        kb.require(idx, f"idx_maps[{c}]", torch.int32, (buf.shape[2],), dev)
        kb.require(fb, f"fbs[{c}]", dt, (buf.shape[1], fb.shape[1]), dev)
    means = [None] * nc
    if form == "push_mean":
        means = [torch.empty(b.shape[1:], dtype=dt, device=dev)
                 for b in bufs]
    if slot is not None:
        kb.require(slot, "slot", torch.float64, (1,), dev)
    code = kb.library().slab_ocean_push_launch(
        kb.device_index(lead), int(dt == torch.float64), nc, arr(fbs),
        arr(idx_maps), arr(bufs), arr(means), counts([b[0] for b in bufs]),
        ints([b.shape[2] for b in bufs]), ints([f.shape[1] for f in fbs]),
        W, 0 if slot is not None else step % W, 1.0 / W,
        None if slot is None else slot.data_ptr(), kb.stream_of(lead))
    kb.check(code, "slab_ocean")
    slab_ocean.launches += 1
    slab_ocean.dev_launches += slot is not None
    return means if form == "push_mean" else None


slab_ocean.launches = 0
slab_ocean.dev_launches = 0   # of them, the push forms' device-scalar form's

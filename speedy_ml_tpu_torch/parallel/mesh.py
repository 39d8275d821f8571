"""The device mesh of the sharded cycle, in one process.

The reference's parallelism is 1,152 MPI ranks, one region each, with a
rank-0 hub for the global grid (SURVEY 2.3).  As in the JAX package
(speedy_ml_tpu/parallel/mesh.py), one program drives every device: the
mesh is a tuple of torch devices along one axis ("regions"), and a
sharded tensor is a Sharded tuple of D tensors, shard d on device d.

- the leading region axis R of every per-region tensor is split into D
  contiguous blocks of rows (shard_rows): each device holds its regions'
  weights and states, and their normal equations in training;
- a replicated tensor is the same tensor on every device (replicate);
- the global (lat, lon) grid lives on the first device, where the GCM
  runs (hybrid/sharded.py).

Nothing here starts a process group: shard d runs on device d from this
process, and tensors move between devices with .to(device).  The same
device may hold several shards (Mesh([torch.device("cuda:0")] * 4)): that
runs every line a mesh of four cards runs except the transport between
cards.  make_mesh builds a mesh only from devices that exist.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


class Mesh:
    """D devices along one axis; shard d of a sharded tensor lives on
    devices[d].  A device may repeat (several shards on one device)."""

    def __init__(self, devices: Sequence, axis: str = "regions"):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        if len(set(self.devices)) == 1 and self.size > 1:
            where = f"{self.size} shards on {self.devices[0]}"
        else:
            where = ", ".join(str(d) for d in self.devices)
        return f"Mesh({where}, axis={self.axis!r})"


class Sharded(tuple):
    """A sharded value: one entry per mesh device, in mesh order."""


def make_mesh(n_devices: int | None = None, device_type: str = "cuda",
              axis: str = "regions") -> Mesh:
    """A mesh of the first n_devices visible devices of device_type (all
    of them by default).  Raises when fewer are visible: a mesh on which
    the devices are silently fewer than asked would pass every check of
    the sharded path trivially.  Shards on one device are built with an
    explicit Mesh([device] * D)."""
    if device_type == "cuda":
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        visible = [torch.device(device_type)]
    n = len(visible) if n_devices is None else int(n_devices)
    if n < 1 or len(visible) < n:
        raise RuntimeError(
            f"make_mesh({n_devices}): {len(visible)} {device_type} "
            f"device(s) visible; build Mesh([device] * D) to put D shards "
            f"on one device")
    return Mesh(visible[:n], axis)


def shard_rows(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> Sharded:
    """t split into mesh.size equal blocks along dim (the region axis),
    block d contiguous on device d (region_sharding's layout)."""
    D = mesh.size
    if t.shape[dim] % D:
        raise ValueError(f"shard_rows: {t.shape[dim]} rows along dim {dim} "
                         f"not divisible by {D} devices")
    return Sharded(b.to(dev, non_blocking=True).contiguous()
                   for b, dev in zip(torch.chunk(t, D, dim), mesh.devices))


def gather_rows(shards: Sequence[torch.Tensor], device, dim: int = 0
                ) -> torch.Tensor:
    """The shards joined along dim on one device (inverse of shard_rows)."""
    device = torch.device(device)
    # a copy from the card into host memory is waited for: torch.cat on
    # the host reads it at once
    return torch.cat([s.to(device, non_blocking=device.type != "cpu")
                      for s in shards], dim)


def replicate(t: torch.Tensor, mesh: Mesh) -> Sharded:
    """t on every device of the mesh: one copy a device (the tensor itself
    where it already lives), shared by the shards on that device."""
    on = {}
    for dev in mesh.devices:
        if dev not in on:
            on[dev] = t.to(dev, non_blocking=True)
    return Sharded(on[dev] for dev in mesh.devices)


def shard_reservoir(res, mesh: Mesh) -> Sharded:
    """A BatchedReservoir per device holding its rows of the regions:
    vals (J, R, n) split along R (axis 1), win_vals, wout, mean, std (and
    an imported reservoir's win_cols) along their leading axis.  A shared
    sparsity pattern (cols (n, J)) is copied whole to every device; a
    per-region pattern (cols (R, n, J)) is split."""
    per = {nm: shard_rows(getattr(res, nm), mesh)
           for nm in ("win_vals", "wout", "mean", "std")}
    per["vals"] = shard_rows(res.vals, mesh, dim=1)
    per["cols"] = (replicate(res.cols, mesh) if res.cols.dim() == 2
                   else shard_rows(res.cols, mesh))
    if res.win_cols is not None:
        per["win_cols"] = shard_rows(res.win_cols, mesh)
    return Sharded(dataclasses.replace(res, **{nm: v[d]
                                               for nm, v in per.items()})
                   for d in range(mesh.size))


def pad_regions(n: int, n_devices: int) -> int:
    """Regions per class must divide the mesh for even sharding; pad count."""
    return ((n + n_devices - 1) // n_devices) * n_devices

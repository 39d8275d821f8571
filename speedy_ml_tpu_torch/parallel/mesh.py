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
  runs (hybrid/sharded.py), unless the GCM is sharded too (GridShards):
  its spectral arrays split into ranges of the zonal wavenumber m
  (m_ranges) and its grid fields into latitude bands (lat_bands).

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


# -- the GCM's two splits (GCM.set_mesh) ----------------------------------

def even_blocks(n: int, D: int) -> list:
    """[(start, stop)] of D contiguous blocks of range(n) whose sizes
    differ by at most one (the first n % D one longer).  Raises when a
    block would be empty."""
    if not 0 < D <= n:
        raise ValueError(f"{n} rows cannot be split into {D} non-empty "
                         f"blocks")
    q, r = divmod(n, D)
    starts = [d * q + min(d, r) for d in range(D + 1)]
    return list(zip(starts[:-1], starts[1:]))


def m_ranges(mx: int, D: int) -> list:
    """[(m0, m1)]: shard d's zonal wavenumbers, contiguous, sizes within
    one of each other (mx = 31 over 8 shards: 4, 4, 4, 4, 4, 4, 4, 3)."""
    return even_blocks(mx, D)


def lat_bands(nlat: int, D: int) -> list:
    """[(p0, p1)]: shard d's latitude band, a contiguous block of the
    nlat/2 latitude PAIRS (j, nlat-1-j), sizes within one of each other.
    Band d holds the rows [p0, p1) of the south and their mirrors [nlat -
    p1, nlat - p0) of the north, in that order (band_rows): the spectral
    transforms fold the hemispheres, so the synthesis (K6) of a band is
    K6 with the band's Legendre rows, and each of its outputs is the whole
    grid's bit for bit; the column physics does not care which columns a
    band holds."""
    if nlat % 2:
        raise ValueError(f"lat_bands: {nlat} latitudes, not pairs")
    return even_blocks(nlat // 2, D)


def band_rows(t: torch.Tensor, band, nlat: int, dim: int = -2
              ) -> torch.Tensor:
    """The rows of band (p0, p1) of t along dim (nlat long), contiguous:
    [south rows p0 .. p1-1 | north rows nlat-p1 .. nlat-p0-1]."""
    p0, p1 = band
    return torch.cat([t.narrow(dim, p0, p1 - p0),
                      t.narrow(dim, nlat - p1, p1 - p0)], dim)


def join_band_rows(parts, bands, dim: int = -2) -> torch.Tensor:
    """The inverse of band_rows over all the bands (parts in band order,
    on one device): the south halves in order, then the north halves in
    reverse order."""
    south = [p.narrow(dim, 0, b1 - b0) for p, (b0, b1) in zip(parts, bands)]
    north = [p.narrow(dim, b1 - b0, b1 - b0)
             for p, (b0, b1) in zip(parts, bands)]
    return torch.cat(south + north[::-1], dim)


class ShardMoves:
    """Moves of values between the shards of `mesh`, each move onto
    another shard counted (copies, copy_bytes; a move within one shard is
    not counted): the base of GridShards and of hybrid/sharded.py's
    ShardedCycleOps."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.D = mesh.size
        self.copies = self.copy_bytes = 0

    def _move(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        if src != dst:
            self.copies += 1
            self.copy_bytes += t.numel() * t.element_size()
        return t.to(self.mesh.devices[dst], non_blocking=True)

    def split_rows(self, t: torch.Tensor, src: int = 0, dim: int = 0
                   ) -> Sharded:
        """t (whole on shard src) as mesh.size equal blocks along dim, the
        region axis wherever it stands (the slab ocean's ring (W, Rc, n)
        has it on dim 1), block d contiguous on shard d (shard_rows'
        layout)."""
        if t.shape[dim] % self.D:
            raise ValueError(f"split_rows: {t.shape[dim]} rows along dim "
                             f"{dim} not divisible by {self.D} shards")
        return Sharded(self._move(b.contiguous(), src, d)
                       for d, b in enumerate(torch.chunk(t, self.D, dim)))

    def gather_pieces(self, parts, dst: int = 0, dim: int = 0
                      ) -> torch.Tensor:
        """The shards' parts (shard d's parts[d]) joined along dim on
        shard dst, in shard order: split_rows' inverse, or small per-shard
        pieces (partial sums) gathered onto one device."""
        return torch.cat([self._move(p, d, dst) for d, p in enumerate(parts)],
                         dim)

    def all_gather_pieces(self, parts, dim: int = 0) -> Sharded:
        """gather_pieces onto every shard (an all-gather)."""
        return Sharded(self.gather_pieces(parts, d, dim)
                       for d in range(self.D))

    def broadcast(self, t: torch.Tensor, src: int = 0) -> Sharded:
        """t, whole, on every shard."""
        return Sharded(self._move(t, src, d) for d in range(self.D))


class GridShards(ShardMoves):
    """The GCM over a mesh: shard d holds the zonal wavenumbers
    ranges[d] of every spectral array (m the second-to-last axis) and the
    latitude band bands[d] of every grid field (lat the second-to-last
    axis, band_rows' layout).  The methods move values between the shards
    and count each move onto another shard (ShardMoves)."""

    def __init__(self, mesh: Mesh, nlat: int, mx: int):
        super().__init__(mesh)
        self.nlat, self.mx = nlat, mx
        self.bands = lat_bands(nlat, self.D)
        self.ranges = m_ranges(mx, self.D)

    # -- one tensor -------------------------------------------------------
    def split_bands(self, t: torch.Tensor, src: int = 0, dim: int = -2
                    ) -> Sharded:
        """t (whole along dim, on shard src) as each shard's band."""
        return Sharded(self._move(band_rows(t, b, self.nlat, dim), src, d)
                       for d, b in enumerate(self.bands))

    def join_bands(self, parts, dst: int = 0, dim: int = -2
                   ) -> torch.Tensor:
        """The bands (shard d's parts[d]) joined on shard dst."""
        return join_band_rows([self._move(p, d, dst)
                               for d, p in enumerate(parts)],
                              self.bands, dim)

    def all_bands(self, parts, dim: int = -2) -> Sharded:
        """The bands joined on every shard (an all-gather)."""
        return Sharded(self.join_bands(parts, d, dim) for d in range(self.D))

    def split_ranges(self, t: torch.Tensor, src: int = 0, dim: int = -2
                     ) -> Sharded:
        """t (all mx wavenumbers along dim, on shard src) as each shard's
        m range, contiguous."""
        return Sharded(self._move(t.narrow(dim, m0, m1 - m0).contiguous(),
                                  src, d)
                       for d, (m0, m1) in enumerate(self.ranges))

    def join_ranges(self, parts, dst: int = 0, dim: int = -2
                    ) -> torch.Tensor:
        """The m ranges joined on shard dst."""
        return self.gather_pieces(parts, dst, dim)

    def all_ranges(self, parts, dim: int = -2) -> Sharded:
        """The m ranges joined on every shard (an all-gather)."""
        return self.all_gather_pieces(parts, dim)

    # -- a dataclass of grid fields --------------------------------------
    # the fields that every shard keeps whole: the radiation carry's
    # randfv (2, nlat, K), RDF's latitude profiles, which its smoothing
    # forms across the bands and its forcing reads at each band's rows
    WHOLE_FIELDS = ("randfv",)

    def split_fields(self, obj, src: int = 0) -> Sharded:
        """A dataclass of grid fields (..., lat, lon) as each shard's band
        of it (the same dataclass); a WHOLE_FIELDS field whole on every
        shard."""
        names = [f.name for f in dataclasses.fields(obj)]
        per = {nm: (self.broadcast(getattr(obj, nm), src)
                    if nm in self.WHOLE_FIELDS
                    else self.split_bands(getattr(obj, nm), src))
               for nm in names}
        return Sharded(dataclasses.replace(obj, **{nm: per[nm][d]
                                                   for nm in names})
                       for d in range(self.D))

    def join_fields(self, parts, dst: int = 0):
        """The inverse of split_fields: the bands joined on shard dst (a
        WHOLE_FIELDS field shard dst's)."""
        return dataclasses.replace(parts[dst], **{
            f.name: self.join_bands([getattr(p, f.name) for p in parts], dst)
            for f in dataclasses.fields(parts[dst])
            if f.name not in self.WHOLE_FIELDS})

"""Hub-free sharded cycle pieces: assemble, feedback and local model over
longitude sectors (the JAX package's hybrid/sharded.py).

Reference behavior: sendrecievegrid (mpires.f90:218-780) assembles the
global grid on rank 0 and re-tiles every region's overlap window back out
point-to-point.  The region order within every class is
block_x-major/block_y-minor (res_domain.f90:258-292, esn/domain.py), so
the contiguous block sharding of the region axis (parallel/mesh.py
shard_rows) IS a partition of the globe into longitude sectors: device d
owns lon columns [d*W, (d+1)*W), W = nlon/D, and exactly the regions
whose cores lie there, for every class at once.  So, on each device:

- **assemble**: the readout (K2) stores its regions' cores straight into
  the device's (lat, W) sector, with the q and precip clamps;
- **halo**: a region's input window reaches `overlap` columns past its
  sector's edge; they move between lon-neighbour devices in a periodic
  ring (halo_lon: longitude wraps, so nothing is masked);
- **feedback / local model**: K3 gathers the device's regions' windows
  from its haloed sector (the local model: the core windows, no halo)
  and standardizes them with its rows of the statistics.

The local index tables are the same on every device (the block tiling
repeats every sector), so one table set, copied to each device, serves
all: the kernels are K1, K2 and K3 as the unsharded cycle launches them,
with sector-sized tables.  Each region's and grid point's arithmetic is
the unsharded cycle's, and the halos are copies, so the sharded cycle
equals the unsharded one bit for bit.

_gather_window and _pack_window are the plain reference of the tables
(the JAX package's gathers on index arrays); the tests hold the tables
against them.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from speedy_ml_tpu_torch.esn.domain import (RegionClass, RegionLayout, band,
                                            is_bottom)
from speedy_ml_tpu_torch.esn.reservoir import esn_step
from speedy_ml_tpu_torch.kernels.core_scatter import (CoreScatter,
                                                      grid_blocks,
                                                      split_grid)
from speedy_ml_tpu_torch.kernels.readout import readout
from speedy_ml_tpu_torch.kernels.window_gather import window_gather
from speedy_ml_tpu_torch.kernels.surface_forcing import TisrDate
from speedy_ml_tpu_torch.kernels.window_gather import TisrRow
from speedy_ml_tpu_torch.parallel.mesh import (Mesh, Sharded, ShardMoves,
                                               replicate, shard_reservoir,
                                               shard_rows)

NVAR = 4


def halo_lon(sectors: Sequence[torch.Tensor], overlap: int) -> Sharded:
    """The periodic lon ring over the sectors, in mesh order: each (...,
    lat, W) sector becomes (..., lat, W + 2*overlap) = [west halo | sector
    | east halo], the halos the neighbours' edge columns moved to the
    sector's device.  Longitude wraps, so the ring is unmasked (cf. the
    pole-clipped lat ring, parallel/halo.py); with one sector it wraps
    onto itself."""
    D = len(sectors)
    if not 0 < overlap <= sectors[0].shape[-1]:
        raise ValueError(f"halo_lon: overlap {overlap} outside [1, "
                         f"{sectors[0].shape[-1]}]")
    out = []
    for d, f in enumerate(sectors):
        west = sectors[(d - 1) % D][..., -overlap:].to(f.device,
                                                       non_blocking=True)
        east = sectors[(d + 1) % D][..., :overlap].to(f.device,
                                                      non_blocking=True)
        out.append(torch.cat([west, f, east], dim=-1))
    return Sharded(out)


class _PackTables:
    """A class's local geometry on one lon sector (the same on every
    device), checked as the JAX package checks it."""

    def __init__(self, layout: RegionLayout, cls: RegionClass, D: int):
        W = layout.geom.nlon // D
        Rc = cls.count
        if Rc % D:
            raise ValueError(f"class {cls.name}: {Rc} regions not "
                             f"divisible by {D} devices")
        Rloc = Rc // D
        # device 0's regions are rows [0, Rloc); device d's the same
        # pattern d sectors east, so these tables serve every device
        x0 = np.asarray(layout.x0[cls.region_ids]).reshape(D, Rloc)
        x0_loc = x0[0]
        if x0_loc.max() + layout.xc > W or not np.array_equal(
                x0, x0_loc[None] + W * np.arange(D)[:, None]) or any(
                not np.array_equal(cls.iy_in[d * Rloc:(d + 1) * Rloc],
                                   cls.iy_in[:Rloc]) for d in range(D)):
            raise ValueError("region order is not lon-sector contiguous")
        ids = np.arange(Rloc)
        xi = cls.ix_in.shape[1]
        xc = cls.ix_core.shape[1]
        # window cols into the HALOED sector: global [x0-o, x0+xc-1+o]
        # -> local x0_loc + [0, xi); core cols into the UNHALOED sector
        self.ix_in = (x0_loc[:, None] + np.arange(xi)[None, :]
                      ).astype(np.int32)
        self.iy_in = np.asarray(cls.iy_in[ids])
        self.ix_core = (x0_loc[:, None] + np.arange(xc)[None, :]
                        ).astype(np.int32)
        self.iy_core = np.asarray(cls.iy_core[ids])
        self.Rloc = Rloc
        # the sector's blocks, block_x-major/block_y-minor
        by = np.asarray(cls.iy_core[ids, 0]) // layout.yc
        nby = int(by.max()) - int(by.min()) + 1
        nbx = W // layout.xc
        if nbx * nby != Rloc:
            raise ValueError(f"class {cls.name}: sector not a full "
                             f"{nbx}x{nby} block grid")
        # the class as its sector sees it: what RegionLayout's tables take
        self.cls = RegionClass(
            name=cls.name, region_ids=np.asarray(cls.region_ids[ids]),
            ix_core=self.ix_core, iy_core=self.iy_core, ix_in=self.ix_in,
            iy_in=self.iy_in, core_in_input_x=cls.core_in_input_x,
            core_in_input_y=cls.core_in_input_y)


def _gather_window(field, iy, ix):
    """field (..., lat, lon_local) -> (Rloc, ..., yi, xi)."""
    iy = torch.as_tensor(iy, dtype=torch.long, device=field.device)
    ix = torch.as_tensor(ix, dtype=torch.long, device=field.device)
    p = field[..., iy[:, :, None], ix[:, None, :]]
    return torch.movedim(p, -3, 0)


def _pack_window(tbl: _PackTables, atmo, fields, core: bool) -> torch.Tensor:
    """Local pack in reference order (pack_vector semantics): the atmo
    block Fortran (var, x, y, z), then a flat (y, x) block per 2-D field
    that is not None."""
    iy = tbl.iy_core if core else tbl.iy_in
    ix = tbl.ix_core if core else tbl.ix_in
    ap = _gather_window(atmo, iy, ix)            # (Rloc, V, K, y, x)
    parts = [ap.permute(0, 2, 3, 4, 1).reshape(tbl.Rloc, -1)]
    for f in fields:
        if f is not None:
            parts.append(_gather_window(f, iy, ix).reshape(tbl.Rloc, -1))
    return torch.cat(parts, dim=1)


class ShardedPack(NamedTuple):
    """One pack's parameters on the mesh, each a Sharded of the device's
    rows: the reservoirs (parallel/mesh.py shard_reservoir), the input
    and output statistics, and the local model's (the output statistics'
    first S columns, contiguous: what K3 reads)."""
    res: Sharded
    leakage: float
    in_mean: Sharded
    in_std: Sharded
    out_mean: Sharded
    out_std: Sharded
    lm_mean: Sharded
    lm_std: Sharded


class ShardedCycleOps(ShardMoves):
    """The sharded twins of HybridAtmosphere's predict_all/assemble_global,
    build_feedback and build_local_model over the region = lon-sector
    axis of `mesh`.  Every sharded value is a Sharded in mesh order.

    copies and copy_bytes count the tensors moved between shards (onto
    another shard's device; across cards on a mesh of D cards) since
    construction (ShardMoves)."""

    def __init__(self, layout: RegionLayout, packs, mesh: Mesh, nz: int):
        super().__init__(mesh)
        self.layout = layout
        D = self.D
        if layout.nx_blocks % D:
            raise ValueError(
                f"{layout.nx_blocks} lon blocks not divisible by {D} "
                "devices; sharded cycle needs lon-sector alignment")
        g = layout.geom
        self.nz = nz
        self.nlat, self.W = g.nlat, g.nlon // D
        o, W, nz = layout.overlap, self.W, self.nz
        self.tables = [_PackTables(layout, p.cls, D) for p in packs]
        # the kernels' tables, one copy on each device: K2's store into
        # the unhaloed sector [atmo (4, K, lat, W), logp, precip]; K3's
        # feedback gather from the haloed sector [atmo (4, K, lat, W + 2o),
        # logp, precip, sst, tisr]; K3's local-model gather from the
        # window's sector [atmo, logp, logp, logp, logp]
        store, fb, lm = [], [], []
        for p, tbl in zip(packs, self.tables):
            b = is_bottom(p.zspec)
            store.append(layout.core_table(tbl.cls, NVAR, nz, p.zspec,
                                           ncols=W))
            fb.append(layout.pack_table(
                tbl.cls, NVAR, nz, logp=b, precip=b, sst=b, tisr=True,
                levels=band(p.zspec, nz, core=False), ncols=W + 2 * o))
            lm.append(layout.pack_table(
                tbl.cls, NVAR, nz, logp=b, precip=False, sst=False,
                tisr=False, core_only=True,
                levels=band(p.zspec, nz, core=True), ncols=W))
        self.sector_size, self.q_block, self.p_block = grid_blocks(
            NVAR, nz, self.nlat, W)
        count = np.bincount(np.concatenate([t.ravel() for t in store]),
                            minlength=self.sector_size)
        if count.size != self.sector_size or np.any(count != 1):
            raise ValueError("the packs' cores do not tile a sector exactly "
                             "once")
        dev = lambda ts: [replicate(torch.as_tensor(t), mesh) for t in ts]
        self.store, self.feedback_index, self.local_index = (
            dev(store), dev(fb), dev(lm))
        # a TISR table's haloed sectors, by the table (tisr_rows)
        self._tisr_tables = None
        self.copies = self.copy_bytes = 0

    # -- moves between shards -------------------------------------------
    def _halo(self, sectors) -> Sharded:
        """halo_lon, its moves counted."""
        if self.D > 1:
            o = self.layout.overlap
            for s in sectors:
                self.copies += 2
                self.copy_bytes += 2 * s[..., :o].numel() * s.element_size()
        return halo_lon(sectors, self.layout.overlap)

    # -- parameters ------------------------------------------------------
    def shard_params(self, packs) -> list:
        """A ShardedPack per pack of (ClassPack) packs, whose tensors live
        whole on one device: each device's rows, copied there."""
        sh = lambda t: shard_rows(t, self.mesh)
        return [ShardedPack(
            res=shard_reservoir(p.res, self.mesh), leakage=p.hyper.leakage,
            in_mean=sh(p.std.in_mean), in_std=sh(p.std.in_std),
            out_mean=sh(p.std.out_mean), out_std=sh(p.std.out_std),
            lm_mean=sh(p.std.out_mean[:, :p.res.n_speedy]),
            lm_std=sh(p.std.out_std[:, :p.res.n_speedy]))
            for p in packs]

    # -- predict + assemble ----------------------------------------------
    def step(self, spacks, xs, feedbacks) -> list:
        """K1 on every device: each pack's new reservoir states (a
        Sharded a pack) from its states and feedback (Sharded each)."""
        return [Sharded(esn_step(sp.res[d], x[d], u[d], sp.leakage)
                        for d in range(self.D))
                for sp, x, u in zip(spacks, xs, feedbacks)]

    def assemble(self, spacks, xs, local_models=None,
                 components: bool = False) -> Sharded:
        """K2 on every device: each pack's readout of its regions' states
        xs (and local models, None for the ML-only readout), stored into
        the device's flat sector grid [atmo (4, K, lat, W), logp, precip]
        with the q and precip clamps (assemble_global's semantics, the
        vertical groups' bands through the store tables).  Returns a
        Sharded of (P, sector size) grids: P = 1, or 3 with components
        (K2's components form: v_p and v_ml, standardized and without the
        clamps, in rows 1 and 2)."""
        dtype = spacks[0].out_mean[0].dtype
        out = []
        for d, dev in enumerate(self.mesh.devices):
            grids = torch.empty((3 if components else 1, self.sector_size),
                                dtype=dtype, device=dev)
            parts = (grids[1], grids[2]) if components else None
            for i, (sp, x) in enumerate(zip(spacks, xs)):
                res = sp.res[d]
                readout(res.wout, x[d],
                        None if local_models is None else local_models[i][d],
                        sp.out_mean[d], sp.out_std[d],
                        scatter=CoreScatter(grids[0], self.store[i][d],
                                            self.q_block, self.p_block),
                        parts=parts)
            out.append(grids)
        return Sharded(out)

    def sector_fields(self, grids: Sharded) -> tuple:
        """(atmo, logp, precip): Sharded views of the fields of
        assemble's sector grids."""
        views = [split_grid(g[0], NVAR, self.nz, self.nlat, self.W)
                 for g in grids]
        return tuple(Sharded(v[k] for v in views) for k in range(3))

    def gather(self, grids: Sharded, device) -> torch.Tensor:
        """assemble's sector grids joined into the global flat grids on
        `device` (shard 0's, the GCM's): (P, global size), each row
        [atmo (4, K, lat, lon), logp, precip], one copy launch."""
        planes = (NVAR * self.nz + 2)
        P = grids[0].shape[0]
        parts = [self._move(g, d, 0).view(P, planes, self.nlat, self.W)
                 for d, g in enumerate(grids)]
        return torch.cat(parts, dim=-1).view(P, -1)

    def lon_sectors(self, *fields: torch.Tensor) -> Sharded:
        """Global (lat, lon) fields on shard 0's device, or (..., lat, lon)
        stacks of them, as each device's sector: (P, lat, W), the fields'
        planes stacked, one copy a device."""
        planes = [f.reshape(-1, self.nlat, f.shape[-1]) for f in fields]
        W = self.W
        return Sharded(
            self._move(torch.cat([p[..., d * W:(d + 1) * W] for p in planes]),
                       0, d) for d in range(self.D))

    # -- feedback + local model -------------------------------------------
    def feedback(self, spacks, atmo, logp, precip, sst, tisr) -> list:
        """build_feedback over the haloed lon sectors (K3 on every
        device): the fields (Sharded sectors each: atmo (4, K, lat, W),
        the others (lat, W)) stacked into one source a device, its
        `overlap` edge columns moved around the ring, and each pack's
        windows gathered and standardized with the device's rows of its
        input statistics.  tisr: the TISR plane's sectors, or a
        TisrDate or TisrRow a shard (tisr_dates, tisr_rows), which K3
        reads in place of a plane (the TISR is zonally uniform, so the
        haloed sector's is the sector's).  Returns a Sharded (Rloc, I) per
        pack."""
        K4 = NVAR * self.nz
        planes = not isinstance(tisr[0], (TisrDate, TisrRow))
        src = [torch.cat([a.reshape(K4, self.nlat, self.W), lp[None],
                          pr[None], s[None]] + ([t[None]] if planes else []))
               for a, lp, pr, s, t in zip(atmo, logp, precip, sst, tisr)]
        outs = []
        for d, h in enumerate(self._halo(src)):
            fields = (h[:K4].view(NVAR, self.nz, *h.shape[1:]), h[K4],
                      h[K4 + 1], h[K4 + 2], h[K4 + 3] if planes else tisr[d])
            outs.append(window_gather(
                fields, [t[d] for t in self.feedback_index],
                [sp.in_mean[d] for sp in spacks],
                [sp.in_std[d] for sp in spacks]))
        return [Sharded(o[i] for o in outs) for i in range(len(spacks))]

    def tisr_dates(self, tyear, slat: Sharded, clat: Sharded,
                   dev=None) -> list:
        """The TISR date as each shard's K3 takes it (TisrDate: the
        latitudes' sines and cosines on its device; dev, the date's slice
        of the cycle's row of scalars, copied there on the device, never
        read on the host)."""
        devs = [None] * self.D if dev is None else self.broadcast(dev)
        return [TisrDate(tyear, s, c, r) for s, c, r in zip(slat, clat, devs)]

    def tisr_rows(self, table: torch.Tensor, row: torch.Tensor) -> list:
        """A TISR table's row as each shard's K3 reads it (TisrRow): the
        table's haloed lon sectors (n, lat, W + 2 overlap) on the shard's
        device, made once a table, and the row's index copied there."""
        key = (table.data_ptr(), tuple(table.shape), table.dtype)
        if self._tisr_tables is None or self._tisr_tables[0] != key:
            o, W, nlon = self.layout.overlap, self.W, table.shape[-1]
            tabs = []
            for d, dev in enumerate(self.mesh.devices):
                cols = torch.arange(d * W - o, (d + 1) * W + o) % nlon
                tabs.append(table[..., cols.to(table.device)]
                            .to(dev).contiguous())
            self._tisr_tables = (key, tabs)
        return [TisrRow(t, r) for t, r in zip(self._tisr_tables[1],
                                               self.broadcast(row))]

    # -- the slab ocean ---------------------------------------------------
    def shard_ocean_packs(self, opacks) -> list:
        """Each ocean pack's parameters on the mesh (a Sharded of
        OceanPacks, one a shard): the reservoirs (shard_reservoir),
        mean_sst and std_sst (Rc, 1) by rows.  An ocean class is its
        atmosphere class, so shard d holds the same regions in both."""
        out = []
        for op in opacks:
            res = shard_reservoir(op.res, self.mesh)
            ms, ss = (shard_rows(t, self.mesh)
                      for t in (op.mean_sst, op.std_sst))
            out.append(Sharded(op._replace(res=r, mean_sst=m, std_sst=v)
                               for r, m, v in zip(res, ms, ss)))
        return out

    def local_model(self, spacks, fc) -> list:
        """build_local_model on every device (K3 with the core-only
        tables: cores never cross their sector, so no halo): fc the
        window's sectors (4K + 1, lat, W) = [atmo; logp] (lon_sectors of
        the forecast's atmo and logp).  Returns a Sharded (Rloc, S) per
        pack."""
        K4 = NVAR * self.nz
        outs = []
        for d, f in enumerate(fc):
            fields = (f[:K4].view(NVAR, self.nz, self.nlat, self.W),) \
                + (f[K4],) * 4
            outs.append(window_gather(
                fields, [t[d] for t in self.local_index],
                [sp.lm_mean[d] for sp in spacks],
                [sp.lm_std[d] for sp in spacks]))
        return [Sharded(o[i] for o in outs) for i in range(len(spacks))]

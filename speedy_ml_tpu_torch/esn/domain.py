"""Region tiling, halo windows, and state-vector packing.

Reference: res_domain.f90.  The globe is split into n_regions rectangles
(T30 production: 1152 regions of 2x2 grid points, res_domain.f90:258-292);
each region's ESN input is its core patch plus an overlap halo, periodic
in longitude and clipped at the poles (getoverlapindices,
res_domain.f90:155-204).

Regions are grouped into CLASSES by their input-patch height (pole rows
are clipped, so polar regions have a smaller input vector and hence a
different reservoir size).  Within a class every gather and scatter is
one lookup through a precomputed int32 index table, built once in numpy
from the class's ix/iy tables; the window-gather and core-scatter kernels
(kernels/window_gather.py, kernels/core_scatter.py) read the same tables.

Vector packing order matches the reference exactly
(tile_full_input_to_target_data*, res_domain.f90:602-740): the atmo block
is Fortran column-major over (var, x, y, z) — i.e. var fastest, then lon,
lat, level — followed by flat (x, y) blocks for logp, precip, sst, tisr.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from speedy_ml_tpu_torch.core.geometry import Geometry

# 2-D fields in the order of the packed vector and of the flat source
# buffer the window-gather kernel reads: [atmo, logp, precip, sst, tisr]
FIELDS_2D = ("logp", "precip", "sst", "tisr")


@dataclasses.dataclass(frozen=True)
class RegionClass:
    """A group of regions sharing identical patch geometry (static)."""
    name: str
    region_ids: np.ndarray       # (Rc,) global region numbers
    ix_core: np.ndarray          # (Rc, xc) global lon indices of the core
    iy_core: np.ndarray          # (Rc, yc) global lat indices
    ix_in: np.ndarray            # (Rc, xi) lon indices of the input window
    iy_in: np.ndarray            # (Rc, yi) lat indices
    core_in_input_x: np.ndarray  # (xc,) position of core cols inside window
    core_in_input_y: np.ndarray  # (yc,)

    @property
    def count(self):
        return len(self.region_ids)

    @property
    def core_shape(self):
        return self.ix_core.shape[1], self.iy_core.shape[1]

    @property
    def input_shape(self):
        return self.ix_in.shape[1], self.iy_in.shape[1]


class VertSpec(NamedTuple):
    """Vertical localization group (getoverlapindices_vert,
    res_domain.f90:206-256): a reservoir owns core sigma levels
    [z0, z1) and sees input levels [zi0, zi1) (core + clipped overlap).
    Only the BOTTOM group carries the 2-D surface blocks; every group
    sees TISR."""
    z0: int
    z1: int
    zi0: int
    zi1: int
    top: bool
    bottom: bool

    @property
    def nz_core(self):
        return self.z1 - self.z0

    @property
    def nz_in(self):
        return self.zi1 - self.zi0

    @property
    def z_off(self):
        """Core offset inside the input window."""
        return self.z0 - self.zi0


def vert_specs(nz: int, num_vert_levels: int, vert_overlap: int
               ) -> list[VertSpec]:
    """All vertical groups (get_z_res_extent + getoverlapindices_vert,
    res_domain.f90:143-256), 0-based half-open ranges."""
    if nz % num_vert_levels:
        raise ValueError(f"nz={nz} not divisible by {num_vert_levels}")
    zchunk = nz // num_vert_levels
    out = []
    for g in range(num_vert_levels):
        z0, z1 = g * zchunk, (g + 1) * zchunk
        zi0 = max(z0 - vert_overlap, 0)
        zi1 = min(z1 + vert_overlap, nz)
        out.append(VertSpec(z0=z0, z1=z1, zi0=zi0, zi1=zi1,
                            top=(z0 == 0), bottom=(z1 == nz)))
    return out


FULL_COLUMN = None   # sentinel: single group spanning all levels (bottom)


def full_column_spec(nz: int) -> VertSpec:
    return VertSpec(z0=0, z1=nz, zi0=0, zi1=nz, top=True, bottom=True)


def band(zspec, nz: int, core: bool) -> tuple:
    """The atmo levels (lo, hi) of a vertical group's vectors: the core
    [z0, z1) for its outputs and local model, the input window [zi0, zi1)
    for its feedback; the full column for zspec None."""
    if zspec is None:
        return 0, nz
    return (zspec.z0, zspec.z1) if core else (zspec.zi0, zspec.zi1)


def is_bottom(zspec) -> bool:
    """Whether a group carries the 2-D surface blocks (logp, precip, sst)."""
    return zspec is None or zspec.bottom


class VectorLayout(NamedTuple):
    """Slice offsets of each block inside the packed vector."""
    atmo: tuple        # (start, end)
    logp: Optional[tuple]
    precip: Optional[tuple]
    sst: Optional[tuple]
    tisr: Optional[tuple]
    total: int


def build_layout(nx: int, ny: int, nvar: int, nz: int, *, logp: bool,
                 precip: bool, sst: bool, tisr: bool) -> VectorLayout:
    pos = nvar * nx * ny * nz
    atmo = (0, pos)
    sl = {}
    for name, active in zip(FIELDS_2D, (logp, precip, sst, tisr)):
        if active:
            sl[name] = (pos, pos + nx * ny)
            pos += nx * ny
        else:
            sl[name] = None
    return VectorLayout(atmo=atmo, logp=sl["logp"], precip=sl["precip"],
                        sst=sl["sst"], tisr=sl["tisr"], total=pos)


class RegionLayout:
    """Static tiling of the Gaussian grid into ESN regions."""

    def __init__(self, geom: Geometry = Geometry(), n_regions: int = 1152,
                 overlap: int = 1):
        self.geom = geom
        self.n_regions = n_regions
        self.overlap = overlap

        nlon, nlat = geom.nlon, geom.nlat
        # factorization (domaindecomposition, res_domain.f90:258-280)
        n = (nlon * nlat) // n_regions
        fy = 0
        for i in range(int(np.sqrt(n)), 0, -1):
            if nlat % i == 0 and n % i == 0 and nlon % (n // i) == 0:
                fy = i
                break
        self.xc = n // fy         # core width  (lon)
        self.yc = fy              # core height (lat)
        self.nx_blocks = nlon // self.xc
        self.ny_blocks = nlat // self.yc

        # region r -> lower-left corner (getworkerlower_leftcorner):
        # col = r % ny_blocks indexes latitude blocks, row = r // ny_blocks
        r = np.arange(n_regions)
        self.block_x = r // self.ny_blocks
        self.block_y = r % self.ny_blocks
        self.x0 = self.block_x * self.xc      # 0-based core start lon
        self.y0 = self.block_y * self.yc

        lat_deg = np.rad2deg(geom.lat_radians)
        self.lat_start = lat_deg[self.y0]
        self.lat_end = lat_deg[self.y0 + self.yc - 1]

        self._build_classes()

    def _build_classes(self):
        o = self.overlap
        nlon, nlat = self.geom.nlon, self.geom.nlat
        groups: dict[tuple, list[int]] = {}
        for r in range(self.n_regions):
            ys = max(self.y0[r] - o, 0)
            ye = min(self.y0[r] + self.yc - 1 + o, nlat - 1)
            key = (ys - self.y0[r], ye - (self.y0[r] + self.yc - 1))
            groups.setdefault(key, []).append(r)

        self.classes: list[RegionClass] = []
        for (off_lo, off_hi), ids in sorted(groups.items()):
            ids = np.asarray(ids)
            xi = self.xc + 2 * o
            ix_core = (self.x0[ids, None] + np.arange(self.xc)[None, :]) % nlon
            iy_core = self.y0[ids, None] + np.arange(self.yc)[None, :]
            ix_in = (self.x0[ids, None] - o + np.arange(xi)[None, :]) % nlon
            # off_lo = (clipped window start) - y0 in [-o, 0];
            # off_hi = (clipped window end) - (y0 + yc - 1) in [0, o]
            start = self.y0[ids] + off_lo
            end = self.y0[ids] + self.yc - 1 + off_hi
            ylen = int(end[0] - start[0] + 1)
            iy_in = start[:, None] + np.arange(ylen)[None, :]
            name = f"y{off_lo}_{off_hi}"
            self.classes.append(RegionClass(
                name=name, region_ids=ids,
                ix_core=ix_core.astype(np.int32),
                iy_core=iy_core.astype(np.int32),
                ix_in=ix_in.astype(np.int32), iy_in=iy_in.astype(np.int32),
                core_in_input_x=np.arange(o, o + self.xc, dtype=np.int32),
                core_in_input_y=np.arange(-off_lo, -off_lo + self.yc,
                                          dtype=np.int32)))

    # ------------------------------------------------------------------
    # index tables (numpy, built once per class)
    # ------------------------------------------------------------------

    def window_index(self, cls: RegionClass, core_only: bool = False,
                     ncols: int | None = None) -> np.ndarray:
        """(Rc, yi, xi) int32 flat (lat * ncols + lon) index of every
        window element; core_only gives the (Rc, yc, xc) core.  ncols: the
        longitudes of the grid the index addresses (default nlon; a lon
        sector's, hybrid/sharded.py, whose class tables are local)."""
        iy = cls.iy_core if core_only else cls.iy_in
        ix = cls.ix_core if core_only else cls.ix_in
        nlon = self.geom.nlon if ncols is None else ncols
        if ix.size and not 0 <= ix.min() <= ix.max() < nlon:
            raise ValueError(f"window_index: class {cls.name} leaves the "
                             f"grid's {nlon} longitudes")
        return (iy[:, :, None] * nlon + ix[:, None, :]).astype(np.int32)

    def pack_table(self, cls: RegionClass, nvar: int, nz: int, *,
                   logp: bool, precip: bool, sst: bool, tisr: bool,
                   core_only: bool = False, levels=None,
                   ncols: int | None = None) -> np.ndarray:
        """(Rc, total) int32 source index of every packed-vector element.

        Indices point into the flat buffer [atmo (nvar, nz, lat, lon),
        logp, precip, sst, tisr (lat, lon) each]: the 2-D slots are fixed
        whether or not a block is packed.  The order is pack_vector's
        (reference order, domain.py:252-269 of the JAX package) applied
        to the atmo levels [lo, hi) = levels (default all nz): a vertical
        group's band (band()).  ncols: as in window_index, the fields then
        (lat, ncols) each."""
        nlat = self.geom.nlat
        nlon = self.geom.nlon if ncols is None else ncols
        G = nlat * nlon
        lo, hi = (0, nz) if levels is None else levels
        if not 0 <= lo < hi <= nz:
            raise ValueError(f"pack_table: levels {levels} outside [0, {nz})")
        w = self.window_index(cls, core_only,
                              nlon).astype(np.int64)   # (Rc, y, x)
        Rc, ny, nx = w.shape
        # atmo: C-flatten (Rc, z, y, x, v) of (v * nz + z) * G + w
        v = np.arange(nvar)[None, None, None, None, :]
        z = np.arange(lo, hi)[None, :, None, None, None]
        atmo = (v * nz + z) * G + w[:, None, :, :, None]
        parts = [atmo.reshape(Rc, -1)]
        base = nvar * nz * G
        for k, active in enumerate((logp, precip, sst, tisr)):
            if active:
                parts.append((base + k * G + w).reshape(Rc, -1))
        out = np.concatenate(parts, axis=1)
        if out.max() >= 2 ** 31:
            raise ValueError("pack_table: source index exceeds int32")
        return out.astype(np.int32)

    def core_table(self, cls: RegionClass, nvar: int, nz: int,
                   zspec=None, ncols: int | None = None) -> np.ndarray:
        """(Rc, O) int32: the flat-output element [atmo (nvar, nz, lat,
        lon), logp, precip] of each output of a pack of class cls and
        vertical group zspec: its core band's atmo, and logp and precip if
        it is a bottom group (None: the full column).  ncols: as in
        window_index."""
        b = is_bottom(zspec)
        return self.pack_table(cls, nvar, nz, logp=b, precip=b, sst=False,
                               tisr=False, core_only=True,
                               levels=band(zspec, nz, core=True),
                               ncols=ncols)

    def core_source_table(self, classes, nvar: int, nz: int,
                          zspecs=None) -> np.ndarray:
        """Inverse of the core packing over all `classes` (in order; with
        zspecs, each entry's vertical group, the packs of a localized
        hybrid).

        Returns (nvar*nz*G + 2*G,) int32: for every element of the flat
        output [atmo (nvar, nz, lat, lon), logp, precip], the offset of its
        value in the concatenation of the classes' flattened (Rc, O)
        output vectors (O = nvar*nz*yc*xc + 2*yc*xc: atmo, logp, precip,
        for the full column).  The cores must tile the grid exactly
        once."""
        G = self.geom.nlat * self.geom.nlon
        A = nvar * nz * G
        table = np.full(A + 2 * G, -1, dtype=np.int64)
        start = 0
        zspecs = [None] * len(classes) if zspecs is None else list(zspecs)
        for cls, zs in zip(classes, zspecs):
            # the packed core vector's source index IS the inverse map:
            # element j of region r came from grid element src[r, j]
            src = self.core_table(cls, nvar, nz, zs)
            Rc, O = src.shape
            off = start + np.arange(Rc * O).reshape(Rc, O)
            if np.any(table[src] >= 0):
                raise ValueError(f"core_source_table: class {cls.name} "
                                 "overlaps an earlier core")
            table[src] = off
            start += Rc * O
        if np.any(table < 0):
            raise ValueError("core_source_table: the cores do not cover "
                             "the grid")
        if start >= 2 ** 31:
            raise ValueError("core_source_table: offset exceeds int32")
        return table.astype(np.int32)

    def core_output_index(self, classes, nvar: int, nz: int,
                          zspecs=None) -> list:
        """The inverse of core_source_table, per class of `classes` (with
        zspecs, each entry's vertical group): an (Rc, O) int32 array, the
        element of the flat output [atmo (nvar, nz, lat, lon), logp,
        precip] that output o of region r fills (where the readout stores
        it, kernels/core_scatter.py).  The cores must tile the grid
        exactly once."""
        G = self.geom.nlat * self.geom.nlon
        total = nvar * nz * G + 2 * G
        zspecs = [None] * len(classes) if zspecs is None else list(zspecs)
        idx = [self.core_table(cls, nvar, nz, zs)
               for cls, zs in zip(classes, zspecs)]
        count = np.bincount(np.concatenate([i.ravel() for i in idx]),
                            minlength=total)
        if count.size != total or np.any(count != 1):
            raise ValueError("core_output_index: the cores do not tile the "
                             "grid exactly once")
        return idx

    # ------------------------------------------------------------------
    # gathers and scatters (all batched over a class)
    # ------------------------------------------------------------------

    @staticmethod
    def gather_patches(field: torch.Tensor, iy: np.ndarray, ix: np.ndarray
                       ) -> torch.Tensor:
        """field (..., lat, lon) -> (Rc, ..., yi, xi) patches by advanced
        indexing (the oracle of the index tables)."""
        iyj = torch.as_tensor(iy, dtype=torch.long, device=field.device)
        ixj = torch.as_tensor(ix, dtype=torch.long, device=field.device)
        patches = field[..., iyj[:, :, None], ixj[:, None, :]]
        return torch.movedim(patches, -3, 0)

    def class_patches(self, cls: RegionClass, field: torch.Tensor,
                      core_only: bool = False) -> torch.Tensor:
        """Windowed patches (Rc, ..., yi, xi) by one lookup through the
        class's window index table."""
        w = torch.as_tensor(self.window_index(cls, core_only),
                            dtype=torch.long, device=field.device)
        flat = field.reshape(field.shape[:-2] + (-1,))
        p = flat[..., w]                          # (..., Rc, yi, xi)
        return torch.movedim(p, -3, 0)

    def pack_vector(self, cls: RegionClass, atmo: torch.Tensor,
                    logp=None, precip=None, sst=None, tisr=None,
                    core_only: bool = False) -> torch.Tensor:
        """Pack fields into per-region vectors in reference order.

        atmo: (V, K, lat, lon); 2-D fields (lat, lon).
        Returns (Rc, total). core_only packs the target/output layout."""
        parts = []
        ap = self.class_patches(cls, atmo, core_only)   # (Rc, V, K, y, x)
        # Fortran order: var fastest, then x, then y, then z ->
        # transpose to (Rc, z, y, x, v) and C-flatten
        parts.append(ap.permute(0, 2, 3, 4, 1).reshape(ap.shape[0], -1))
        for f in (logp, precip, sst, tisr):
            if f is not None:
                p = self.class_patches(cls, f, core_only)   # (Rc, y, x)
                # Fortran (x, y) column-major = x fastest -> C-flatten (y, x)
                parts.append(p.reshape(p.shape[0], -1))
        return torch.cat(parts, dim=1)

    def unpack_core_vector(self, cls: RegionClass, vec: torch.Tensor,
                           nvar: int, nz: int, *, logp: bool, precip: bool
                           ) -> dict:
        """Inverse of pack_vector(core_only=True): (Rc, O) -> field patches."""
        xc, yc = cls.core_shape
        lay = build_layout(xc, yc, nvar, nz, logp=logp, precip=precip,
                           sst=False, tisr=False)
        out = {}
        a0, a1 = lay.atmo
        atmo = vec[:, a0:a1].reshape(-1, nz, yc, xc, nvar)
        out["atmo"] = atmo.permute(0, 4, 1, 2, 3)   # (Rc, V, K, y, x)
        if logp:
            l0, l1 = lay.logp
            out["logp"] = vec[:, l0:l1].reshape(-1, yc, xc)
        if precip:
            p0, p1 = lay.precip
            out["precip"] = vec[:, p0:p1].reshape(-1, yc, xc)
        return out

    def scatter_core(self, cls: RegionClass, patches: torch.Tensor,
                     field: torch.Tensor) -> torch.Tensor:
        """Write core patches (Rc, ..., yc, xc) into a copy of the global
        field (..., lat, lon) through the class's core index table."""
        w = torch.as_tensor(self.window_index(cls, core_only=True),
                            dtype=torch.long, device=field.device)
        out = field.clone()
        flat = out.view(field.shape[:-2] + (-1,))
        # (Rc, ..., yc, xc) -> (..., Rc, yc, xc) to line up with w
        flat[..., w] = torch.movedim(patches, 0, -3).to(field.dtype)
        return out

    def input_to_target(self, cls: RegionClass, vec: torch.Tensor,
                        nvar: int, nz_in: int, nz_core: int, z_off: int, *,
                        logp: bool, precip: bool, sst: bool, tisr: bool
                        ) -> torch.Tensor:
        """Extract the core/target sub-vector from a packed input vector
        (tile_full_input_to_target_data, res_domain.f90:602-651)."""
        xi, yi = cls.input_shape
        lay = build_layout(xi, yi, nvar, nz_in, logp=logp, precip=precip,
                           sst=sst, tisr=tisr)
        Rc = vec.shape[0]
        cx = torch.as_tensor(cls.core_in_input_x, dtype=torch.long,
                             device=vec.device)
        cy = torch.as_tensor(cls.core_in_input_y, dtype=torch.long,
                             device=vec.device)
        a0, a1 = lay.atmo
        atmo = vec[:, a0:a1].reshape(Rc, nz_in, yi, xi, nvar)
        core = atmo[:, z_off:z_off + nz_core][:, :, cy][:, :, :, cx]
        parts = [core.reshape(Rc, -1)]
        for name in ("logp", "precip"):
            sl = getattr(lay, name)
            if sl is not None:
                f = vec[:, sl[0]:sl[1]].reshape(Rc, yi, xi)
                parts.append(f[:, cy][:, :, cx].reshape(Rc, -1))
        return torch.cat(parts, dim=1)

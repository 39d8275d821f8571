"""The core scatter: every region's output vector into the global grids,
with the physical clamps (the JAX package's esn/domain.py:271,290
unpack_core_vector + scatter_core and the clamps of
HybridAtmosphere.assemble_global, hybrid/model.py:373-402).

On the card the scatter is K2's store (kernels/readout.py `readout` with a
CoreScatter, csrc/readout.cuh RoScatter): each output goes from the
readout's warp straight to its element of the flat grid
[atmo (V, K, lat, lon), logp, precip], through the inverse table
RegionLayout.core_output_index, with q = max(q, 1e-6) and precip < 1e-5
-> 0 picked by the element's block.  K4, a launch of its own that read
the readout's vectors back, is folded into K2.  This module
holds the grid's layout, `scatter_plain` (the plain version of that
store, which K2's CPU route runs) and `core_scatter_plain`, the gather
through RegionLayout.core_source_table from all classes' vectors, the
reference both are held to.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Q_MIN = 1e-6        # the humidity clamp: q = max(q, Q_MIN)
PRECIP_MIN = 1e-5   # the precip clamp: precip < PRECIP_MIN -> 0


class CoreScatter(NamedTuple):
    """Where the readout stores its outputs: grid, the flat (total,) grid
    [atmo (V, K, lat, lon), logp, precip]; index, the class's (R, O) int32
    element of each output (-1: none); q and p, the humidity and precip
    blocks of grid, (start, end) each (grid_blocks)."""
    grid: torch.Tensor
    index: torch.Tensor
    q: tuple
    p: tuple


def grid_blocks(nvar: int, nz: int, nlat: int, nlon: int):
    """(total elements, humidity block, precip block) of the flat grid."""
    if nvar < 4:
        raise ValueError("core scatter: humidity is variable 3")
    G = nlat * nlon
    q0 = 3 * nz * G
    p0 = nvar * nz * G + G
    return nvar * nz * G + 2 * G, (q0, q0 + nz * G), (p0, p0 + G)


def split_grid(flat: torch.Tensor, nvar: int, nz: int, nlat: int,
               nlon: int):
    """(atmo (nvar, nz, lat, lon), logp, precip): views of the flat grid."""
    G = nlat * nlon
    A = nvar * nz * G
    return (flat[:A].view(nvar, nz, nlat, nlon),
            flat[A:A + G].view(nlat, nlon), flat[A + G:].view(nlat, nlon))


def scatter_plain(out: torch.Tensor, sc: CoreScatter):
    """The plain version of K2's store into the grid: out (R, O) to
    sc.grid at sc.index, clamped by block (the comparisons keep NaN)."""
    e = sc.index.reshape(-1).long()
    v = out.reshape(-1)
    keep = e >= 0
    e, v = e[keep], v[keep]
    q = (e >= sc.q[0]) & (e < sc.q[1])
    p = (e >= sc.p[0]) & (e < sc.p[1])
    v = torch.where(q, torch.clamp_min(v, Q_MIN), v)
    v = torch.where(p & (v < PRECIP_MIN), torch.zeros_like(v), v)
    sc.grid[e] = v


def core_scatter_plain(vecs, table, nvar: int, nz: int, nlat: int,
                       nlon: int):
    """The reference: (atmo, logp, precip) gathered through `table`
    (RegionLayout.core_source_table) from the concatenation of every
    class's flattened (Rc, O) output vectors, then clamped."""
    src = torch.cat([v.reshape(-1) for v in vecs])
    atmo, logp, precip = split_grid(src[table.long()], nvar, nz, nlat, nlon)
    atmo = atmo.clone()
    atmo[3] = torch.clamp_min(atmo[3], Q_MIN)                 # q clamp
    precip = torch.where(precip < PRECIP_MIN, torch.zeros_like(precip),
                         precip)
    return atmo, logp, precip

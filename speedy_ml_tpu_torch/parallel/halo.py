"""Halo exchange between latitude bands over the device mesh.

The reference materializes halos through the rank-0 hub: root assembles
the full grid and re-tiles per-region windows (sendrecievegrid,
mpires.f90:218-780).  This module is the peer-to-peer path of the JAX
package's parallel/halo.py: the (lat, lon) grid lives LAT-SHARDED across
the devices (device d owns rows [d*nlat/D, (d+1)*nlat/D)), and only the
`overlap` edge rows move between lat-neighbour devices, O(overlap * nlon)
bytes per device instead of O(nlat * nlon).  Pole edges do not wrap
(windows are clipped at the poles, res_domain.f90:155-204): the halo rows
past a pole are zero, so any use of them is loud.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.parallel.mesh import Mesh, Sharded, shard_rows


def lat_shards(field: torch.Tensor, mesh: Mesh) -> Sharded:
    """field (..., lat, lon) split into mesh.size latitude bands, band d
    on device d (lat % D == 0)."""
    return shard_rows(field, mesh, dim=field.dim() - 2)


def halo_exchange_lat(shards, overlap: int, mesh: Mesh) -> Sharded:
    """Each device's haloed band [south halo | band | north halo]
    (..., band + 2*overlap, lon), from lat_shards' bands: the south halo is
    the southern neighbour's top `overlap` rows, the north halo the
    northern neighbour's bottom rows, each moved to the receiving device.
    The south halo of the southernmost band and the north halo of the
    northernmost are zero (pole clipping; the JAX package's ring masks
    its wrapped rows)."""
    D = mesh.size
    if len(shards) != D:
        raise ValueError(f"halo_exchange_lat: {len(shards)} bands for a "
                         f"mesh of {D}")
    if not 0 < overlap <= shards[0].shape[-2]:
        raise ValueError(f"halo_exchange_lat: overlap {overlap} outside "
                         f"[1, {shards[0].shape[-2]}]")
    out = []
    for d, (f, dev) in enumerate(zip(shards, mesh.devices)):
        edge = f[..., :overlap, :]
        south = (torch.zeros_like(edge) if d == 0 else
                 shards[d - 1][..., -overlap:, :].to(dev, non_blocking=True))
        north = (torch.zeros_like(edge) if d == D - 1 else
                 shards[d + 1][..., :overlap, :].to(dev, non_blocking=True))
        out.append(torch.cat([south, f, north], dim=-2))
    return Sharded(out)


def haloed_band(haloed: torch.Tensor, d: int, band: int, overlap: int
                ) -> torch.Tensor:
    """Slice device d's haloed band out of the haloed bands stacked along
    lat (..., D*(band + 2*overlap), lon), the JAX package's layout."""
    w = band + 2 * overlap
    return haloed[..., d * w:(d + 1) * w, :]

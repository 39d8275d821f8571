"""K25: random diabatic forcing, xs_rdf and setrdf in one launch a physics
step (csrc/rdf.cu), and its plain version.

The JAX package (physics/driver.py:277-288, physics/randfor.py:83-110),
with randfh set: on a shortwave step the vertical modulation randfv (2,
nlat, K) becomes [xs_rdf(tt_lsc, tt_cnv, sig, 0), xs_rdf(tt_rsw, tt_rlw,
sig, 1)], the zonal means of the two heating pairs weighted per level,
smoothed twice in latitude; every step setrdf(randfh, randfv) is added to
the temperature tendency.  The port's column kernels hand the step's
inputs out as they are: K9's ttend is tt_cnv + tt_lsc (the same sum:
addition commutes), the new carry's tt_rsw, and tt_rlw is formed here from
K10b's dfabs, K9's rps and grdscp as K12 forms it, (dfabs * rps) *
grdscp.  No column kernel changes.

`rdf(tt, randfh, randfv, xs=None)`: tt the step's temperature tendency
(K, lat, lon), written in place on the card; randfv the carried (2, nlat,
K); xs None, or on a shortwave step an RdfHeating.  Returns (tt, randfv'),
randfv' a new tensor on a shortwave step, the carried one otherwise.

On a mesh (GCM.set_mesh: a shard holds the latitude band (p0, p1),
parallel/mesh.py band_rows) the kernel runs in two forms around an
all-gather of the bands' sums, so that each sum keeps the whole kernel's
order:
  - `rdf_sums(xs)` (a shortwave step): the band's weighted zonal sums of
    both heating pairs, (2, K, rows);
  - `rdf_band(tt, randfh, randfv, band, sums=None)`: tt and randfh the
    band's rows, randfv (2, nlat, K) whole (every shard keeps it whole);
    with sums, every band's gathered in latitude order (2, K, nlat), the
    two smoothings and the new randfv' (2, nlat, K), whole; the forcing
    added at the band's rows.  Returns (tt, randfv').
The whole kernel is rdf_sums and rdf_band on the one band (0, nlat / 2)
(`rdf_plain` is written so).

On a CPU tensor each form runs its plain version (`rdf_plain`,
`rdf_sums_plain`, `rdf_band_plain`), whose zonal sums go one longitude
after another (the kernel's order); on a CUDA tensor it launches the
kernel (float32 or float64) or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from speedy_ml_tpu_torch.kernels import build as kb


class RdfHeating(NamedTuple):
    """The heating of a shortwave step that xs_rdf reads."""
    ttm: torch.Tensor      # (K, lat, lon) tt_cnv + tt_lsc (K9's ttend)
    tt_rsw: torch.Tensor   # (K, lat, lon) the new carry's shortwave heating
    dfabs: torch.Tensor    # (K, lat, lon) K10b's longwave flux absorption
    rps: torch.Tensor      # (lat, lon) 1 / psg
    grdscp: torch.Tensor   # (K,)
    w: torch.Tensor        # (2, K) randfor.rdf_weights


def _zonal_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, one element after another from index 0."""
    s = a[..., 0]
    for i in range(1, a.shape[-1]):
        s = s + a[..., i]
    return s


def smooth_lat(v: torch.Tensor) -> torch.Tensor:
    """Two passes of 1/2-1/4-1/4 smoothing over the latitude axis 0 with
    mirrored ends (rand1(0)=rand1(2), rand1(nlat+1)=rand1(nlat-1))."""
    for _ in range(2):
        up = torch.cat([v[1:2], v[:-1]], dim=0)
        dn = torch.cat([v[1:], v[-2:-1]], dim=0)
        v = 0.5 * v + 0.25 * (up + dn)
    return v


def rdf_sums_plain(xs: RdfHeating) -> torch.Tensor:
    """The band's weighted zonal sums (2, K, rows) of a shortwave step."""
    rlw = xs.dfabs * xs.rps[None] * xs.grdscp[:, None, None]
    v0 = _zonal_sum(xs.ttm) * xs.w[0][:, None]           # (K, rows)
    v1 = _zonal_sum(xs.tt_rsw + rlw) * xs.w[1][:, None]
    return torch.stack([v0, v1])


def rdf_band_plain(tt: torch.Tensor, randfh: torch.Tensor,
                   randfv: torch.Tensor, band,
                   sums: Optional[torch.Tensor] = None):
    """The band form's plain version: (tt + setrdf(randfh, randfv' at the
    band's rows), randfv'), randfv' whole."""
    from speedy_ml_tpu_torch.parallel.mesh import band_rows
    nlat = randfv.shape[1]
    if sums is not None:
        # (2, nlat, K)
        randfv = torch.stack([smooth_lat(sums[0].T), smooth_lat(sums[1].T)])
    v = band_rows(randfv, band, nlat, dim=1).permute(0, 2, 1)[..., None]
    add = randfh[0][None] * v[0] + randfh[1][None] * v[1]
    return tt + add, randfv


def rdf_plain(tt: torch.Tensor, randfh: torch.Tensor, randfv: torch.Tensor,
              xs: Optional[RdfHeating] = None):
    """The plain PyTorch version: (tt + setrdf(randfh, randfv'), randfv')."""
    return rdf_band_plain(tt, randfh, randfv, (0, tt.shape[1] // 2),
                          None if xs is None else rdf_sums_plain(xs))


def _check_heating(xs: RdfHeating, K: int, rows: int, nlon: int, dt, dev):
    for name, shape in (("ttm", (K, rows, nlon)),
                        ("tt_rsw", (K, rows, nlon)),
                        ("dfabs", (K, rows, nlon)), ("rps", (rows, nlon)),
                        ("grdscp", (K,)), ("w", (2, K))):
        kb.require(getattr(xs, name), f"xs.{name}", dt, shape, dev)


def _dtype(tt: torch.Tensor):
    dt = tt.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"rdf: dtype {dt}, the kernel takes float32 or "
                        "float64")
    return dt


def rdf(tt: torch.Tensor, randfh: torch.Tensor, randfv: torch.Tensor,
        xs: Optional[RdfHeating] = None):
    """See the module docstring."""
    dev = tt.device
    if dev.type == "cpu":
        return rdf_plain(tt, randfh, randfv, xs)
    if dev.type != "cuda":
        raise ValueError(f"rdf: no kernel for device {dev}")
    dt = _dtype(tt)
    K, nlat, nlon = tt.shape
    kb.require(tt, "tt", dt, (K, nlat, nlon), dev)
    kb.require(randfh, "randfh", dt, (2, nlat, nlon), dev)
    kb.require(randfv, "randfv", dt, (2, nlat, K), dev)
    ptrs = [0] * 6
    v_out = randfv
    if xs is not None:
        _check_heating(xs, K, nlat, nlon, dt, dev)
        ptrs = [t.data_ptr() for t in xs]
        v_out = torch.empty_like(randfv)
    code = kb.library().rdf_launch(
        kb.device_index(tt), int(dt == torch.float64), K, nlat, nlon,
        int(xs is not None), tt.data_ptr(), randfh.data_ptr(),
        randfv.data_ptr(), *ptrs,
        v_out.data_ptr() if xs is not None else 0, kb.stream_of(tt))
    kb.check(code, "rdf")
    rdf.launches += 1
    return tt, v_out


def rdf_sums(xs: RdfHeating) -> torch.Tensor:
    """The sums form (see the module docstring): (2, K, rows)."""
    dev = xs.ttm.device
    if dev.type == "cpu":
        return rdf_sums_plain(xs)
    if dev.type != "cuda":
        raise ValueError(f"rdf_sums: no kernel for device {dev}")
    dt = _dtype(xs.ttm)
    K, rows, nlon = xs.ttm.shape
    _check_heating(xs, K, rows, nlon, dt, dev)
    out = torch.empty((2, K, rows), dtype=dt, device=dev)
    code = kb.library().rdf_sums_launch(
        kb.device_index(xs.ttm), int(dt == torch.float64), K, rows, nlon,
        *[t.data_ptr() for t in xs], out.data_ptr(), kb.stream_of(xs.ttm))
    kb.check(code, "rdf_sums")
    rdf_sums.launches += 1
    return out


def rdf_band(tt: torch.Tensor, randfh: torch.Tensor, randfv: torch.Tensor,
             band, sums: Optional[torch.Tensor] = None):
    """The band form (see the module docstring): (tt, randfv')."""
    dev = tt.device
    if dev.type == "cpu":
        return rdf_band_plain(tt, randfh, randfv, band, sums)
    if dev.type != "cuda":
        raise ValueError(f"rdf_band: no kernel for device {dev}")
    dt = _dtype(tt)
    K, rows, nlon = tt.shape
    nlat = randfv.shape[1]
    p0, p1 = band
    if rows != 2 * (p1 - p0) or 2 * p1 > nlat:
        raise ValueError(f"rdf_band: {rows} rows for the band {band} of "
                         f"{nlat} latitudes")
    kb.require(tt, "tt", dt, (K, rows, nlon), dev)
    kb.require(randfh, "randfh", dt, (2, rows, nlon), dev)
    kb.require(randfv, "randfv", dt, (2, nlat, K), dev)
    v_out = randfv
    if sums is not None:
        kb.require(sums, "sums", dt, (2, K, nlat), dev)
        v_out = torch.empty_like(randfv)
    code = kb.library().rdf_band_launch(
        kb.device_index(tt), int(dt == torch.float64), K, nlat, nlon, p0,
        p1 - p0, int(sums is not None), tt.data_ptr(), randfh.data_ptr(),
        randfv.data_ptr(), 0 if sums is None else sums.data_ptr(),
        v_out.data_ptr() if sums is not None else 0, kb.stream_of(tt))
    kb.check(code, "rdf_band")
    rdf_band.launches += 1
    return tt, v_out


rdf.launches = 0
rdf_sums.launches = 0
rdf_band.launches = 0

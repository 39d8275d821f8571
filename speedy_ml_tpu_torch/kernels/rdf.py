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

On a CPU tensor `rdf` runs `rdf_plain`, whose zonal sums go one longitude
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


def rdf_plain(tt: torch.Tensor, randfh: torch.Tensor, randfv: torch.Tensor,
              xs: Optional[RdfHeating] = None):
    """The plain PyTorch version: (tt + setrdf(randfh, randfv'), randfv')."""
    if xs is not None:
        rlw = xs.dfabs * xs.rps[None] * xs.grdscp[:, None, None]
        v0 = _zonal_sum(xs.ttm) * xs.w[0][:, None]           # (K, nlat)
        v1 = _zonal_sum(xs.tt_rsw + rlw) * xs.w[1][:, None]
        # (2, nlat, K)
        randfv = torch.stack([smooth_lat(v0.T), smooth_lat(v1.T)])
    v = randfv.permute(0, 2, 1)[..., None]                    # (2, K, nlat, 1)
    add = randfh[0][None] * v[0] + randfh[1][None] * v[1]
    return tt + add, randfv


def rdf(tt: torch.Tensor, randfh: torch.Tensor, randfv: torch.Tensor,
        xs: Optional[RdfHeating] = None):
    """See the module docstring."""
    dev = tt.device
    if dev.type == "cpu":
        return rdf_plain(tt, randfh, randfv, xs)
    if dev.type != "cuda":
        raise ValueError(f"rdf: no kernel for device {dev}")
    dt = tt.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"rdf: dtype {dt}, the kernel takes float32 or "
                        "float64")
    K, nlat, nlon = tt.shape
    kb.require(tt, "tt", dt, (K, nlat, nlon), dev)
    kb.require(randfh, "randfh", dt, (2, nlat, nlon), dev)
    kb.require(randfv, "randfv", dt, (2, nlat, K), dev)
    ptrs = [0] * 6
    v_out = randfv
    if xs is not None:
        for name, shape in (("ttm", (K, nlat, nlon)),
                            ("tt_rsw", (K, nlat, nlon)),
                            ("dfabs", (K, nlat, nlon)), ("rps", (nlat, nlon)),
                            ("grdscp", (K,)), ("w", (2, K))):
            kb.require(getattr(xs, name), f"xs.{name}", dt, shape, dev)
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


rdf.launches = 0

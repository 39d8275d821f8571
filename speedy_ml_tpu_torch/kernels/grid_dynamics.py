"""K7: the grid-point dynamics kernel (csrc/grid_dynamics.cu) and its
plain version.

Input: the inverse-transformed dynamics stack gall (Bg, lat, lon) =
[vor, div, t, tracers (R*K) | u, v, dps/dx, dps/dy] with 1/cos already on
the last four groups (DycoreModel.dynamics_stack), and optionally the
physics tendencies (u, v, t (K, lat, lon), tr (R, K, lat, lon)).  Per
grid column: the vertical means, the sigma-dot cumulative sums, the
u/v/T/tracer tendencies of the JAX package's grid_tendencies
(dycore/model.py:258-350) plus the physics tendencies, and the products
that to_spectral_tendencies transforms.  Output, one stack for K5:
  [psfield (1); ke, ttend, trtend ((2+R)K);
   utend, -u*(T-tref), -u*tr ((2+R)K); vtend, -v*(T-tref), -v*tr ((2+R)K)]
with psfield = -umean*px - vmean*py.

Sums over levels run in level order, in both versions.  On a CPU tensor
`grid_dynamics` runs `grid_dynamics_plain`; on a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from speedy_ml_tpu_torch.kernels import build as kb

KERNEL_LEVELS = (5, 7, 8)   # K values compiled in csrc/grid_dynamics.cu


class ColumnTables(NamedTuple):
    coriol: torch.Tensor   # (lat,)
    dhs: torch.Tensor      # (K,)
    dhsr: torch.Tensor
    fsgr: torch.Tensor
    tref: torch.Tensor
    tref3: torch.Tensor
    rgas: float
    akap: float
    blob: torch.Tensor | None = None   # column_blob, built once




def column_blob(tabs: ColumnTables) -> torch.Tensor:
    """The float32 table buffer of the kernel: coriol, dhs, dhsr, fsgr,
    tref, tref3."""
    return torch.cat([tabs.coriol, tabs.dhs, tabs.dhsr, tabs.fsgr,
                      tabs.tref, tabs.tref3]).to(torch.float32).contiguous()


def _level_sum(a, w):
    """sum_k a[k] * w[k], accumulated in level order."""
    s = a[0] * w[0]
    for k in range(1, a.shape[0]):
        s = s + a[k] * w[k]
    return s


def _cumsum_levels(incr):
    """(K, ...) -> (K+1, ...) half-level partial sums, 0 on top."""
    out = [torch.zeros_like(incr[0])]
    for k in range(incr.shape[0]):
        out.append(out[-1] + incr[k])
    return torch.stack(out)


def column_tendencies(gall, tabs: ColumnTables, K: int, R: int):
    """The column math of grid_tendencies (dyn_grtend.f90, dynamics part)
    on the synthesized stack.  Returns (utend, vtend, ttend, trtend,
    psfield, grid_fields)."""
    nlat, nlon = gall.shape[-2:]
    vorg, divg, tg = gall[0:K], gall[K:2 * K], gall[2 * K:3 * K]
    trg = gall[3 * K:(3 + R) * K].reshape(R, K, nlat, nlon)
    o = (3 + R) * K
    ug, vg = gall[o:o + K], gall[o + K:o + 2 * K]
    px, py = gall[o + 2 * K], gall[o + 2 * K + 1]

    vorg_abs = vorg + tabs.coriol[:, None]
    umean = _level_sum(ug, tabs.dhs)
    vmean = _level_sum(vg, tabs.dhs)
    dmean = _level_sum(divg, tabs.dhs)
    psfield = -umean * px - vmean * py

    puv = (ug - umean) * px + (vg - vmean) * py
    dhs_c = tabs.dhs[:, None, None]
    sigdt = _cumsum_levels(-dhs_c * (puv + divg - dmean))
    sigm = _cumsum_levels(-dhs_c * puv)
    z1 = torch.zeros_like(ug[:1])

    tref = tabs.tref[:, None, None]
    dhsr = tabs.dhsr[:, None, None]
    tgg = tg - tref
    rpx, rpy = tabs.rgas * px, tabs.rgas * py

    def half_flux(f):
        """temp[j] = sigdt[j]*(f[j]-f[j-1]) on interior half levels."""
        return torch.cat([z1, sigdt[1:K] * (f[1:] - f[:-1]), z1], dim=0)

    tku = half_flux(ug)
    utend = vg * vorg_abs - tgg * rpx - (tku[1:] + tku[:-1]) * dhsr
    tkv = half_flux(vg)
    vtend = -ug * vorg_abs - tgg * rpy - (tkv[1:] + tkv[:-1]) * dhsr
    dtref = tref[1:] - tref[:-1]
    tkt = torch.cat([z1, sigdt[1:K] * (tgg[1:] - tgg[:-1])
                     + sigm[1:K] * dtref, z1], dim=0)
    ttend = (tgg * divg - (tkt[1:] + tkt[:-1]) * dhsr
             + tabs.fsgr[:, None, None] * tgg * (sigdt[1:] + sigdt[:-1])
             + tabs.tref3[:, None, None] * (sigm[1:] + sigm[:-1])
             + tabs.akap * (tg * puv - tgg * dmean))

    # tracers: vertical advection off in the top layers
    # (dyn_grtend.f90:196-207)
    trtend = []
    for q in trg:
        tk_int = sigdt[1:K] * (q[1:] - q[:-1])
        tk_int = torch.cat([torch.zeros_like(tk_int[:2]), tk_int[2:]])
        tk = torch.cat([z1, tk_int, z1], dim=0)
        trtend.append(q * divg - (tk[1:] + tk[:-1]) * dhsr)
    trtend = torch.stack(trtend)

    gf = dict(ug=ug, vg=vg, tg=tg, tgg=tgg, trg=trg, vorg=vorg, divg=divg,
              puv=puv, sigdt=sigdt, umean=umean, vmean=vmean, dmean=dmean,
              px=px, py=py)
    return utend, vtend, ttend, trtend, psfield, gf


def spectral_inputs(psfield, utend, vtend, ttend, trtend, gf):
    """The stack the forward transforms take (to_spectral_tendencies):
    [psfield; ke, ttend, trtend; u stack; v stack]."""
    ug, vg, tgg, trg = gf["ug"], gf["vg"], gf["tgg"], gf["trg"]
    R, K = trg.shape[:2]
    flat = lambda a: a.reshape(R * K, *a.shape[2:])
    ke = 0.5 * (ug * ug + vg * vg)
    return torch.cat([psfield[None], ke, ttend, flat(trtend),
                      utend, -ug * tgg, flat(-ug[None] * trg),
                      vtend, -vg * tgg, flat(-vg[None] * trg)], dim=0)


def grid_dynamics_plain(gall, ptend, tabs: ColumnTables, K: int, R: int):
    """The plain PyTorch version of the kernel."""
    utend, vtend, ttend, trtend, psfield, gf = column_tendencies(
        gall, tabs, K, R)
    if ptend is not None:
        utend = utend + ptend.u
        vtend = vtend + ptend.v
        ttend = ttend + ptend.t
        trtend = trtend + ptend.tr
    return spectral_inputs(psfield, utend, vtend, ttend, trtend, gf)


def grid_dynamics(gall, ptend, tabs: ColumnTables, K: int, R: int):
    """The K5 input stack (1 + 3(2+R)K, lat, lon) from the synthesized
    dynamics stack gall ((3+R)K + 2K + 2, lat, lon) and the physics
    tendencies ptend (a GridTendencies or None)."""
    if gall.device.type == "cpu":
        return grid_dynamics_plain(gall, ptend, tabs, K, R)
    if gall.device.type != "cuda":
        raise ValueError(f"grid_dynamics: no kernel for device {gall.device}")
    if K not in KERNEL_LEVELS or R != 1:
        raise ValueError(f"grid_dynamics: the kernel takes K in "
                         f"{KERNEL_LEVELS} and one tracer, not K={K}, R={R}")
    Bg, nlat, nlon = gall.shape
    dev = gall.device
    f32 = torch.float32
    kb.require(gall, "gall", f32, ((5 + R) * K + 2, nlat, nlon), dev)
    blob = tabs.blob if tabs.blob is not None else column_blob(tabs)
    ptrs = [None] * 4
    if ptend is not None:
        for i, (name, t, shape) in enumerate((
                ("ptend.u", ptend.u, (K, nlat, nlon)),
                ("ptend.v", ptend.v, (K, nlat, nlon)),
                ("ptend.t", ptend.t, (K, nlat, nlon)),
                ("ptend.tr", ptend.tr, (R, K, nlat, nlon)))):
            kb.require(t, name, f32, shape, dev)
            ptrs[i] = t.data_ptr()
    out = torch.empty((1 + 3 * (2 + R) * K, nlat, nlon), dtype=f32,
                      device=dev)
    code = kb.library().grid_dynamics_launch(
        kb.device_index(gall), K, gall.data_ptr(), *ptrs, blob.data_ptr(),
        float(tabs.rgas), float(tabs.akap), nlat, nlon, out.data_ptr(),
        kb.stream_of(gall))
    kb.check(code, "grid_dynamics")
    grid_dynamics.launches += 1
    return out


grid_dynamics.launches = 0

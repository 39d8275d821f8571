"""K26: the cgrate limiter of the eddy kinetic-energy growth rate, with the
leapfrog of vor and div after it (csrc/cgrate.cu), and its plain version.

The JAX package's DycoreModel._cgrate (dycore/model.py:565-585, called at
:540-542; the reference's cgrate, dyn_step.f90:192-276) damps the eddy
(m > 0) coefficients of the vor and div tendencies, after the diffusion
and before the leapfrog, when a level's growth rate grate = -sum Re(fdt
conj(invlap f)) exceeds grmax rnorm, rnorm = -sum Re(f conj(invlap f)):
by cd = the largest 0.8 grate / rnorm over the triggered levels k >= 1.
The sums run over every coefficient of a level, so they cannot live in
K8, whose lanes each hold one coefficient: with cgrate_on the step runs
K8's tendency form (vor's and div's diffused tendencies left in level 0
of their outputs) and then this kernel, which damps them and runs their
trunct, leapfrog and Robert-Asselin-Williams filter (dycore/model.py
DycoreModel.timint) into both levels.

`cgrate(dyn, state, out, j1, dt, eps)`: state the step's SpectralState,
out the tendency form's (its vor[0], div[0] the tendencies); returns out
with vor and div the new fields (on the card written in place).  The
sums' order is the plain version's (`damp_plain`: over n from n = 0, then
over m from m = 0), so that the kernel is bit-identical to it.

On a mesh (dycore/sharded.py; dyn a shard's view, its m range from
dyn.m0) the kernel runs in two forms around an all-gather, so that every
sum keeps the whole kernel's order:
  - `cgrate_rows(dyn, state, out)`: the shard's rows, (2, 2, K, mr): per
    field (vor, div) the sums over n of grate's and of rnorm's products of
    each (level, m), the m = 0 mask read at the global m;
  - `cgrate_range(dyn, state, out, rows, j1, dt, eps)`: rows (2, 2, K,
    mx), every shard's gathered in m order; the levels' sums over m from
    m = 0, cd, and the damping, trunct, leapfrog and filter of the shard's
    range (out written as `cgrate` writes it).
The whole kernel is the rows form followed by the range form on one
shard (`cgrate_plain` is written so).

On a CPU tensor each form runs its plain version (`cgrate_plain`,
`cgrate_rows_plain`, `cgrate_range_plain`); on a CUDA tensor it launches
the kernel (complex64 or complex128) or raises.
"""

from __future__ import annotations

import dataclasses

import torch

from speedy_ml_tpu_torch.kernels import build as kb

GRMAX = 0.2 / (86400.0 * 2.0)   # the growth rate that triggers, 1/s


def _sum_from_0(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, one element after another from index 0."""
    s = p[..., 0]
    for i in range(1, p.shape[-1]):
        s = s + p[..., i]
    return s


def _mask(f: torch.Tensor, m0: int) -> torch.Tensor:
    """(mr, 1): 1 where the global wavenumber m0 + m is an eddy (m > 0)."""
    m = torch.arange(m0, m0 + f.shape[1], device=f.device)
    return (m > 0).to(f.real.dtype)[:, None]


def row_sums(f: torch.Tensor, fdt: torch.Tensor, elm2: torch.Tensor,
             m0: int = 0) -> torch.Tensor:
    """(2, K, mr): the sums over n from n = 0 of grate's and of rnorm's
    masked products of each (level, m) of one field (K, mr, nx) complex."""
    fr, fi = f.real, f.imag
    dr, di = fdt.real, fdt.imag
    mask = _mask(f, m0)
    tr, ti = -fr * elm2, -fi * elm2
    return torch.stack([_sum_from_0((dr * tr + di * ti) * mask),
                        _sum_from_0((fr * tr + fi * ti) * mask)])


def damp_from_rows(f: torch.Tensor, fdt: torch.Tensor, rows: torch.Tensor,
                   m0: int = 0):
    """The damped tendency of one field (K, mr, nx) and its cd, from the
    field's rows (2, K, mx) of every wavenumber: each level's sums over m
    from m = 0."""
    grate, rnorm = -_sum_from_0(rows[0]), -_sum_from_0(rows[1])
    lev = torch.arange(f.shape[0], device=f.device) >= 1
    trig = (grate > GRMAX * rnorm) & lev & (rnorm > 0.0)
    cand = torch.where(trig, 0.8 * grate / torch.where(
        rnorm > 0, rnorm, torch.ones_like(rnorm)), torch.zeros_like(rnorm))
    cd = cand.max()
    mask = _mask(f, m0)
    out = torch.complex(fdt.real - cd * f.real * mask,
                        fdt.imag - cd * f.imag * mask)
    return out, cd


def damp_plain(f: torch.Tensor, fdt: torch.Tensor, elm2: torch.Tensor):
    """The damped tendency of one field (K, mx, nx) complex and its cd."""
    return damp_from_rows(f, fdt, row_sums(f, fdt, elm2))


def leapfrog_plain(dyn, field: torch.Tensor, fdt: torch.Tensor, j1: int,
                   dt: float, eps: float) -> torch.Tensor:
    """DycoreModel.timint on the real and imaginary parts, in its order."""
    sht = dyn.sht
    a, d = torch.view_as_real(field), torch.view_as_real(fdt)
    if dyn.geom.nlon == 4 * dyn.geom.nlat_half:
        d = d * sht.trfilt[..., None]
    old1, oldj = a[0], a[j1 - 1]
    fnew = old1 + dt * d
    wil = dyn.wil
    new1 = oldj + wil * eps * (old1 - 2.0 * oldj + fnew)
    new2 = fnew - (1.0 - wil) * eps * (new1 - 2.0 * oldj + fnew)
    return torch.view_as_complex(torch.stack([new1, new2]).contiguous())


def cgrate_rows_plain(dyn, state, out) -> torch.Tensor:
    """The rows form's plain version: (2, 2, K, mr), vor's then div's."""
    return torch.stack([row_sums(getattr(state, nm)[0],
                                 getattr(out, nm)[0], dyn.sht.elm2, dyn.m0)
                        for nm in ("vor", "div")])


def cgrate_range_plain(dyn, state, out, rows, j1: int, dt: float,
                       eps: float):
    """The range form's plain version (rows (2, 2, K, mx))."""
    new = {}
    for i, name in enumerate(("vor", "div")):
        fdt, _ = damp_from_rows(getattr(state, name)[0],
                                getattr(out, name)[0], rows[i], dyn.m0)
        new[name] = leapfrog_plain(dyn, getattr(state, name), fdt, j1, dt,
                                   eps)
    return dataclasses.replace(out, **new)


def cgrate_plain(dyn, state, out, j1: int, dt: float, eps: float):
    """The plain PyTorch version (see the module docstring): the rows form
    and the range form of one shard."""
    return cgrate_range_plain(dyn, state, out,
                              cgrate_rows_plain(dyn, state, out), j1, dt,
                              eps)


def _check(dyn, state, out):
    """The fields' complex and real dtypes and device, checked for a
    launch (the arrays of dyn's m range)."""
    dev = out.vor.device
    if dev.type != "cuda":
        raise ValueError(f"cgrate: no kernel for device {dev}")
    ct = out.vor.dtype
    if ct not in (torch.complex64, torch.complex128):
        raise TypeError(f"cgrate: dtype {ct}, the kernel takes complex64 or "
                        "complex128")
    rt = torch.float64 if ct == torch.complex128 else torch.float32
    g = dyn.geom
    K, mr, nx = g.nlev, out.vor.shape[2], g.nx
    for name in ("vor", "div"):
        kb.require(getattr(state, name), f"state.{name}", ct,
                   (2, K, mr, nx), dev)
        kb.require(getattr(out, name), f"out.{name}", ct, (2, K, mr, nx),
                   dev)
    return dev, rt, K, mr, nx


def cgrate_rows(dyn, state, out) -> torch.Tensor:
    """The rows form (see the module docstring): (2, 2, K, mr)."""
    if out.vor.device.type == "cpu":
        return cgrate_rows_plain(dyn, state, out)
    dev, rt, K, mr, nx = _check(dyn, state, out)
    kb.require(dyn.sht.elm2, "elm2", rt, (mr, nx), dev)
    rows = torch.empty((2, 2, K, mr), dtype=rt, device=dev)
    code = kb.library().cgrate_rows_launch(
        kb.device_index(out.vor), int(rt == torch.float64), K, mr, nx,
        int(dyn.m0), kb.pointer_array([state.vor[0], state.div[0]]),
        kb.pointer_array([out.vor, out.div]), dyn.sht.elm2.data_ptr(),
        rows.data_ptr(), kb.stream_of(out.vor))
    kb.check(code, "cgrate_rows")
    cgrate_rows.launches += 1
    return rows


def cgrate_range(dyn, state, out, rows, j1: int, dt: float, eps: float):
    """The range form (see the module docstring): out with vor and div the
    shard's new fields (on the card written in place)."""
    if out.vor.device.type == "cpu":
        return cgrate_range_plain(dyn, state, out, rows, j1, dt, eps)
    dev, rt, K, mr, nx = _check(dyn, state, out)
    mx = dyn.geom.mx
    kb.require(rows, "rows", rt, (2, 2, K, mx), dev)
    kb.require(dyn.sht.trfilt, "trfilt", rt, (mr, nx), dev)
    g = dyn.geom
    code = kb.library().cgrate_range_launch(
        kb.device_index(out.vor), int(rt == torch.float64), K, mx, mr, nx,
        int(dyn.m0), kb.pointer_array([state.vor[0], state.div[0]]),
        kb.pointer_array([state.vor[j1 - 1], state.div[j1 - 1]]),
        rows.data_ptr(), dyn.sht.trfilt.data_ptr(),
        kb.pointer_array([out.vor, out.div]),
        int(g.nlon == 4 * g.nlat_half), float(dt), float(dyn.wil * eps),
        float((1.0 - dyn.wil) * eps), GRMAX, kb.stream_of(out.vor))
    kb.check(code, "cgrate_range")
    cgrate_range.launches += 1
    return out


def cgrate(dyn, state, out, j1: int, dt: float, eps: float):
    """See the module docstring."""
    if out.vor.device.type == "cpu":
        return cgrate_plain(dyn, state, out, j1, dt, eps)
    dev, rt, K, mx, nx = _check(dyn, state, out)
    g = dyn.geom
    if mx != g.mx or dyn.m0:
        raise ValueError("cgrate: the whole form takes every wavenumber; a "
                         "shard's m range runs cgrate_rows and cgrate_range")
    sht = dyn.sht
    kb.require(sht.elm2, "elm2", rt, (mx, nx), dev)
    kb.require(sht.trfilt, "trfilt", rt, (mx, nx), dev)
    f = [state.vor[0], state.div[0]]
    fj = [state.vor[j1 - 1], state.div[j1 - 1]]
    o = [out.vor, out.div]
    code = kb.library().cgrate_launch(
        kb.device_index(out.vor), int(rt == torch.float64), K, mx, nx,
        kb.pointer_array(f), kb.pointer_array(fj), sht.elm2.data_ptr(),
        sht.trfilt.data_ptr(), kb.pointer_array(o),
        int(g.nlon == 4 * g.nlat_half), float(dt), float(dyn.wil * eps),
        float((1.0 - dyn.wil) * eps), GRMAX, kb.stream_of(out.vor))
    kb.check(code, "cgrate")
    cgrate.launches += 1
    return out


cgrate.launches = 0
cgrate_rows.launches = 0
cgrate_range.launches = 0

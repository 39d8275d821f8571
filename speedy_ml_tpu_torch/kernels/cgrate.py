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

On a CPU tensor `cgrate` runs `cgrate_plain`; on a CUDA tensor it
launches the kernel (complex64 or complex128) or raises.
"""

from __future__ import annotations

import dataclasses

import torch

from speedy_ml_tpu_torch.kernels import build as kb

GRMAX = 0.2 / (86400.0 * 2.0)   # the growth rate that triggers, 1/s


def _ordered_sum(p: torch.Tensor) -> torch.Tensor:
    """(K, mx, nx) -> (K,): over n from n = 0, then over m from m = 0."""
    s = p[..., 0]
    for n in range(1, p.shape[-1]):
        s = s + p[..., n]
    t = s[:, 0]
    for m in range(1, s.shape[1]):
        t = t + s[:, m]
    return t


def damp_plain(f: torch.Tensor, fdt: torch.Tensor, elm2: torch.Tensor):
    """The damped tendency of one field (K, mx, nx) complex and its cd."""
    fr, fi = f.real, f.imag
    dr, di = fdt.real, fdt.imag
    mask = (torch.arange(f.shape[1], device=f.device) > 0).to(fr.dtype)
    mask = mask[:, None]
    tr, ti = -fr * elm2, -fi * elm2
    grate = -_ordered_sum((dr * tr + di * ti) * mask)
    rnorm = -_ordered_sum((fr * tr + fi * ti) * mask)
    lev = torch.arange(f.shape[0], device=f.device) >= 1
    trig = (grate > GRMAX * rnorm) & lev & (rnorm > 0.0)
    cand = torch.where(trig, 0.8 * grate / torch.where(
        rnorm > 0, rnorm, torch.ones_like(rnorm)), torch.zeros_like(rnorm))
    cd = cand.max()
    out = torch.complex(dr - cd * fr * mask, di - cd * fi * mask)
    return out, cd


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


def cgrate_plain(dyn, state, out, j1: int, dt: float, eps: float):
    """The plain PyTorch version (see the module docstring)."""
    new = {}
    for name in ("vor", "div"):
        fdt, _ = damp_plain(getattr(state, name)[0], getattr(out, name)[0],
                            dyn.sht.elm2)
        new[name] = leapfrog_plain(dyn, getattr(state, name), fdt, j1, dt,
                                   eps)
    return dataclasses.replace(out, **new)


def cgrate(dyn, state, out, j1: int, dt: float, eps: float):
    """See the module docstring."""
    dev = out.vor.device
    if dev.type == "cpu":
        return cgrate_plain(dyn, state, out, j1, dt, eps)
    if dev.type != "cuda":
        raise ValueError(f"cgrate: no kernel for device {dev}")
    ct = out.vor.dtype
    if ct not in (torch.complex64, torch.complex128):
        raise TypeError(f"cgrate: dtype {ct}, the kernel takes complex64 or "
                        "complex128")
    rt = torch.float64 if ct == torch.complex128 else torch.float32
    g = dyn.geom
    K, mx, nx = g.nlev, g.mx, g.nx
    for name in ("vor", "div"):
        kb.require(getattr(state, name), f"state.{name}", ct,
                   (2, K, mx, nx), dev)
        kb.require(getattr(out, name), f"out.{name}", ct, (2, K, mx, nx),
                   dev)
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

"""K15: the spectral stacks that feed K6 (csrc/spectral_stack.cu) and
their plain versions.

From the spectral state (both leapfrog levels) and the spectral
orography phis, one launch writes
  - the dynamics stack at level jd, the input of a step's synthesis
    (the JAX package's grid_tendencies, dycore/model.py:258-280):
    [vor, div, t, tracers (R*K) | u cos, v cos (uvspec), dps/dx, dps/dy
    (grad)], 1/cos applying from field dynamics_ncos(K, R) on;
  - the physics stack at level jp, the input of the physics' synthesis
    (the JAX package's GCM._physics_fn, gcm.py:222-234, in the port's
    order): [t, q, phi (geopotential), ps | u cos, v cos], 1/cos from
    field physics_ncos(K) on;
either of them alone, or both.  A leapfrog step asks for both at
(jd, jp) = (1, 0), stepone's steps at (0, 0) and (1, 0), the dry core
for the dynamics stack alone, GCM.physics_grid for the physics stack
alone.

On a CPU tensor `spectral_stack` runs the plain versions (built from
SpectralTransform.uvspec and grad and DycoreModel.geopotential); on a
CUDA tensor it launches the kernel or raises.

The m-range form (a shard of GCM.set_mesh): the state holds the
wavenumbers m0 .. m0 + mx - 1 of the whole (dyn.m0, the shard's
DycoreModel view, whose tables are the range's); the kernel is the same
launch with m0, which only the m = 0 correction of the geopotential
reads.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.kernels import build as kb

KERNEL_LEVELS = (5, 7, 8)   # K values compiled in csrc/spectral_stack.cu
MAX_N = 32                  # csrc/spectral_stack.cuh STACK_MAX_N


def dynamics_ncos(K: int, R: int) -> int:
    """The first field of the dynamics stack that takes 1/cos."""
    return (3 + R) * K


def physics_ncos(K: int) -> int:
    """The first field of the physics stack that takes 1/cos."""
    return 3 * K + 1


def stack_blob(dyn, dtype=torch.float32) -> torch.Tensor:
    """The kernel's table buffer in `dtype` (csrc/spectral_stack.cuh
    StackTab): uvdx, uvdym, uvdyp, gradym, gradyp (mx, nx); gradx (mx,);
    zrow (nx,); xgeop1, xgeop2, geop_corf (K,) -- the tensors the plain
    version reads."""
    sht = dyn.sht
    parts = [sht.uvdx, sht.uvdym, sht.uvdyp, sht.gradym, sht.gradyp,
             sht.gradx, sht.zrow_mask, dyn.xgeop1, dyn.xgeop2,
             dyn.geop_corf]
    return torch.cat([p.reshape(-1).to(dtype) for p in parts]).contiguous()


def dynamics_stack_plain(dyn, state, j: int) -> torch.Tensor:
    """The dynamics stack at level j (plain PyTorch)."""
    g = dyn.geom
    K, R = g.nlev, g.ntracers
    vor_s, div_s, t_s, ps_s, tr_s = state.at_level(j)
    ucosm, vcosm = dyn.sht.uvspec(vor_s, div_s)
    pxs, pys = dyn.sht.grad(ps_s)
    return torch.cat([vor_s, div_s, t_s, tr_s.reshape(R * K, *t_s.shape[-2:]),
                      ucosm, vcosm, pxs[None], pys[None]], dim=0)


def physics_stack_plain(dyn, state, j: int, phis) -> torch.Tensor:
    """The physics stack at level j (plain PyTorch)."""
    vor_s, div_s, t_s, ps_s, tr_s = state.at_level(j)
    ucosm, vcosm = dyn.sht.uvspec(vor_s, div_s)
    phi_s = dyn.geopotential(t_s, phis)
    return torch.cat([t_s, tr_s[0], phi_s, ps_s[None], ucosm, vcosm], dim=0)


def spectral_stack(dyn, state, phis, jd, jp):
    """(the dynamics stack at level jd, the physics stack at level jp);
    a level of None leaves its stack out (None in its place).  dyn: the
    DycoreModel whose tables (and, on the card, stack_blob) apply."""
    if jd is None and jp is None:
        raise ValueError("spectral_stack: ask for at least one stack")
    dev = state.vor.device
    if dev.type == "cpu":
        return (None if jd is None else dynamics_stack_plain(dyn, state, jd),
                None if jp is None else physics_stack_plain(dyn, state, jp,
                                                            phis))
    if dev.type != "cuda":
        raise ValueError(f"spectral_stack: no kernel for device {dev}")
    g = dyn.geom
    K, R, nx = g.nlev, g.ntracers, g.nx
    mx, m0 = state.vor.shape[-2], dyn.m0
    if K not in KERNEL_LEVELS or R != 1 or nx > MAX_N:
        raise ValueError(f"spectral_stack: the kernel takes K in "
                         f"{KERNEL_LEVELS}, one tracer and nx <= {MAX_N}, "
                         f"not K={K}, R={R}, nx={nx}")
    blob = dyn.stack_blob
    if blob is None:
        raise ValueError("spectral_stack: the kernel needs the float32 "
                         "table blob (a float32 DycoreModel)")
    c64 = torch.complex64
    kb.require(blob, "stack_blob", torch.float32,
               (5 * mx * nx + mx + nx + 3 * K,), dev)
    for name, shape in (("vor", (2, K, mx, nx)), ("div", (2, K, mx, nx)),
                        ("t", (2, K, mx, nx)), ("ps", (2, mx, nx)),
                        ("tr", (2, R, K, mx, nx))):
        kb.require(getattr(state, name), f"state.{name}", c64, shape, dev)
    for name, j in (("jd", jd), ("jp", jp)):
        if j not in (None, 0, 1):
            raise ValueError(f"spectral_stack: {name}={j}, a level is 0 or 1")
    out_d = out_p = None
    if jd is not None:
        out_d = torch.empty((6 * K + 2, mx, nx), dtype=c64, device=dev)
    if jp is not None:
        kb.require(phis, "phis", c64, (mx, nx), dev)
        out_p = torch.empty((5 * K + 1, mx, nx), dtype=c64, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    code = kb.library().spectral_stack_launch(
        kb.device_index(state.vor), K, mx, nx, state.vor.data_ptr(),
        state.div.data_ptr(), state.t.data_ptr(), state.ps.data_ptr(),
        state.tr.data_ptr(), None if jp is None else phis.data_ptr(),
        blob.data_ptr(), jd or 0, jp or 0, ptr(out_d), ptr(out_p), m0,
        kb.stream_of(state.vor))
    kb.check(code, "spectral_stack")
    spectral_stack.launches += 1
    return out_d, out_p


spectral_stack.launches = 0

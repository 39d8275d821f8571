"""K8: the spectral tail of a dycore step (csrc/spectral_tail.cu) and its
plain version.

Input: the analysed K7 stack A (1 + 3(2+R)K, mx, nx) complex
([psdt; ke, ttend, trtend; u stack; v stack], u and v already times
1/cos), the state (both leapfrog levels), the spectral orography phis,
the orographic corrections (tcorh, qcorh) or None, and one set of
semi-implicit coefficients.  Per spectral coefficient (m, n), in the
order of the JAX package's DycoreModel.step (dycore/model.py:505-562):
vds and the lap/advection sums; sptend with the geopotential;
implicit_correction (the 8x8 xd, xc and xj mixes, xj by total
wavenumber l = m + n); the horizontal diffusion with the orographic
corrections; the drag on m = 0 of level 0; the extra del^2 of level 0;
trunct; the leapfrog and the Robert-Asselin-Williams filter.  Output:
the new state (vor, div, t, ps, tr), both levels.

On a CPU tensor `spectral_tail` runs the plain version
(DycoreModel.spectral_tail_plain, built from the dycore's methods); on a
CUDA tensor it launches the kernel or raises.

The m-range form (a shard of GCM.set_mesh): every operand holds the
wavenumbers m0 .. m0 + mx - 1 of the whole (dyn.m0; the shard's
DycoreModel view, whose tables and blob are the range's, the blob's xj
up to l = m0 + mx + nx - 2); the kernel is the same launch with m0,
which the total wavenumber l = m + n and the m = 0 terms read.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.kernels import build as kb

KERNEL_LEVELS = (5, 7, 8)   # K values compiled in csrc/spectral_tail.cu
XJ_ROW = 8                  # elements a row of the per-l xj table


def blob_size(K: int, mx: int, nx: int, m0: int = 0) -> int:
    """Elements of tail_blob (csrc/spectral_tail.cuh tail_blob_size; an
    m range from m0 holds xj up to l = m0 + mx + nx - 2)."""
    head = 12 * K + 2 * K * K + mx + nx + 11 * mx * nx
    return -(-head // 4) * 4 + (m0 + mx + nx - 2) * K * XJ_ROW


def tail_blob(dyn, imp, dtype=torch.float32) -> torch.Tensor:
    """The table buffer of the kernel in `dtype`, in the order the kernel
    reads it (csrc/spectral_tail.cuh, TailTab): the (K,) and (K, K)
    tables; gradx, zrow; the (mx, nx) tables; zeros up to a multiple of 4
    elements; the inverse per total wavenumber, imp.xj, each row padded
    with zeros to XJ_ROW elements."""
    sht = dyn.sht
    parts = [dyn.dhs, dyn.dhsr, dyn.xgeop1, dyn.xgeop2, dyn.geop_corf,
             dyn.tcorv, dyn.qcorv, imp.tref, imp.tref1, imp.tref2, imp.tref3,
             imp.dhsx, imp.xc, imp.xd, sht.gradx, sht.zrow_mask, sht.vddym,
             sht.vddyp, sht.el2, sht.trfilt, dyn.dmp, dyn.dmpd, dyn.dmps,
             imp.elz, imp.dmp1, imp.dmp1d, imp.dmp1s]
    head = torch.cat([p.reshape(-1).to(dtype) for p in parts])
    lmax, K, _ = imp.xj.shape
    xj = head.new_zeros((lmax, K, XJ_ROW))
    xj[..., :K] = imp.xj
    return torch.cat([head, head.new_zeros(-head.numel() % 4),
                      xj.reshape(-1)]).contiguous()


def spectral_tail(dyn, A, state, phis, corrections, imp, j1: int,
                  dt: float, eps: float, j4: int, implicit: bool,
                  cg: bool = False):
    """The new SpectralState after one step (see the module docstring);
    j4 is the level sptend reads, implicit whether the semi-implicit
    correction runs (alph != 0).  cg: the tendency form (cgrate_on): the
    new state's vor[0] and div[0] hold their diffused tendencies, whose
    limiter and leapfrog K26 runs (kernels/cgrate.py); vor[1] and div[1]
    are not written."""
    if A.device.type == "cpu":
        return dyn.spectral_tail_plain(A, state, phis, corrections, imp,
                                       j1, dt, eps, j4, implicit, cg)
    if A.device.type != "cuda":
        raise ValueError(f"spectral_tail: no kernel for device {A.device}")
    g = dyn.geom
    K, R, nx = g.nlev, g.ntracers, g.nx
    mx, m0 = A.shape[-2], dyn.m0
    if K not in KERNEL_LEVELS or R != 1:
        raise ValueError(f"spectral_tail: the kernel takes K in "
                         f"{KERNEL_LEVELS} and one tracer, not K={K}, R={R}")
    if imp.blob is None:
        raise ValueError("spectral_tail: the kernel needs the float32 "
                         "table blob (a float32 DycoreModel)")
    dev = A.device
    c64 = torch.complex64
    kb.require(imp.blob, "imp.blob", torch.float32,
               (blob_size(K, mx, nx, m0),), dev)
    if imp.blob.data_ptr() % 16:
        raise ValueError("spectral_tail: imp.blob must be 16-byte aligned")
    kb.require(A, "A", c64, (1 + 3 * (2 + R) * K, mx, nx), dev)
    for name, shape in (("vor", (2, K, mx, nx)), ("div", (2, K, mx, nx)),
                        ("t", (2, K, mx, nx)), ("ps", (2, mx, nx)),
                        ("tr", (2, R, K, mx, nx))):
        kb.require(getattr(state, name), f"state.{name}", c64, shape, dev)
    kb.require(phis, "phis", c64, (mx, nx), dev)
    tcorh, qcorh = corrections if corrections is not None else (None, None)
    for name, t in (("tcorh", tcorh), ("qcorh", qcorh)):
        if t is not None:
            kb.require(t, name, c64, (mx, nx), dev)
    out = {k: torch.empty_like(getattr(state, k))
           for k in ("vor", "div", "t", "ps", "tr")}
    ptr = lambda t: None if t is None else t.data_ptr()
    code = kb.library().spectral_tail_launch(
        kb.device_index(A), K, mx, nx, A.data_ptr(), state.vor.data_ptr(),
        state.div.data_ptr(), state.t.data_ptr(), state.ps.data_ptr(),
        state.tr.data_ptr(), phis.data_ptr(), ptr(tcorh), ptr(qcorh),
        imp.blob.data_ptr(), j1, j4, int(implicit),
        int(g.nlon == 4 * g.nlat_half), float(dt), float(dyn.wil * eps),
        float((1.0 - dyn.wil) * eps), float(dyn.sdrag),
        float(dyn.const.rgas), out["vor"].data_ptr(), out["div"].data_ptr(),
        out["t"].data_ptr(), out["ps"].data_ptr(), out["tr"].data_ptr(),
        int(cg), m0, kb.stream_of(A))
    kb.check(code, "spectral_tail")
    spectral_tail.launches += 1
    return type(state)(**out)


spectral_tail.launches = 0

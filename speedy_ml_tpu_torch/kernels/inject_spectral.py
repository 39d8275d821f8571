"""K6_inject: the injection's synthesis with K18, its spectral glue, as
phase 0 (csrc/sht_synthesis.cu, csrc/inject_spectral.cuh), and their
plain versions.

Between K5's analysis and the gate of HybridAtmosphere.inject_to_speedy
(the JAX package's hybrid/model.py:404-434): from K5's analysis `spec` of
[t, q (K each), logp | u cos, v cos (K each)], K18's arithmetic computes
vor and div (vds), truncates the five fields (trunct) and forms u cos and
v cos of the truncated vor and div (uvspec), giving
  - the SpectralState with both leapfrog levels equal (the injected
    state), and
  - the stack [t, q | u cos, v cos] (4K fields, 1/cos from field 2K on),
which K6 takes back to the grid for the gate.  One launch does both: the
stack never leaves the blocks of the synthesis.

On a CPU tensor `inject_synthesis` runs `inject_spectral_plain` and then
the transform's synthesis (K6's plain version); on a CUDA tensor it
launches the kernel (complex64) or raises.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.kernels import build as kb

MAX_N = 32   # a warp's lanes: coefficients n of a row


def inject_blob(sht) -> torch.Tensor:
    """The kernel's table buffer in the transform's dtype
    (csrc/inject_spectral.cuh InjTab): uvdx, uvdym, uvdyp, vddym, vddyp,
    trfilt (mx, nx); gradx (mx,); zrow (nx,) -- the tensors the plain
    version reads."""
    parts = [sht.uvdx, sht.uvdym, sht.uvdyp, sht.vddym, sht.vddyp,
             sht.trfilt, sht.gradx, sht.zrow_mask]
    return torch.cat([p.reshape(-1) for p in parts]).contiguous()


def inject_spectral_plain(sht, spec, K: int):
    """(SpectralState, stack) in plain PyTorch."""
    vor, div = sht.vds(spec[2 * K + 1:3 * K + 1], spec[3 * K + 1:])
    vor, div = sht.trunct(vor), sht.trunct(div)
    t_s, q_s = sht.trunct(spec[:K]), sht.trunct(spec[K:2 * K])
    ps_s = sht.trunct(spec[2 * K])
    ucosm, vcosm = sht.uvspec(vor, div)
    two = lambda a: torch.stack([a, a])
    state = SpectralState(vor=two(vor), div=two(div), t=two(t_s),
                          ps=two(ps_s), tr=two(q_s[None]))
    return state, torch.cat([t_s, q_s, ucosm, vcosm])


def inject_synthesis(sht, spec, K: int):
    """spec: (4K + 1, mx, nx) complex, K5's analysis of [t, q, logp | u,
    v] with u and v times 1/cos.  Returns (the injected SpectralState, the
    grid (4K, nlat, nlon) of [t, q | u, v], the synthesis of the stack
    with u and v times cos)."""
    dev = spec.device
    if dev.type == "cpu":
        state, stack = inject_spectral_plain(sht, spec, K)
        return state, sht.synthesis(stack, 2 * K)
    if dev.type != "cuda":
        raise ValueError(f"inject_synthesis: no kernel for device {dev}")
    g = sht.geom
    mx, nx, nlat, nlon = g.mx, g.nx, g.nlat, g.nlon
    if nx > MAX_N:
        raise ValueError(f"inject_synthesis: the kernel takes nx <= {MAX_N}, "
                         f"not {nx}")
    cd = torch.complex64
    kb.require(spec, "spec", cd, (4 * K + 1, mx, nx), dev)
    blob = sht.inject_blob
    kb.require(blob, "sht.inject_blob", torch.float32,
               (6 * mx * nx + mx + nx,), dev)
    kb.require(sht.dft_inv, "dft_inv", cd, (mx, nlon), dev)
    kb.require(sht.cpol_g, "cpol_g", torch.float32, (nlat // 2, mx, nx), dev)
    kb.require(sht.cosgr, "cosgr", torch.float32, (nlat,), dev)
    new = lambda *s: torch.empty(s, dtype=cd, device=dev)
    state = SpectralState(vor=new(2, K, mx, nx), div=new(2, K, mx, nx),
                          t=new(2, K, mx, nx), ps=new(2, mx, nx),
                          tr=new(2, 1, K, mx, nx))
    grid = torch.empty((4 * K, nlat, nlon), dtype=torch.float32, device=dev)
    code = kb.library().inject_synthesis_launch(
        kb.device_index(spec), K, spec.data_ptr(), blob.data_ptr(),
        sht.dft_inv.data_ptr(), sht.cpol_g.data_ptr(), sht.cosgr.data_ptr(),
        nlat, nlon, mx, nx, state.vor.data_ptr(), state.div.data_ptr(),
        state.t.data_ptr(), state.ps.data_ptr(), state.tr.data_ptr(),
        grid.data_ptr(), kb.stream_of(spec))
    kb.check(code, "inject_synthesis")
    inject_synthesis.launches += 1
    return state, grid


inject_synthesis.launches = 0

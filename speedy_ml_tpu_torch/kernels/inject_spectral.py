"""K18: the injection's spectral glue (csrc/inject_spectral.cu) and its
plain version.

Between the two transforms of HybridAtmosphere.inject_to_speedy (the JAX
package's hybrid/model.py:404-434): from K5's analysis `spec` of [t, q
(K each), logp | u cos, v cos (K each)], one launch computes vor and div
(vds), truncates the five fields (trunct), forms u cos and v cos of the
truncated vor and div (uvspec) and writes
  - the SpectralState with both leapfrog levels equal (the injected
    state), and
  - the stack [t, q | u cos, v cos] (4K fields, 1/cos from field 2K on)
    that K6 takes back to the grid for the gate.

On a CPU tensor `inject_spectral` runs `inject_spectral_plain` (the
SpectralTransform's vds, trunct and uvspec); on a CUDA tensor it launches
the kernel (complex64 or complex128) or raises.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.kernels import build as kb

KERNEL_LEVELS = (5, 7, 8)   # K values compiled in csrc/inject_spectral.cu
MAX_N = 32                  # csrc/spectral_stack.cuh STACK_MAX_N


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


def inject_spectral(sht, spec, K: int):
    """spec: (4K + 1, mx, nx) complex, K5's analysis of [t, q, logp | u,
    v] with u and v times 1/cos.  Returns (the injected SpectralState, the
    stack (4K, mx, nx) for K6)."""
    dev = spec.device
    if dev.type == "cpu":
        return inject_spectral_plain(sht, spec, K)
    if dev.type != "cuda":
        raise ValueError(f"inject_spectral: no kernel for device {dev}")
    g = sht.geom
    mx, nx = g.mx, g.nx
    if K not in KERNEL_LEVELS or nx > MAX_N:
        raise ValueError(f"inject_spectral: the kernel takes K in "
                         f"{KERNEL_LEVELS} and nx <= {MAX_N}, not K={K}, "
                         f"nx={nx}")
    cd = spec.dtype
    if cd not in (torch.complex64, torch.complex128):
        raise TypeError(f"inject_spectral: dtype {cd}, the kernel takes "
                        "complex64 or complex128")
    real = torch.float64 if cd == torch.complex128 else torch.float32
    kb.require(spec, "spec", cd, (4 * K + 1, mx, nx), dev)
    blob = sht.inject_blob
    kb.require(blob, "sht.inject_blob", real, (6 * mx * nx + mx + nx,), dev)
    new = lambda *s: torch.empty(s, dtype=cd, device=dev)
    state = SpectralState(vor=new(2, K, mx, nx), div=new(2, K, mx, nx),
                          t=new(2, K, mx, nx), ps=new(2, mx, nx),
                          tr=new(2, 1, K, mx, nx))
    stk = new(4 * K, mx, nx)
    code = kb.library().inject_spectral_launch(
        kb.device_index(spec), K, int(cd == torch.complex128), mx, nx,
        spec.data_ptr(), state.vor.data_ptr(), state.div.data_ptr(),
        state.t.data_ptr(), state.ps.data_ptr(), state.tr.data_ptr(),
        stk.data_ptr(), blob.data_ptr(), kb.stream_of(spec))
    kb.check(code, "inject_spectral")
    inject_spectral.launches += 1
    return state, stk


inject_spectral.launches = 0

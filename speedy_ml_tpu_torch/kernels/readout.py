"""K2: the readout kernel (csrc/readout.cu) and its plain version.

out = (Wout [local_model ; quad_expand(x)]) * out_std + out_mean per
region; Wout (R, O, S + n) in float32 or bfloat16.  With bf16 Wout the
augmented vector is rounded to bf16 before the product and the sum is
f32, as the JAX readout does (aug.astype(bfloat16) with an f32
accumulator).  out_mean/out_std None: the bare product.

Given a CoreScatter, the outputs go straight to their elements of the
assembled grid with the q and precip clamps (the core scatter,
kernels/core_scatter.py), not to an (R, O) vector: the cycle's three
readout launches assemble its grid, with no launch of their own.

On a CPU tensor `readout` runs `readout_plain` (and `scatter_plain`); on a
CUDA tensor it launches the kernel or raises.  The kernel streams Wout
with 16-byte loads where `vector_path(wout)` holds, else element by
element.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels.core_scatter import (CoreScatter,
                                                      scatter_plain)


def quad_expand(x: torch.Tensor) -> torch.Tensor:
    """Square every second node (Fortran rows 2:n:2 -> 0-based odd)."""
    odd = (torch.arange(x.shape[-1], device=x.device) % 2) == 1
    return torch.where(odd, x * x, x)


def vector_path(wout: torch.Tensor) -> bool:
    """Whether the kernel reads Wout (R, O, A) with 16-byte loads: A a
    multiple of 4 and Wout aligned to 4 elements (every row then starts
    on a 16-byte boundary or 8 bytes past one, in bf16).  The rule of
    ro_vector_ok in csrc/readout.cuh."""
    return (wout.shape[-1] % 4 == 0
            and wout.data_ptr() % (4 * wout.element_size()) == 0)


def readout_plain(wout, x, local_model=None, out_mean=None, out_std=None
                  ) -> torch.Tensor:
    """The plain PyTorch version of the kernel."""
    xt = quad_expand(x)
    aug = xt if local_model is None else torch.cat([local_model, xt], dim=-1)
    if wout.dtype == torch.bfloat16:
        out = torch.einsum("roa,ra->ro", wout.float(),
                           aug.to(torch.bfloat16).float())
    else:
        out = torch.einsum("roa,ra->ro", wout, aug)
    if out_std is None:
        return out
    return out * out_std + out_mean


def readout(wout, x, local_model=None, out_mean=None, out_std=None, *,
            scatter: CoreScatter | None = None):
    """Readout (R, O) of every region: wout (R, O, S + n), x (R, n),
    local_model (R, S) or None (S = 0), out_mean/out_std (R, O) or None.
    With `scatter`, the outputs are stored into scatter.grid instead (with
    the clamps), and the call returns None."""
    if (out_mean is None) != (out_std is None):
        raise ValueError("readout: pass both out_mean and out_std or neither")
    if x.device.type == "cpu":
        out = readout_plain(wout, x, local_model, out_mean, out_std)
        if scatter is None:
            return out
        scatter_plain(out, scatter)
        return None
    if x.device.type != "cuda":
        raise ValueError(f"readout: no kernel for device {x.device}")
    R, O, A = wout.shape
    n = x.shape[1]
    S = A - n
    dev = x.device
    f32 = torch.float32
    if wout.dtype not in (torch.bfloat16, f32):
        raise TypeError(f"readout: Wout dtype {wout.dtype}, kernel takes "
                        "bfloat16 or float32")
    kb.require(wout, "wout", wout.dtype, (R, O, A), dev)
    kb.require(x, "x", f32, (R, n), dev)
    if S < 0 or (S > 0) != (local_model is not None):
        raise ValueError(f"readout: Wout width {A} does not fit x ({n}) and "
                         f"local_model "
                         f"({None if local_model is None else local_model.shape})")
    if local_model is not None:
        kb.require(local_model, "local_model", f32, (R, S), dev)
    if out_mean is not None:
        kb.require(out_mean, "out_mean", f32, (R, O), dev)
        kb.require(out_std, "out_std", f32, (R, O), dev)
    if scatter is None:
        out, sc = torch.empty((R, O), dtype=f32, device=dev), None
    else:
        out, sc = None, scatter
        if sc.grid.dim() != 1:
            raise ValueError("readout: scatter.grid must be flat")
        kb.require(sc.grid, "scatter.grid", f32, None, dev)
        kb.require(sc.index, "scatter.index", torch.int32, (R, O), dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    q, p = (sc.q, sc.p) if sc is not None else ((0, 0), (0, 0))
    code = kb.library().readout_launch(
        kb.device_index(x), int(wout.dtype == torch.bfloat16),
        wout.data_ptr(), x.data_ptr(), ptr(local_model), ptr(out_mean),
        ptr(out_std), R, O, S, n, ptr(out),
        None if sc is None else sc.grid.data_ptr(),
        None if sc is None else sc.index.data_ptr(), q[0], q[1], p[0], p[1],
        kb.stream_of(x))
    kb.check(code, "readout")
    readout.launches += 1
    return out


readout.launches = 0

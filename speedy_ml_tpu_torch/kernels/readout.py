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

The components form (`parts`, the cycle's emit_components; the JAX
package's predict_all(components=True), hybrid/model.py:338-372) also
stores the readout's two parts, standardized and without the clamps:
v_p = Wout[:, :, :S] local_model (0 without one) and v_ml = Wout[:, :, S:]
quad_expand(x); the main output is unstandardize(v_p + v_ml).  The same
launch makes one pass over Wout with two sums.  There the augmented
vector is NOT rounded to bf16: the JAX einsum of a bf16 Wout and the f32
vector promotes to f32, so with bf16 Wout even the main output differs
from the readout without components by about the bf16 rounding.

On a CPU tensor `readout` runs `readout_plain` (or
`readout_components_plain`) and `scatter_plain`; on a CUDA tensor it
launches the kernel or raises.  The kernel streams Wout with 16-byte loads
where `vector_path(wout)` holds, else element by element.
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


def readout_components_plain(wout, x, local_model=None, out_mean=None,
                             out_std=None):
    """The plain version of the components form: (out, v_p, v_ml), each
    (R, O); v_p and v_ml standardized, out unstandardize(v_p + v_ml) (or
    the bare sum).  A bf16 Wout meets the f32 vector unrounded."""
    S = wout.shape[-1] - x.shape[-1]
    w = wout.float() if wout.dtype == torch.bfloat16 else wout
    v_ml = torch.einsum("roa,ra->ro", w[:, :, S:], quad_expand(x))
    if local_model is None:
        v_p = torch.zeros_like(v_ml)
        out = v_ml
    else:
        v_p = torch.einsum("roa,ra->ro", w[:, :, :S], local_model)
        out = v_p + v_ml
    if out_std is not None:
        out = out * out_std + out_mean
    return out, v_p, v_ml


def readout(wout, x, local_model=None, out_mean=None, out_std=None, *,
            scatter: CoreScatter | None = None, parts=None):
    """Readout (R, O) of every region: wout (R, O, S + n), x (R, n),
    local_model (R, S) or None (S = 0), out_mean/out_std (R, O) or None.
    With `scatter`, the outputs are stored into scatter.grid instead (with
    the clamps), and the call returns None.  parts: None (the main form),
    or (vp, vml), where the components form stores v_p and v_ml: two flat
    grids of scatter.grid's size with a scatter (the same elements, no
    clamps), else two (R, O) tensors."""
    if (out_mean is None) != (out_std is None):
        raise ValueError("readout: pass both out_mean and out_std or neither")
    if x.device.type == "cpu":
        if parts is None:
            out = readout_plain(wout, x, local_model, out_mean, out_std)
        else:
            out, v_p, v_ml = readout_components_plain(
                wout, x, local_model, out_mean, out_std)
            for dst, v in zip(parts, (v_p, v_ml)):
                if scatter is None:
                    dst.copy_(v)
                else:   # the same elements, no clamps
                    scatter_plain(v, scatter._replace(grid=dst, q=(0, 0),
                                                      p=(0, 0)))
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
    tail = (None if sc is None else sc.grid.data_ptr(),
            None if sc is None else sc.index.data_ptr(), q[0], q[1], p[0],
            p[1], kb.stream_of(x))
    head = (kb.device_index(x), int(wout.dtype == torch.bfloat16),
            wout.data_ptr(), x.data_ptr(), ptr(local_model), ptr(out_mean),
            ptr(out_std), R, O, S, n, ptr(out))
    if parts is None:
        code = kb.library().readout_launch(*head, *tail)
    else:
        shape = tuple(sc.grid.shape) if sc is not None else (R, O)
        for nm, t in zip(("vp", "vml"), parts):
            kb.require(t, f"parts.{nm}", f32, shape, dev)
        code = kb.library().readout_components_launch(
            *head, parts[0].data_ptr(), parts[1].data_ptr(), *tail)
    kb.check(code, "readout")
    readout.launches += 1
    return out


readout.launches = 0

"""K19: the injection's safety gate (csrc/gate_check.cu) and its plain
version.

The JAX package's gate (hybrid/model.py:423-426, ppo_iogrid.f90:563-577)
on the grid K6 returns after the double transform, back (4K, lat, lon) =
[t, q, u, v]: the smallest and largest value of each variable, and the
flag that every one lies in its range (GATE_BOUNDS).  A NaN anywhere makes
its variable's extrema NaN and the flag false, as torch.amin/amax and the
comparisons do.  One launch writes the eight extrema (u, v, t, q; min,
max each) and the 0-d bool flag, which stays on the card.

On a CPU tensor `gate_check` runs `gate_check_plain`; on a CUDA tensor it
launches the kernel (float32 or float64) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from speedy_ml_tpu_torch.kernels import build as kb

# (lo, hi) of u, v, t, q in the gate's order (csrc/gate_check.cuh)
GATE_BOUNDS = ((-150.0, 150.0), (-120.0, 120.0), (160.0, 330.0),
               (-6.0, 30.0))


def _variables(back, K: int):
    """u, v, t, q of the stack [t, q, u, v]."""
    return back[2 * K:3 * K], back[3 * K:], back[:K], back[K:2 * K]


def gate_check_plain(back, K: int):
    """(safe, extrema (8,)) in plain PyTorch."""
    ext = []
    safe = None
    for f, (lo, hi) in zip(_variables(back, K), GATE_BOUNDS):
        fmin, fmax = f.amin(), f.amax()
        ok = (fmin >= lo) & (fmax <= hi)
        safe = ok if safe is None else safe & ok
        ext += [fmin, fmax]
    return safe, torch.stack(ext)


def gate_check(back, K: int):
    """back: (4K, lat, lon), K6's output [t, q, u, v].  Returns (safe, a
    0-d bool tensor; the extrema (8,) of u, v, t, q)."""
    dev = back.device
    if dev.type == "cpu":
        return gate_check_plain(back, K)
    if dev.type != "cuda":
        raise ValueError(f"gate_check: no kernel for device {dev}")
    dt = back.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"gate_check: dtype {dt}, the kernel takes float32 "
                        "or float64")
    if back.dim() != 3 or back.shape[0] != 4 * K:
        raise ValueError(f"gate_check: back {tuple(back.shape)}, expected "
                         f"(4K = {4 * K}, lat, lon)")
    kb.require(back, "back", dt, back.shape, dev)
    G = back.shape[1] * back.shape[2]
    bounds = (ctypes.c_double * 8)(*[b for lh in GATE_BOUNDS for b in lh])
    ext = torch.empty(8, dtype=dt, device=dev)
    safe = torch.empty((), dtype=torch.bool, device=dev)
    code = kb.library().gate_check_launch(
        kb.device_index(back), int(dt == torch.float64), K, G,
        back.data_ptr(), bounds, ext.data_ptr(), safe.data_ptr(),
        kb.stream_of(back))
    kb.check(code, "gate_check")
    gate_check.launches += 1
    return safe, ext


gate_check.launches = 0

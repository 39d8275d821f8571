"""K20: the SPEEDY window's exit (csrc/window_select.cu) and its plain
version.

The JAX package's speedy_window ends by stacking the grid fields of
leapfrog level 0 as (t, u, v, q) and logp (hybrid/model.py:466-474), and
its cycle keeps the injected fields where the gate tripped (:632-639; the
port's cycle selects rather than branches).  The port takes the grid
fields from K6's synthesis of K15's physics stack at level 0, out (5K +
1, lat, lon) = [t, q, phi (K each), logp | u, v (K each)]; one launch
writes atmo (4, K, lat, lon) and logp and, given the previous state's
flag `prev` and the gate's `safe`, ok = prev & safe with
  atmo = where(ok, window atmo, injected atmo), the same for logp,
and the flag ok.

On a CPU tensor `window_select` runs `window_select_plain`; on a CUDA
tensor it launches the kernel (float32 or float64) or raises.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.kernels import build as kb


def window_select_plain(out, K: int, select=None):
    """(atmo, logp, ok or None) in plain PyTorch."""
    t, q, logp = out[:K], out[K:2 * K], out[3 * K]
    u, v = out[3 * K + 1:4 * K + 1], out[4 * K + 1:]
    atmo = torch.stack([t, u, v, q])
    if select is None:
        return atmo, logp, None
    prev, safe, atmo_in, logp_in = select
    ok = prev & safe
    return torch.where(ok, atmo, atmo_in), torch.where(ok, logp, logp_in), ok


def window_select(out, K: int, select=None):
    """out: (5K + 1, lat, lon), the synthesis of the physics stack.
    select: None, or (prev, safe, atmo_in, logp_in) with prev and safe 0-d
    bool tensors and the injected atmo_in (4, K, lat, lon), logp_in (lat,
    lon).  Returns (atmo (4, K, lat, lon), logp (lat, lon), ok: the 0-d
    flag, or None without a select)."""
    dev = out.device
    if dev.type == "cpu":
        return window_select_plain(out, K, select)
    if dev.type != "cuda":
        raise ValueError(f"window_select: no kernel for device {dev}")
    dt = out.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"window_select: dtype {dt}, the kernel takes "
                        "float32 or float64")
    if out.dim() != 3 or out.shape[0] != 5 * K + 1:
        raise ValueError(f"window_select: out {tuple(out.shape)}, expected "
                         f"(5K + 1 = {5 * K + 1}, lat, lon)")
    grid = tuple(out.shape[1:])
    kb.require(out, "out", dt, out.shape, dev)
    atmo = torch.empty((4, K) + grid, dtype=dt, device=dev)
    logp = torch.empty(grid, dtype=dt, device=dev)
    ptrs = [None] * 5
    ok = None
    if select is not None:
        prev, safe, atmo_in, logp_in = select
        kb.require(prev, "prev", torch.bool, (), dev)
        kb.require(safe, "safe", torch.bool, (), dev)
        kb.require(atmo_in, "atmo_in", dt, (4, K) + grid, dev)
        kb.require(logp_in, "logp_in", dt, grid, dev)
        ok = torch.empty((), dtype=torch.bool, device=dev)
        ptrs = [t.data_ptr() for t in (prev, safe, atmo_in, logp_in, ok)]
    code = kb.library().window_select_launch(
        kb.device_index(out), int(dt == torch.float64), K,
        grid[0] * grid[1], out.data_ptr(), ptrs[0], ptrs[1], ptrs[2],
        ptrs[3], atmo.data_ptr(), logp.data_ptr(), ptrs[4],
        kb.stream_of(out))
    kb.check(code, "window_select")
    window_select.launches += 1
    return atmo, logp, ok


window_select.launches = 0

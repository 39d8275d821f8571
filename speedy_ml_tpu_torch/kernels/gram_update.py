"""K14: the Gram update of the ridge trainer (csrc/gram_update.cu) and
its plain version.

ss += sum_c aug_c^T aug_c and st += sum_c target_c^T aug_c, in place,
for the C collected states of a time chunk, with aug_c = [model_c ;
quad_expand(states_c)]: states (C, R, n), model (C, R, S) or None
(S = 0), target (C, R, O), ss (R, A, A), st (R, O, A), A = S + n.  The
kernel takes float32 or float64 (all operands alike).

On a CPU tensor `gram_update` runs `gram_update_plain`; on a CUDA tensor
it launches the kernels or raises: a first one writes the operands of
the chunk, aug and target, into a zero-padded panel (scratch allocated
here), the second adds the tiles' products into ss and st.  Both tile
lists give the same bits, and a symmetric ss stays exactly symmetric.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels.readout import quad_expand

# chunks of at least this many samples take the symmetric tile list (ss's
# upper triangle, mirrored: half the FLOPs); shorter ones, bound by the
# bytes of ss, the full list.  `chip_smoke.py --k14-lists` on an H100 80GB
# HBM3 at 700 W (32 regions, A = 5,892): full 4.02 ms against symmetric
# 4.64 at C = 48, full 5.04 against 4.67 at C = 64
SYM_MIN_C = 64


def augment(states: torch.Tensor, model: torch.Tensor | None = None
            ) -> torch.Tensor:
    """aug = [model ; quad_expand(states)] along the last axis."""
    sq = quad_expand(states)
    return sq if model is None else torch.cat([model, sq], dim=-1)


def gram_update_plain(ss, st, states, model, target):
    """The plain PyTorch version of the kernel (the JAX einsums)."""
    aug = augment(states, model)
    ss += torch.einsum("brm,brk->rmk", aug, aug)
    st += torch.einsum("bro,brk->rok", target, aug)
    return ss, st


def gram_update(ss, st, states, model, target):
    """Add one time chunk's normal equations to (ss, st) in place;
    returns (ss, st)."""
    return _update(ss, st, states, model, target,
                   sym=states.shape[0] >= SYM_MIN_C)


def _update(ss, st, states, model, target, sym: bool):
    """gram_update with the tile list given: sym, ss's upper triangle
    mirrored; else all of ss's tiles."""
    if states.device.type == "cpu":
        return gram_update_plain(ss, st, states, model, target)
    if states.device.type != "cuda":
        raise ValueError(f"gram_update: no kernel for device {states.device}")
    dt = states.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"gram_update: dtype {dt}, the kernel takes float32 "
                        "or float64")
    C, R, n = states.shape
    S = 0 if model is None else model.shape[2]
    O = target.shape[2]
    A = S + n
    if R > 65535:
        raise ValueError(f"gram_update: R={R} regions, the grid takes at "
                         "most 65535")
    dev = states.device
    kb.require(states, "states", dt, (C, R, n), dev)
    if model is not None:
        kb.require(model, "model", dt, (C, R, S), dev)
    kb.require(target, "target", dt, (C, R, O), dev)
    kb.require(ss, "ss", dt, (R, A, A), dev)
    kb.require(st, "st", dt, (R, O, A), dev)
    lib = kb.library()
    is_double = int(dt == torch.float64)
    # the operands of every tile, zero-padded to whole tiles
    panel = torch.empty(lib.gram_panel_size(is_double, int(sym), C, R, n, S,
                                            O),
                        dtype=dt, device=dev)
    code = lib.gram_update_launch(
        kb.device_index(states), is_double, states.data_ptr(),
        None if model is None else model.data_ptr(), target.data_ptr(),
        C, R, n, S, O, ss.data_ptr(), st.data_ptr(), panel.data_ptr(),
        int(sym), kb.stream_of(states))
    kb.check(code, "gram_update")
    gram_update.launches += 2   # the panel kernel and the tile kernel
    return ss, st


gram_update.launches = 0

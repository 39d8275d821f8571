"""K14: the Gram update of the ridge trainer (csrc/gram_update.cu) and
its plain version.

ss += sum_c aug_c^T aug_c and st += sum_c target_c^T aug_c, in place,
for the C collected states of a time chunk, with aug_c = [model_c ;
quad_expand(states_c)]: states (C, R, n), model (C, R, S) or None
(S = 0), target (C, R, O), ss (R, A, A), st (R, O, A), A = S + n.  The
kernel takes float32 or float64 (all operands alike).

On a CPU tensor `gram_update` runs `gram_update_plain`; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels.readout import quad_expand


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
    code = kb.library().gram_update_launch(
        kb.device_index(states), int(dt == torch.float64), states.data_ptr(),
        None if model is None else model.data_ptr(), target.data_ptr(),
        C, R, n, S, O, ss.data_ptr(), st.data_ptr(), kb.stream_of(states))
    kb.check(code, "gram_update")
    gram_update.launches += 1
    return ss, st


gram_update.launches = 0

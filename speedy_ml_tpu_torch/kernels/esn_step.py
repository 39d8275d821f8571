"""K1: the ESN step kernel (csrc/esn_step.cu) and its plain version.

y = tanh(A x + Win u), with the leakage (1-l) x + l y when l != 1, for a
class of R regions; A is ELL, slot-major vals (J, R, n), its columns
given by a shift table (J,) (the main path), shared cols (n, J) or
per-region cols (R, n, J).  `linear=True` computes y = A x alone (the
power iteration of spectral_radius).

On a CPU tensor `esn_step` runs `esn_step_plain`; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from speedy_ml_tpu_torch.kernels import build as kb

MAX_SLOTS = 32   # MAX_SHIFTS of csrc/esn_step.cu: ELL slots J per row


def ell_spmv(vals: torch.Tensor, cols: torch.Tensor, x: torch.Tensor
             ) -> torch.Tensor:
    """y = A x for batched ELL A; vals (J, R, n), x (R, n) -> (R, n).

    cols (n, J): one sparsity graph shared by all regions; cols (R, n, J):
    an independent graph per region (weights imported from the
    reference)."""
    J = cols.shape[-1]
    y = None
    for j in range(J):
        if cols.ndim == 2:
            g = x[:, cols[:, j].long()]
        else:
            g = torch.gather(x, 1, cols[:, :, j].long())
        y = vals[j] * g if y is None else y + vals[j] * g
    return y


def ell_spmv_shift(vals: torch.Tensor, shifts: tuple, x: torch.Tensor
                   ) -> torch.Tensor:
    """y = A x for shift-structured A: y[r,i] = sum_j vals[j,r,i] *
    x[r, (i+s_j) mod n] (torch.roll(x, -s) reads x[(i+s) mod n])."""
    y = vals[0] * torch.roll(x, -int(shifts[0]), dims=1)
    for j in range(1, len(shifts)):
        y = y + vals[j] * torch.roll(x, -int(shifts[j]), dims=1)
    return y


def win_apply(win_vals: torch.Tensor, u: torch.Tensor, n_in: int,
              win_cols: torch.Tensor | None = None) -> torch.Tensor:
    """Win @ u for the block-diagonal Win: row i couples input i // q
    (q = n // n_in, the last input repeated over any leftover rows), or
    input win_cols[r, i] for ragged imported reservoirs."""
    n = win_vals.shape[1]
    if win_cols is not None:
        return win_vals * torch.gather(u, 1, win_cols.long())
    q = n // n_in
    k = torch.clamp(torch.arange(n, device=u.device) // q, max=n_in - 1)
    return win_vals * u[:, k]


def esn_step_plain(vals, x, u=None, win_vals=None, *, shifts=None, cols=None,
                   win_cols=None, leakage: float = 1.0,
                   linear: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same operation order as
    the JAX esn_step)."""
    if shifts is not None:
        y = ell_spmv_shift(vals, shifts, x)
    else:
        y = ell_spmv(vals, cols, x)
    if linear:
        return y
    y = y + win_apply(win_vals, u, u.shape[1], win_cols)
    xt = torch.tanh(y)
    if leakage == 1.0:
        return xt
    return (1.0 - leakage) * x + leakage * xt


def esn_step(vals, x, u=None, win_vals=None, *, shifts=None, cols=None,
             win_cols=None, leakage: float = 1.0,
             linear: bool = False) -> torch.Tensor:
    """One ESN step (or y = A x with linear=True) for a class.

    vals (J, R, n), x (R, n), u (R, I), win_vals (R, n); exactly one of
    shifts (tuple of J ints) and cols (int32 (n, J) or (R, n, J))."""
    if (shifts is None) == (cols is None):
        raise ValueError("esn_step: pass exactly one of shifts and cols")
    if not linear and (u is None or win_vals is None):
        raise ValueError("esn_step: u and win_vals are required unless "
                         "linear=True")
    if x.device.type == "cpu":
        return esn_step_plain(vals, x, u, win_vals, shifts=shifts, cols=cols,
                              win_cols=win_cols, leakage=leakage,
                              linear=linear)
    if x.device.type != "cuda":
        raise ValueError(f"esn_step: no kernel for device {x.device}")
    J, R, n = vals.shape
    if J > MAX_SLOTS:
        raise ValueError(f"esn_step: J={J} slots, kernel takes at most "
                         f"{MAX_SLOTS}")
    dev = x.device
    f32 = torch.float32
    kb.require(vals, "vals", f32, (J, R, n), dev)
    kb.require(x, "x", f32, (R, n), dev)
    I = 0
    if not linear:
        I = u.shape[1]
        kb.require(u, "u", f32, (R, I), dev)
        kb.require(win_vals, "win_vals", f32, (R, n), dev)
        if win_cols is not None:
            kb.require(win_cols, "win_cols", torch.int32, (R, n), dev)
    shift_arr = None
    if shifts is not None:
        if len(shifts) != J:
            raise ValueError(f"esn_step: {len(shifts)} shifts for J={J}")
        mode = 0
        shift_arr = (ctypes.c_int * J)(*[int(s) % n for s in shifts])
    elif cols.ndim == 2:
        mode = 1
        kb.require(cols, "cols", torch.int32, (n, J), dev)
    else:
        mode = 2
        kb.require(cols, "cols", torch.int32, (R, n, J), dev)
    y = torch.empty((R, n), dtype=f32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    code = kb.library().esn_step_launch(
        kb.device_index(x), mode, int(linear), vals.data_ptr(), x.data_ptr(),
        None if linear else win_vals.data_ptr(),
        None if linear else u.data_ptr(),
        ptr(cols), None if linear else ptr(win_cols), shift_arr, J, R, n, I,
        float(leakage), float(1.0 - leakage), y.data_ptr(), kb.stream_of(x))
    kb.check(code, "esn_step")
    esn_step.launches += 1
    esn_step.mode_launches[mode] += 1
    return y


esn_step.launches = 0
# the launches by mode: 0 shared shifts, 1 shared cols (n, J), 2 per-region
# cols (R, n, J) (reference-imported reservoirs)
esn_step.mode_launches = [0, 0, 0]

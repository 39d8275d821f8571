"""Batched ESN ridge-regression training via normal equations.

Reference: mod_reservoir.f90 (reservoir_layer_chunking_*,
chunking_matmul, fit_chunk_*, initialize_chunk_training), as the JAX
package's esn/train.py ports it.  The per-sample ESN step runs on K1
(kernels/esn_step.py) and the per-batch Gram update ss += aug^T aug,
st += target^T aug on K14 (kernels/gram_update.py), which builds
aug = [local_model ; quad_expand(states)] as it loads its tiles.

All tensors carry a leading region axis R.  Time-major inputs:
  train_in:  (T, R, I)  standardized input series (with halos)
  target:    (T, R, O)  standardized target series (region core), SAME
                        time indexing as train_in
  model_in:  (T, R, S)  imperfect-model (SPEEDY) forecast series, or None

Alignment (chunking_matmul, mod_reservoir.f90:1643-1699): the state that
has absorbed inputs up to index t-1 is paired with target[t].  The first
state (x0 from the discard segment) pairs with target[0].

Noise: where the JAX package draws Gaussian noise from PRNG keys, the
caller hands the draw in.  apply_noise takes the draw g; the loops take
`noise`, a function of the series index t returning the (R, I) draw for
sample t (None: no noise).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from speedy_ml_tpu_torch.esn.reservoir import (BatchedReservoir, ESNHyper,
                                               esn_step)
from speedy_ml_tpu_torch.kernels.gram_update import gram_update

Noise = Optional[Callable[[int], torch.Tensor]]


class NormalEq(NamedTuple):
    """Accumulated normal equations per region."""
    ss: torch.Tensor    # (R, S+n, S+n)  aug . aug^T
    st: torch.Tensor    # (R, O, S+n)    target . aug^T


def find_closest_divisor(target: int, total: int) -> int:
    """Closest divisor of `total` to `target` (mod_utilities.f90:1591-1629)."""
    best, bestd = 1, abs(target - 1)
    for d in range(1, total + 1):
        if total % d == 0 and abs(target - d) < bestd:
            best, bestd = d, abs(target - d)
    return best


def apply_noise(g: torch.Tensor, u: torch.Tensor, noise_mag: float,
                precip_slice: Optional[tuple] = None,
                precip_mean: Optional[torch.Tensor] = None,
                precip_std: Optional[torch.Tensor] = None,
                precip_eps: float = 0.001) -> torch.Tensor:
    """Multiplicative gaussian training noise (mod_utilities.f90:1380-1457).

    u (..., R, I) and the standard normal draw g of the same shape.  For
    the precip block [p0, p1) the noise is additive in physical precip
    space with the log(1+P/eps) transform round-tripped."""
    noisy = u + g * noise_mag * u
    if precip_slice is None:
        return noisy
    p0, p1 = precip_slice
    temp = u[..., p0:p1] * precip_std + precip_mean
    temp = precip_eps * (torch.exp(temp) - 1.0)
    temp = temp + g[..., p0:p1] * noise_mag
    temp = torch.abs(temp)
    temp = torch.log(1.0 + temp / precip_eps)
    temp = (temp - precip_mean) / precip_std
    return torch.cat([noisy[..., :p0], temp, noisy[..., p1:]], dim=-1)


def apply_noise_keys(g: torch.Tensor, u: torch.Tensor, noise_mag: float,
                     precip_slice: Optional[tuple] = None,
                     precip_mean: Optional[torch.Tensor] = None,
                     precip_std: Optional[torch.Tensor] = None,
                     precip_eps: float = 0.001) -> torch.Tensor:
    """apply_noise with a draw made per region (each row of g drawn on its
    own, as the production trainer draws it so that the draw of a
    (sample, region) does not depend on the chunking); the arithmetic is
    apply_noise's."""
    return apply_noise(g, u, noise_mag, precip_slice, precip_mean,
                       precip_std, precip_eps)


def noisy_series(train_in: torch.Tensor, t0: int, noise: Noise,
                 hyper: ESNHyper, precip_info: Optional[dict] = None
                 ) -> torch.Tensor:
    """train_in (C, R, I) with the training noise of series indices
    t0..t0+C-1 applied (unchanged when noise is None)."""
    if noise is None:
        return train_in
    g = torch.stack([noise(t0 + c) for c in range(train_in.shape[0])])
    if precip_info is None:
        return apply_noise(g, train_in, hyper.noise_mag)
    return apply_noise(g, train_in, hyper.noise_mag,
                       precip_slice=precip_info["slice"],
                       precip_mean=precip_info["mean"],
                       precip_std=precip_info["std"],
                       precip_eps=precip_info["eps"])


def advance(res: BatchedReservoir, hyper: ESNHyper, x: torch.Tensor,
            z: torch.Tensor) -> torch.Tensor:
    """Step the reservoir through the inputs z (C, R, I)."""
    for u in z:
        x = esn_step(res, x, u, hyper.leakage)
    return x


def accumulate_chunk(res: BatchedReservoir, hyper: ESNHyper,
                     x: torch.Tensor, eq: NormalEq, z: torch.Tensor,
                     target: torch.Tensor,
                     model: Optional[torch.Tensor]) -> torch.Tensor:
    """Pair states with targets over a chunk of C samples, in place in eq
    (chunking_matmul, mod_reservoir.f90:1592-1699): the states are x and
    the C - 1 steps on z[:-1], so state c (inputs absorbed up to c - 1)
    pairs with target[c]; one K14 launch.  Returns the state after
    z[-1], the first state of the next chunk."""
    states = [x]
    for u in z[:-1]:
        x = esn_step(res, x, u, hyper.leakage)
        states.append(x)
    gram_update(eq.ss, eq.st, torch.stack(states),
                None if model is None else model.contiguous(),
                target.contiguous())
    return esn_step(res, x, z[-1], hyper.leakage)


def zero_equations(R: int, A: int, O: int, dtype, device) -> NormalEq:
    return NormalEq(ss=torch.zeros((R, A, A), dtype=dtype, device=device),
                    st=torch.zeros((R, O, A), dtype=dtype, device=device))


def accumulate_batches(res: BatchedReservoir, hyper: ESNHyper,
                       train_in: torch.Tensor, target: torch.Tensor,
                       model_in: Optional[torch.Tensor],
                       x0: torch.Tensor, batch_size: int,
                       noise: Noise = None,
                       precip_info: Optional[dict] = None):
    """Run the ESN over the series and accumulate normal equations.

    Processes floor((T-1)/batch_size) complete batches like the reference
    (the tail beyond the last complete batch is dropped,
    reservoir_layer_chunking_hybrid:1113-1170), each an accumulate_chunk.

    Returns (NormalEq, x_final)."""
    T, R, _ = train_in.shape
    S = 0 if model_in is None else model_in.shape[2]
    eq = zero_equations(R, S + res.n, target.shape[2], train_in.dtype,
                        train_in.device)
    x = x0
    for b in range((T - 1) // batch_size):
        sl = slice(b * batch_size, (b + 1) * batch_size)
        z = noisy_series(train_in[sl], sl.start, noise, hyper, precip_info)
        x = accumulate_chunk(res, hyper, x, eq, z, target[sl],
                             None if model_in is None else model_in[sl])
    return eq, x


def discard_transient(res: BatchedReservoir, hyper: ESNHyper,
                      train_in: torch.Tensor, noise: Noise = None,
                      precip_info: Optional[dict] = None) -> torch.Tensor:
    """Spin up from zero state through the discard segment (T, R, I)."""
    x = torch.zeros((train_in.shape[1], res.n), dtype=train_in.dtype,
                    device=train_in.device)
    return advance(res, hyper, x,
                   noisy_series(train_in, 0, noise, hyper, precip_info))


def solve_wout(eq: NormalEq, hyper: ESNHyper, n_speedy: int,
               solve_dtype=None) -> torch.Tensor:
    """Ridge solve for Wout (fit_chunk_hybrid, mod_reservoir.f90:1233-1332).

    Regularization: beta_model^2 on the SPEEDY block diagonal, beta_res^2
    on the reservoir block (squared when using_prior, as the reference
    config sets it); the prior adds prior_val*beta_model^2 to the RHS
    diagonal of the SPEEDY block.  solve_dtype (default: the Gram's) is
    the precision of the solve: each region is cast to it BEFORE the ridge
    is added (a 1e-6 ridge rounds away against O(1e3) f32 diagonals).
    Jacobi scaling, then a pivoted LU (torch.linalg.solve), not Cholesky:
    the scaled f32-accumulated Gram can be slightly indefinite.  One
    region at a time: for a batch of large matrices PyTorch's CUDA solve
    takes MAGMA's batched LU, which is built for small sizes; a single
    matrix goes to cuSOLVER.  Memory: two (A, A) copies in the solve
    dtype.  Returns Wout (R, O, A) in the Gram's dtype."""
    R, A, _ = eq.ss.shape
    O = eq.st.shape[1]
    out_dtype = eq.ss.dtype
    work = out_dtype if solve_dtype is None else solve_dtype
    if hyper.using_prior:
        bm, br = hyper.beta_model ** 2, hyper.beta_res ** 2
    else:
        bm, br = hyper.beta_model, hyper.beta_res
    dev = eq.ss.device
    ridge = torch.full((A,), br, dtype=work, device=dev)
    ridge[:n_speedy] = bm
    pv = (hyper.prior_val * hyper.beta_model ** 2
          if hyper.using_prior and n_speedy > 0 else 0.0)
    wout = torch.empty((R, O, A), dtype=out_dtype, device=dev)
    for r in range(R):
        ssr = eq.ss[r].to(work, copy=True)
        str_ = eq.st[r].to(work, copy=True)
        ssr.diagonal().add_(ridge)
        if pv != 0.0:
            k = min(n_speedy, O)
            str_.diagonal()[:k].add_(pv)
        # Jacobi preconditioning (unit diagonal) stabilizes without
        # changing the solution
        d = torch.sqrt(torch.clamp(ssr.diagonal(), min=1e-30))
        ssr.div_(d[:, None]).div_(d[None, :])
        z = torch.linalg.solve(ssr, (str_ / d[None, :]).T)
        del ssr
        wout[r] = (z / d[:, None]).T
    return wout


def solve_wout_sharded(eq: NormalEq, hyper: ESNHyper, n_speedy: int,
                       mesh, axis: str = "regions", solve_dtype=None):
    """solve_wout with the region axis sharded over `mesh`
    (parallel/mesh.py): each device solves its own regions' normal
    equations, region by region as solve_wout does, with no exchange
    between devices.  eq: ss and st Sharded by rows (each device's
    regions, where the sharded accumulation left them), or whole tensors,
    which are split first.  Returns Wout as a Sharded (Rloc, O, A) a
    device."""
    from speedy_ml_tpu_torch.parallel.mesh import Sharded, shard_rows
    if axis != mesh.axis:
        raise ValueError(f"solve_wout_sharded: the mesh's axis is "
                         f"{mesh.axis!r}, not {axis!r}")
    ss, st = (t if isinstance(t, tuple) else shard_rows(t, mesh)
              for t in (eq.ss, eq.st))
    if len(ss) != mesh.size or len(st) != mesh.size:
        raise ValueError(f"solve_wout_sharded: {len(ss)} and {len(st)} "
                         f"shards for a mesh of {mesh.size}")
    return Sharded(solve_wout(NormalEq(a, b), hyper, n_speedy, solve_dtype)
                   for a, b in zip(ss, st))


def train_subseries(res: BatchedReservoir, hyper: ESNHyper,
                    series_in: torch.Tensor, series_target: torch.Tensor,
                    series_model: Optional[torch.Tensor],
                    n_discard: int, batch_size: int,
                    noise: Noise = None, precip_info=None
                    ) -> tuple[NormalEq, torch.Tensor]:
    """One strided sub-series pass: discard + batched accumulation.
    noise(t) is indexed by the position t in the whole sub-series."""
    x0 = discard_transient(res, hyper, series_in[:n_discard], noise=noise,
                           precip_info=precip_info)
    acc_noise = None if noise is None else (lambda t: noise(n_discard + t))
    return accumulate_batches(
        res, hyper, series_in[n_discard:], series_target[n_discard:],
        None if series_model is None else series_model[n_discard:],
        x0, batch_size, noise=acc_noise, precip_info=precip_info)


def pinv_svd(a: torch.Tensor, thres: float = 1e-2) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse via SVD with a hard singular-value
    threshold (pinv_svd, mod_linalg.f90:27-100): singular values <= thres
    are zeroed outright (not clipped).  Batched over leading axes; unused
    in the production solve, kept for API parity."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    keep = s > thres
    sinv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                       torch.zeros_like(s))
    return torch.einsum("...ij,...j,...kj->...ik", vt.transpose(-1, -2),
                        sinv, u)

"""Batched echo-state networks.

Reference: mod_reservoir.f90 (gen_res/makesparse, reservoir_layer,
synchronize, predict).  As in the JAX package, all regions of a class
live in one batched tensor with a leading region axis R; the sparse
adjacency is ELL with near-uniform row degree (slot-major vals (J, R, n));
the spectral radius comes from a batched power iteration.

The step (esn_step) and the readout (readout) run on the hand-written
kernels of kernels/esn_step.py (K1) and kernels/readout.py (K2); their
plain versions (ell_spmv, ell_spmv_shift, quad_expand, ...) live beside
the kernels and are re-exported here.

Randomness: the structure (shifts, the leftover mask, the "random"
topologies) is drawn host-side with numpy's Philox from an integer seed,
exactly as the JAX package draws it; the values come from a
torch.Generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.kernels import esn_step as k_step
from speedy_ml_tpu_torch.kernels import readout as k_readout
from speedy_ml_tpu_torch.kernels.esn_step import (ell_spmv,  # noqa: F401
                                                  ell_spmv_shift)
from speedy_ml_tpu_torch.kernels.readout import quad_expand  # noqa: F401


@dataclasses.dataclass(frozen=True)
class BatchedReservoir:
    """Per-region reservoir weights, batched over the leading region axis R.

    Shapes (R regions, n nodes, J nnz/row, I inputs, O outputs, S speedy):
      cols: (n, J) or (R, n, J) int32  ELL column indices of A
      vals: (J, R, n)         ELL values of A (scaled to spectral radius)
      win_vals: (R, n)        input coupling values.  Win is block-diagonal
                              (the reference fills rows (i-1)q+1..iq of
                              column i, mod_reservoir.f90:270-278), so one
                              value per row suffices; the implicit column
                              of row j is j // (n/I).
      wout: (R, O, S + n)     readout on [local_model ; x-with-odd-squared]
      mean: (R, I)            standardization mean per input element
      std:  (R, I)
      n_in: input count (needed to derive the Win block map)
      shifts: shift topology cols[i, j] = (i + s_j) mod n for J shifts
              shared across regions (the default); None -> cols.
      win_cols: (R, n) int32 per-row input map for ragged imported
              reservoirs; None -> the uniform block map.
    """
    cols: torch.Tensor
    vals: torch.Tensor
    win_vals: torch.Tensor
    wout: torch.Tensor
    mean: torch.Tensor
    std: torch.Tensor
    n_in: int = 0
    shifts: tuple | None = None
    win_cols: torch.Tensor | None = None

    @property
    def n(self):
        return self.win_vals.shape[1]

    @property
    def n_inputs(self):
        return self.n_in

    @property
    def n_outputs(self):
        return self.wout.shape[1]

    @property
    def n_speedy(self):
        return self.wout.shape[2] - self.win_vals.shape[1]

    def win_apply(self, u: torch.Tensor) -> torch.Tensor:
        """Win @ u for the block-diagonal Win. u (R, I) -> (R, n)."""
        return k_step.win_apply(self.win_vals, u, self.n_in, self.win_cols)


@dataclasses.dataclass(frozen=True)
class ESNHyper:
    """Static hyperparameters (mod_reservoir.f90:89-101)."""
    m: int = 6000              # target reservoir size
    deg: int = 6               # average degree of A
    sigma: float = 0.5         # input coupling scale
    leakage: float = 1.0
    beta_res: float = 0.001
    beta_model: float = 1.0
    prior_val: float = 0.0
    noise_mag: float = 0.2
    using_prior: bool = True

    def nodes(self, n_inputs: int) -> int:
        npi = int(round(self.m / n_inputs))
        return npi * n_inputs

    def nnz(self, n: int) -> int:
        return int(self.deg / self.m * n * n)


def radius_by_lat(lat_start: np.ndarray, lat_end: np.ndarray) -> np.ndarray:
    """Spectral radius by latitude band (res_domain.f90:1601-1638).

    Reproduces the reference behavior exactly: max_radius above 45 deg,
    otherwise the constant (max-min)/45 + min (the reference formula has
    no latitude factor; its trained weights saw these values)."""
    highest, rmax, rmin = 45.0, 0.7, 0.3
    smallest = np.minimum(np.abs(lat_start), np.abs(lat_end))
    return np.where(smallest >= highest, rmax, (rmax - rmin) / highest + rmin)


# ----------------------------------------------------------------------
# generation
# ----------------------------------------------------------------------

def _ell_from_perms(rng: np.random.Generator, n: int, k: int, J: int):
    """ELL (cols, mask) replicating makesparse's permutation draws (numpy).

    rows and cols are each concatenations of random permutations of 0..n-1
    (plus a partial one); grouping by row index gives degree
    {k//n, k//n+1}.  Returns cols (n, J) int32 and mask (n, J) float32."""
    counter = k // n
    leftover = k - counter * n
    rows = np.concatenate(
        [rng.permutation(n) for _ in range(counter)]
        + ([rng.permutation(n)[:leftover]] if leftover else []))
    colv = np.concatenate(
        [rng.permutation(n) for _ in range(counter)]
        + ([rng.permutation(n)[:leftover]] if leftover else []))
    slot = np.concatenate(
        [np.full(n, i, dtype=np.int32) for i in range(counter)]
        + ([np.full(leftover, counter, dtype=np.int32)] if leftover else []))
    cols = np.zeros((n, J), dtype=np.int32)
    mask = np.zeros((n, J), dtype=np.float32)
    cols[rows, slot] = colv
    mask[rows, slot] = 1.0
    return cols, mask


def power_iteration(vals: torch.Tensor, v: torch.Tensor, iters: int, *,
                    shifts: tuple | None = None,
                    cols: torch.Tensor | None = None) -> torch.Tensor:
    """|lambda_max| of each region's A from the start vectors v (R, n):
    `iters` steps of w = A v, lam = |w|, v = w / lam (the y = A x mode of
    the K1 kernel)."""
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    lam = torch.ones(v.shape[0], dtype=vals.dtype, device=vals.device)
    for _ in range(iters):
        w = k_step.esn_step(vals, v, shifts=shifts, cols=cols, linear=True)
        lam = torch.linalg.vector_norm(w, dim=1)
        v = w / torch.clamp_min(lam, 1e-30)[:, None]
    return lam


def spectral_radius(vals: torch.Tensor, cols, generator: torch.Generator,
                    iters: int = 200, shifts: tuple | None = None
                    ) -> torch.Tensor:
    """|lambda_max| of each region's A by batched power iteration from a
    normal start vector drawn from `generator`."""
    _, R, n = vals.shape
    v = torch.randn((R, n), generator=generator, dtype=vals.dtype,
                    device=vals.device)
    return power_iteration(vals, v, iters, shifts=shifts,
                           cols=None if shifts is not None else cols)


def generate(seed: int, n_regions: int, n_inputs: int, hyper: ESNHyper,
             radius, dtype=torch.float32, radius_iters: int = 200,
             shared_pattern: bool = True, topology: str = "shift",
             device=None):
    """Random A (ELL) + Win for all regions (gen_res + the Win fill of
    train_reservoir, mod_reservoir.f90:180-281).

    seed: integer seed.  The structure draws use numpy Philox key
    [seed, n_regions] ("shift", shared "random") or [seed, r] (per-region
    "random"), as in the JAX package; the values use a torch.Generator on
    `device` seeded with `seed`.
    radius: per-region spectral radius (R,) or scalar.
    topology: "shift" (cols[i,j] = (i + s_j) mod n for J random distinct
    shifts shared across regions, values random per region) or "random"
    (the reference's permutation-draw graph; shared_pattern selects one
    shared graph vs independent graphs per region).
    Returns (cols, vals, win, shifts); vals is slot-major (J, R, n);
    shifts is a tuple for "shift" and None for "random"."""
    device = resolve_device(device)
    n = hyper.nodes(n_inputs)
    k = hyper.nnz(n)
    J = k // n + (1 if k % n else 0)
    radius = torch.broadcast_to(
        torch.as_tensor(np.asarray(radius), dtype=dtype, device=device),
        (n_regions,))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    struct_key = [int(seed), n_regions]
    shifts = None
    if topology == "shift":
        rng = np.random.Generator(np.random.Philox(key=struct_key))
        shifts = tuple(int(s) for s in rng.choice(n, size=J, replace=False))
        cols = torch.as_tensor(
            (np.arange(n)[:, None] + np.asarray(shifts)[None, :]) % n,
            dtype=torch.int32, device=device)
        # keep nnz = k exactly: the last slot is only `leftover` rows deep
        leftover = k - (k // n) * n
        mask = np.ones((n, J), dtype=np.float32)
        if leftover:
            off = rng.permutation(n)[leftover:]
            mask[off, J - 1] = 0.0
        vals = torch.rand((J, n_regions, n), generator=gen, dtype=dtype,
                          device=device)
        vals *= torch.as_tensor(mask.T[:, None, :], dtype=dtype,
                                device=device)
    elif shared_pattern:
        rng = np.random.Generator(np.random.Philox(key=struct_key))
        c, m = _ell_from_perms(rng, n, k, J)
        cols = torch.as_tensor(c, device=device)
        vals_np = np.zeros((n_regions, n, J), dtype=np.float64)
        for r in range(n_regions):
            rr = np.random.Generator(np.random.Philox(key=[int(seed), r]))
            vals_np[r] = rr.uniform(size=(n, J)) * m
        vals = torch.as_tensor(vals_np.transpose(2, 0, 1).copy(),
                               dtype=dtype, device=device)
    else:
        cols_np = np.zeros((n_regions, n, J), dtype=np.int32)
        vals_np = np.zeros((n_regions, n, J), dtype=np.float64)
        for r in range(n_regions):
            rng = np.random.Generator(np.random.Philox(key=[int(seed), r]))
            c, m = _ell_from_perms(rng, n, k, J)
            cols_np[r] = c
            vals_np[r] = rng.uniform(size=(n, J)) * m
        cols = torch.as_tensor(cols_np, device=device)
        vals = torch.as_tensor(vals_np.transpose(2, 0, 1).copy(),
                               dtype=dtype, device=device)
    lam = spectral_radius(vals, cols, gen, iters=radius_iters, shifts=shifts)
    vals = vals / lam[None, :, None] * radius[None, :, None]

    # Win: block-diagonal, q = n/n_inputs rows per input, +-sigma uniform;
    # stored as one value per row (see BatchedReservoir.win_vals)
    win_vals = (torch.rand((n_regions, n), generator=gen, dtype=dtype,
                           device=device) * 2.0 - 1.0) * hyper.sigma
    return cols, vals, win_vals, shifts


# ----------------------------------------------------------------------
# dynamics
# ----------------------------------------------------------------------

def esn_step(res: BatchedReservoir, x: torch.Tensor, u: torch.Tensor,
             leakage: float = 1.0) -> torch.Tensor:
    """x' = (1-l) x + l tanh(A x + Win u); x (R, n), u (R, I)."""
    return k_step.esn_step(
        res.vals, x, u, res.win_vals, shifts=res.shifts,
        cols=None if res.shifts is not None else res.cols,
        win_cols=res.win_cols, leakage=leakage)


def readout(res: BatchedReservoir, x: torch.Tensor,
            local_model: torch.Tensor | None = None) -> torch.Tensor:
    """outvec = Wout [local_model ; x~]  (predict / predict_ml).

    Wout may be bfloat16 (cast_wout_bf16): aug is then rounded to bf16
    and the sum kept in f32, as in the JAX readout."""
    return k_readout.readout(res.wout, x, local_model)


def synchronize(res: BatchedReservoir, x: torch.Tensor, inputs: torch.Tensor,
                leakage: float = 1.0) -> torch.Tensor:
    """Drive the ESN through inputs (T, R, I) without readout."""
    for u in inputs:
        x = esn_step(res, x, u, leakage)
    return x

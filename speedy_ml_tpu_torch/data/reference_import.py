"""End-to-end import of the reference's trained per-worker weight files.

The reference distributes trained weights (Zenodo 10.5281/zenodo.7548902)
as one NetCDF file per (region, level): `worker_NNNN_level_L_<trial>.nc`
holding win, wout, rows/cols/vals (COO of A), mean, std
(write_trained_res, mod_reservoir.f90:1701-1738; read back
mod_io.f90:2911-2957).  This module assembles 1,152 such files into this
framework's batched ClassPacks + per-region Standardizers so a hybrid
forecast can run directly from reference-trained weights
(parallelmain.f90:142-199).

Format facts (all verified against the reference source):
- win is (n, I) block-diagonal: rows (i-1)q+1..iq couple input i
  (train_reservoir, mod_reservoir.f90:260-281);
- wout is (O=136, S+n) with the SPEEDY block FIRST: outvec = wout @
  [local_model(S=132); x-with-even-squared(n)] (predict,
  mod_reservoir.f90:1446-1453; allocate_res_new:153-171);
- rows/cols are 1-based Fortran COO indices;
- mean/std are per-component scalars ordered [4 vars x nz (z fastest),
  logp, TISR, precip, SST] — note TISR precedes precip/SST here, UNLIKE
  the packed-vector block order (trained_reservoir_prediction,
  mod_reservoir.f90:1819-1845);
- the input VECTOR order is [atmo3d, logp, precip, sst, tisr]
  (grid%*_start offsets, mod_reservoir.f90:1850-1884);
- land regions have NO SST input (sst_bool_input=.False. when the SST
  std <= 0.2, mod_reservoir.f90:1836-1844), so I and n = q*I vary per
  region ("ragged"): sea regions I=576, n=5760, q=10; land I=560,
  n=6160, q=11 at production.

Assembly: regions of a class are padded to (n_max, J_max); padded
reservoir rows have zero A values and zero Win values, so their state is
identically zero (tanh(0)) and contributes nothing through the
(zero-padded) Wout columns — the batched program is exactly equivalent
to the ragged per-region programs.  Win becomes an explicit per-row
gather map (BatchedReservoir.win_cols) because q varies per region.
NetCDF4 files are HDF5: read via h5py, transposing 2-D variables from
the file's C layout back to the documented Fortran orientation.

The port's counterpart of the JAX package's data/reference_import.py:
the same files and the same packs, as tensors on a device.  Each worker
is compressed as it is read (COO -> ELL, the block-diagonal Win -> one
value per row) before the next is taken: a class of 1,056 regions holds
~29 GB of dense float64 Win at production width, the packs ~1/8 of it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.data.checkpoint import coo_to_ell
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.esn.reservoir import BatchedReservoir, ESNHyper
from speedy_ml_tpu_torch.esn.standardize import (Standardizer,
                                                 component_expansion,
                                                 n_components)
from speedy_ml_tpu_torch.hybrid.model import ClassPack, HybridAtmosphere

NVAR = 4


# ----------------------------------------------------------------------
# per-worker file IO
# ----------------------------------------------------------------------

def read_reference_worker(path: str) -> dict:
    """Read one reference worker weight file (NetCDF4 via h5py).

    Returns arrays in Fortran orientation: win (n, I), wout (O, S+n),
    rows/cols/vals (k,), mean/std (C,).  NetCDF stores a Fortran array's
    first dimension fastest, i.e. transposed relative to C — 2-D
    variables are transposed back here."""
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        for k in ("win", "wout", "rows", "cols", "vals", "mean", "std"):
            if k in f:
                arr = np.asarray(f[k])
                if arr.ndim == 2:
                    arr = arr.T
                out[k] = arr
    return out


def write_reference_worker(path: str, win: np.ndarray, wout: np.ndarray,
                           rows: np.ndarray, cols: np.ndarray,
                           vals: np.ndarray, mean: np.ndarray,
                           std: np.ndarray):
    """Write a worker file in the reference's on-disk layout (HDF5 with
    netCDF-style transposed 2-D variables) — used to synthesize test
    fixtures and to export weights in a reference-compatible shape."""
    import h5py
    with h5py.File(path, "w") as f:
        f.create_dataset("win", data=np.asarray(win).T)
        f.create_dataset("wout", data=np.asarray(wout).T)
        f.create_dataset("rows", data=np.asarray(rows, dtype=np.int32))
        f.create_dataset("cols", data=np.asarray(cols, dtype=np.int32))
        f.create_dataset("vals", data=np.asarray(vals, dtype=np.float64))
        f.create_dataset("mean", data=np.asarray(mean, dtype=np.float64))
        f.create_dataset("std", data=np.asarray(std, dtype=np.float64))


def worker_path(root: str, region: int, trial: str, level: int = 1) -> str:
    """Reference naming: worker_NNNN_level_L_<trial>.nc
    (read_trained_res, mod_io.f90:2927-2933)."""
    return f"{root}/worker_{region:04d}_level_{level}_{trial}.nc"


# ----------------------------------------------------------------------
# synthesis (reference-format fixtures at true shapes)
# ----------------------------------------------------------------------

def synthesize_reference_worker(rng: np.random.Generator, nz: int,
                                core_shape: tuple, input_shape: tuple,
                                has_sst: bool, m: int = 6000, deg: int = 6,
                                comp_mean: Optional[np.ndarray] = None,
                                comp_std: Optional[np.ndarray] = None,
                                wout_scale: float = 1e-3,
                                model_identity: bool = True) -> dict:
    """Generate one worker's arrays at the reference's exact shapes.

    comp_mean/comp_std: per-component scalars in OUR order
    [atmo(4*nz), logp, precip, sst, tisr] — converted to the reference's
    on-file order [atmo, logp, tisr, precip, sst].  With model_identity
    the SPEEDY block of wout is the identity (standardized forecast
    passes straight through), which keeps an imported-weights hybrid run
    physical without real training."""
    xc, yc = core_shape
    xi, yi = input_shape
    atmo_in = NVAR * nz * xi * yi
    xy = xi * yi
    I = atmo_in + xy * (4 if has_sst else 3)
    q = int(round(m / I))
    n = q * I
    O = (NVAR * nz + 2) * xc * yc          # atmo + logp + precip
    S = (NVAR * nz + 1) * xc * yc          # atmo + logp

    win = np.zeros((n, I))
    win[np.arange(n), np.arange(n) // q] = rng.uniform(-0.5, 0.5, n)

    wout = rng.normal(0.0, wout_scale, (O, S + n))
    if model_identity:
        wout[:S, :S] = np.eye(S)

    k = int(deg / m * n * n)
    rows = rng.integers(1, n + 1, k)
    cols = rng.integers(1, n + 1, k)
    vals = rng.uniform(0.0, 1.0, k) * (0.4 / np.sqrt(k / n))

    if comp_mean is None:
        comp_mean = np.concatenate([
            np.repeat([260.0, 0.0, 0.0, 4.0], nz)
            + rng.uniform(-2, 2, NVAR * nz), [0.0, 0.5, 288.0, 200.0]])
    if comp_std is None:
        comp_std = np.concatenate([
            np.repeat([15.0, 8.0, 6.0, 3.0], nz), [0.05, 1.0, 8.0, 80.0]])
    # OUR order [atmo, logp, precip, sst, tisr] -> file order
    # [atmo, logp, tisr, precip, sst]
    a = NVAR * nz
    perm = list(range(a)) + [a, a + 3, a + 1, a + 2]
    mean_file = np.asarray(comp_mean)[perm]
    std_file = np.asarray(comp_std)[perm]
    # note: the file keeps the SST component slot even when the SST
    # INPUT is dropped (coupled production files; sst_bool_input is a
    # read-side decision, mod_reservoir.f90:1836-1844)
    return dict(win=win, wout=wout, rows=rows, cols=cols, vals=vals,
                mean=mean_file, std=std_file, n=n, I=I, q=q, O=O, S=S)


# ----------------------------------------------------------------------
# the component permutation
# ----------------------------------------------------------------------

def _file_comps_to_ours(mean: np.ndarray, std: np.ndarray, nz: int):
    """File order [atmo, logp, tisr, precip, sst?] -> our order
    [atmo, logp, precip, sst, tisr]; missing sst slot -> (0, 1)."""
    a = NVAR * nz
    C = n_components(NVAR, nz, logp=True, precip=True, sst=True, tisr=True)
    m = np.zeros(C)
    s = np.ones(C)
    m[:a], s[:a] = mean[:a], std[:a]
    m[a], s[a] = mean[a], std[a]               # logp
    m[a + 3], s[a + 3] = mean[a + 1], std[a + 1]   # tisr
    if len(mean) > a + 2:
        m[a + 1], s[a + 1] = mean[a + 2], std[a + 2]   # precip
    if len(mean) > a + 3:
        m[a + 2], s[a + 2] = mean[a + 3], std[a + 3]   # sst
    return m, s


# ----------------------------------------------------------------------
# assembly
# ----------------------------------------------------------------------

NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _compress_worker(w: dict, r: int, nz: int, cls, np_dtype) -> dict:
    """One worker's arrays in the pack's form: the ELL (cols, vals) of A,
    the per-row Win value and its input index in the padded (SST-included)
    feedback vector, Wout in np_dtype, and the component scalars in our
    order.  r labels the worker in the errors."""
    xi, yi = cls.input_shape
    xy = xi * yi
    atmo_in = NVAR * nz * xy
    n, I = w["win"].shape
    has_sst = I == atmo_in + 4 * xy
    if not has_sst and I != atmo_in + 3 * xy:
        raise ValueError(f"worker {r}: unexpected input size {I}")
    q = n // I
    if q * I != n:
        raise ValueError(f"worker {r}: n={n} not a multiple of I={I}")
    ec, ev = coo_to_ell(w["rows"], w["cols"], w["vals"], n)
    # block-diagonal Win -> per-row (value, padded input index)
    row_col = np.arange(n) // q
    wv = w["win"][np.arange(n), row_col]
    if np.count_nonzero(w["win"]) != np.count_nonzero(wv):
        raise ValueError(f"worker {r}: win is not block-diagonal")
    if has_sst:
        padded = row_col
    else:
        # the region's input vector lacks the SST block: positions at or
        # beyond the sst offset shift up by one block in the padded
        # (uniform, sst-included) feedback vector
        sst_off = atmo_in + 2 * xy
        padded = np.where(row_col < sst_off, row_col, row_col + xy)
    cm, cs = _file_comps_to_ours(w["mean"], w["std"], nz)
    return dict(n=n, S=w["wout"].shape[1] - n, ell_cols=ec, ell_vals=ev,
                win_vals=wv, win_cols=padded,
                wout=np.asarray(w["wout"], dtype=np_dtype),
                comp_mean=cm, comp_std=cs)


def assemble_reference_class(layout: RegionLayout, cls,
                             workers: Iterable[dict], nz: int,
                             hyper: Optional[ESNHyper] = None,
                             dtype=torch.float32, *, device=None
                             ) -> ClassPack:
    """Batch one class's per-worker weight dicts into a ClassPack on
    `device` (default CUDA; raises without one).

    workers: read_reference_worker dicts, one per region of the class, in
    class region order (a generator lets each dense worker go once it is
    compressed).  Handles ragged (n, I, q) by padding to class maxima
    (padded rows/cols are exactly inert: zero A values, zero Win values,
    zero Wout columns)."""
    device = resolve_device(device)
    np_dtype = NP_DTYPES[dtype]
    xi, yi = cls.input_shape
    xc, yc = cls.core_shape
    I_full = (NVAR * nz + 4) * xi * yi
    O = (NVAR * nz + 2) * xc * yc
    Rc = cls.count
    comp = [_compress_worker(w, r, nz, cls, np_dtype)
            for r, w in enumerate(workers)]
    if len(comp) != Rc:
        raise ValueError(f"{len(comp)} workers for the {Rc} regions of "
                         f"class {cls.name}")
    S = comp[0]["S"]
    if any(c["S"] != S for c in comp):
        raise ValueError("mixed SPEEDY block sizes")
    n_max = max(c["n"] for c in comp)
    J_max = max(c["ell_cols"].shape[1] for c in comp)

    cols = np.zeros((Rc, n_max, J_max), dtype=np.int32)
    vals = np.zeros((Rc, n_max, J_max), dtype=np_dtype)
    win_vals = np.zeros((Rc, n_max), dtype=np_dtype)
    win_cols = np.zeros((Rc, n_max), dtype=np.int32)
    wout = np.zeros((Rc, O, S + n_max), dtype=np_dtype)
    comp_mean = np.zeros((Rc, NVAR * nz + 4))
    comp_std = np.ones((Rc, NVAR * nz + 4))
    for r, c in enumerate(comp):
        n, J = c["n"], c["ell_cols"].shape[1]
        cols[r, :n, :J] = c["ell_cols"]
        vals[r, :n, :J] = c["ell_vals"]
        win_vals[r, :n] = c["win_vals"]
        win_cols[r, :n] = c["win_cols"]
        wout[r, :, :S] = c["wout"][:, :S]
        wout[r, :, S:S + n] = c["wout"][:, S:]
        comp_mean[r], comp_std[r] = c["comp_mean"], c["comp_std"]
    del comp

    ci = component_expansion(xi, yi, NVAR, nz, logp=True, precip=True,
                             sst=True, tisr=True)
    co = component_expansion(xc, yc, NVAR, nz, logp=True, precip=True,
                             sst=False, tisr=False)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cm = t(comp_mean).to(dtype)
    cs = t(comp_std).to(dtype)
    ci, co = t(ci), t(co)
    std = Standardizer(comp_mean=cm, comp_std=cs,
                       in_mean=cm[:, ci], in_std=cs[:, ci],
                       out_mean=cm[:, co], out_std=cs[:, co])
    res = BatchedReservoir(
        cols=t(cols), vals=t(vals.transpose(2, 0, 1)), win_vals=t(win_vals),
        wout=t(wout), mean=std.in_mean, std=std.in_std, n_in=I_full,
        win_cols=t(win_cols))
    return ClassPack(cls=cls, res=res, hyper=hyper or ESNHyper(), std=std)


def import_reference_weights(gcm, layout: RegionLayout, nz: int,
                             reader: Callable[[int], dict],
                             hyper: Optional[ESNHyper] = None,
                             dtype=torch.float32, ml_only: bool = False, *,
                             device=None) -> HybridAtmosphere:
    """Assemble a full HybridAtmosphere from per-region worker files, on
    `device` (default CUDA; raises without one).

    reader: region_id -> worker dict (e.g.
      lambda r: read_reference_worker(worker_path(root, r, trial))), called
    once per region in class order, each worker compressed before the
    next is read.  Matches the load-trained path of
    parallelmain.f90:142-199."""
    device = resolve_device(device)
    packs = [assemble_reference_class(
        layout, cls, (reader(int(r)) for r in cls.region_ids), nz,
        hyper=hyper, dtype=dtype, device=device) for cls in layout.classes]
    return HybridAtmosphere(gcm, layout, packs, ml_only=ml_only,
                            device=device)

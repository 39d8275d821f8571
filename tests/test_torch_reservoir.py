"""Port parity: the ESN layer (speedy_ml_tpu_torch.esn.reservoir and the
plain versions of the K1/K2 kernels) against speedy_ml_tpu.esn.reservoir.

Weights are made with numpy from a seed and handed to both packages.
f64 comparisons use rtol 1e-12 (same operation order on both sides;
only libm ulps differ).  bf16 readout weights are compared in f32 at
1e-5 of the output's scale, since the accumulation orders differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.esn import reservoir as jres
from speedy_ml_tpu_torch.esn import reservoir as tres
from speedy_ml_tpu_torch.kernels.readout import readout as readout_fused
from torch_lane import one_thread_per_pool  # noqa: F401

R, N, I, O, J = 5, 96, 12, 20, 4


def _weights(seed, mode, win_cols=False, S=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    shifts = tuple(int(s) for s in rng.choice(N, size=J, replace=False))
    if mode == "shift":
        cols = (np.arange(N)[:, None] + np.asarray(shifts)[None, :]) % N
    elif mode == "shared":
        cols = rng.integers(0, N, size=(N, J))
    else:
        cols = rng.integers(0, N, size=(R, N, J))
    w = dict(cols=cols.astype(np.int32),
             vals=rng.uniform(-0.3, 0.3, size=(J, R, N)).astype(dtype),
             win_vals=rng.uniform(-0.5, 0.5, size=(R, N)).astype(dtype),
             wout=rng.normal(scale=0.05, size=(R, O, S + N)).astype(dtype),
             mean=np.zeros((R, I), dtype), std=np.ones((R, I), dtype),
             n_in=I, shifts=shifts if mode == "shift" else None,
             win_cols=(rng.integers(0, I, size=(R, N)).astype(np.int32)
                       if win_cols else None))
    x = rng.uniform(-1, 1, size=(R, N)).astype(dtype)
    u = rng.normal(size=(R, I)).astype(dtype)
    lm = rng.normal(size=(R, S)).astype(dtype) if S else None
    return w, x, u, lm


def _jax_res(w):
    arr = lambda a: None if a is None else jnp.asarray(a)
    return jres.BatchedReservoir(
        cols=arr(w["cols"]), vals=arr(w["vals"]), win_vals=arr(w["win_vals"]),
        wout=arr(w["wout"]), mean=arr(w["mean"]), std=arr(w["std"]),
        n_in=w["n_in"], shifts=w["shifts"], win_cols=arr(w["win_cols"]))


def _torch_res(w):
    arr = lambda a: None if a is None else torch.as_tensor(a)
    return tres.BatchedReservoir(
        cols=arr(w["cols"]), vals=arr(w["vals"]), win_vals=arr(w["win_vals"]),
        wout=arr(w["wout"]), mean=arr(w["mean"]), std=arr(w["std"]),
        n_in=w["n_in"], shifts=w["shifts"], win_cols=arr(w["win_cols"]))


@pytest.mark.parametrize("mode", ["shift", "shared", "region"])
@pytest.mark.parametrize("leakage", [1.0, 0.7])
def test_esn_step_matches_jax(mode, leakage):
    w, x, u, _ = _weights(0, mode)
    ref = jres.esn_step(_jax_res(w), jnp.asarray(x), jnp.asarray(u), leakage)
    got = tres.esn_step(_torch_res(w), torch.as_tensor(x), torch.as_tensor(u),
                        leakage)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("mode", ["shift", "region"])
def test_esn_step_win_cols_matches_jax(mode):
    w, x, u, _ = _weights(1, mode, win_cols=True)
    ref = jres.esn_step(_jax_res(w), jnp.asarray(x), jnp.asarray(u))
    got = tres.esn_step(_torch_res(w), torch.as_tensor(x), torch.as_tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("mode", ["shift", "shared", "region"])
def test_ell_spmv_matches_jax(mode):
    w, x, _, _ = _weights(2, mode)
    if mode == "shift":
        ref = jres.ell_spmv_shift(jnp.asarray(w["vals"]), w["shifts"],
                                  jnp.asarray(x))
        got = tres.ell_spmv_shift(torch.as_tensor(w["vals"]), w["shifts"],
                                  torch.as_tensor(x))
    else:
        ref = jres.ell_spmv(jnp.asarray(w["vals"]), jnp.asarray(w["cols"]),
                            jnp.asarray(x))
        got = tres.ell_spmv(torch.as_tensor(w["vals"]),
                            torch.as_tensor(w["cols"]), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-15)


def test_win_apply_uniform_repeat_pads_last_input():
    """n not a multiple of I: jnp.repeat(total_repeat_length=n) repeats the
    last input over the leftover rows; the port's index map does too."""
    rng = np.random.default_rng(3)
    n, n_in = 50, 8                                  # q = 6, 2 leftover rows
    win = rng.normal(size=(2, n))
    u = rng.normal(size=(2, n_in))
    ref = jres.BatchedReservoir(
        cols=None, vals=jnp.zeros((1, 2, n)), win_vals=jnp.asarray(win),
        wout=jnp.zeros((2, 1, n)), mean=None, std=None,
        n_in=n_in).win_apply(jnp.asarray(u))
    got = tres.BatchedReservoir(
        cols=None, vals=torch.zeros((1, 2, n)), win_vals=torch.as_tensor(win),
        wout=torch.zeros((2, 1, n)), mean=None, std=None,
        n_in=n_in).win_apply(torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("S", [0, 7])
def test_readout_f64_matches_jax(S):
    w, x, _, lm = _weights(4, "shift", S=S)
    ref = jres.readout(_jax_res(w), jnp.asarray(x),
                       None if lm is None else jnp.asarray(lm))
    got = tres.readout(_torch_res(w), torch.as_tensor(x),
                       None if lm is None else torch.as_tensor(lm))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-15)
    # the fused unstandardize of the kernel wrapper
    rng = np.random.default_rng(5)
    mean, std = rng.normal(size=(R, O)), rng.uniform(0.5, 2, size=(R, O))
    fused = readout_fused(torch.as_tensor(w["wout"]), torch.as_tensor(x),
                          None if lm is None else torch.as_tensor(lm),
                          torch.as_tensor(mean), torch.as_tensor(std))
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref) * std + mean,
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("S", [0, 7])
def test_readout_bf16_matches_jax(S):
    w, x, _, lm = _weights(6, "shift", S=S, dtype=np.float32)
    jr = _jax_res(w)
    jr = jres.BatchedReservoir(**{**{f: getattr(jr, f) for f in (
        "cols", "vals", "win_vals", "mean", "std", "n_in", "shifts",
        "win_cols")}, "wout": jr.wout.astype(jnp.bfloat16)})
    ref = np.asarray(jres.readout(jr, jnp.asarray(x),
                                  None if lm is None else jnp.asarray(lm)))
    tr = _torch_res(w)
    tr = tres.BatchedReservoir(**{**tr.__dict__,
                                  "wout": tr.wout.to(torch.bfloat16)})
    got = tres.readout(tr, torch.as_tensor(x),
                       None if lm is None else torch.as_tensor(lm))
    assert got.dtype == torch.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * scale)
    # rounding aug to bf16 matters: without it the outputs move visibly
    unrounded = np.einsum("roa,ra->ro", np.asarray(tr.wout.float()),
                          np.concatenate(
                              ([lm] if lm is not None else [])
                              + [tres.quad_expand(torch.as_tensor(x)).numpy()],
                              axis=1))
    assert np.abs(unrounded - ref).max() > 1e-4 * scale


def test_synchronize_matches_jax():
    w, x, _, _ = _weights(7, "shift")
    rng = np.random.default_rng(8)
    inputs = rng.normal(size=(5, R, I))
    ref = jres.synchronize(_jax_res(w), jnp.asarray(x), jnp.asarray(inputs),
                           0.8)
    got = tres.synchronize(_torch_res(w), torch.as_tensor(x),
                           torch.as_tensor(inputs), 0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-15)


def _jax_seed(key):
    return int(np.asarray(jax.random.key_data(key)).ravel()[-1] & 0x7FFFFFFF)


@pytest.mark.parametrize("n_inputs,m", [(48, 300), (40, 300), (576, 6000)])
def test_generate_structure_matches_jax(n_inputs, m):
    """Same integer seed -> same shifts and the same leftover mask (the
    zero pattern of the last ELL slot), from numpy's Philox on both
    sides."""
    hyper = jres.ESNHyper(m=m)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    R_ = 3
    jcols, jvals, _, jshifts = jres.generate(
        key, R_, n_inputs, hyper, 0.5, dtype=jnp.float64, radius_iters=5)
    cols, vals, win, shifts = tres.generate(
        _jax_seed(key), R_, n_inputs, tres.ESNHyper(m=m), 0.5,
        dtype=torch.float64, radius_iters=5, device="cpu")
    assert shifts == jshifts
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    np.testing.assert_array_equal(vals.numpy() == 0,
                                  np.asarray(jvals) == 0)
    n = hyper.nodes(n_inputs)
    assert vals.shape == (len(shifts), R_, n) and win.shape == (R_, n)
    assert float(win.abs().max()) <= hyper.sigma


def test_generate_random_topology_matches_jax():
    """The reference's permutation-draw graphs are pure numpy: the port's
    cols equal JAX's, and the values equal them up to the radius scale."""
    hyper = jres.ESNHyper(m=300)
    key = jax.random.PRNGKey(11)
    for shared in (True, False):
        jcols, jvals, _, _ = jres.generate(
            key, 2, 60, hyper, 0.6, dtype=jnp.float64, radius_iters=200,
            shared_pattern=shared, topology="random")
        cols, vals, _, shifts = tres.generate(
            _jax_seed(key), 2, 60, tres.ESNHyper(m=300), 0.6,
            dtype=torch.float64, radius_iters=200, shared_pattern=shared,
            topology="random", device="cpu")
        assert shifts is None
        np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
        jv = np.asarray(jvals)
        ratio = vals.numpy()[jv != 0] / jv[jv != 0]
        np.testing.assert_allclose(ratio, ratio[0], rtol=1e-6)


def _dense(vals, shifts):
    J_, R_, n = vals.shape
    A = np.zeros((R_, n, n))
    rows = np.arange(n)
    for j, s in enumerate(shifts):
        A[:, rows, (rows + s) % n] += vals[j]
    return A


def test_generate_degree_and_spectral_radius():
    """Statistics of the torch-drawn values: row degree {k//n, k//n+1}
    summing to k, and |lambda_max| of the dense A (numpy eigvals) within
    5% of radius_by_lat after radius_iters=200."""
    hyper = tres.ESNHyper(m=300)
    n_inputs, R_ = 60, 4
    lat0, lat1 = np.array([-80.0, -10.0, 30.0, 50.0]), \
        np.array([-75.0, -5.0, 35.0, 55.0])
    radius = tres.radius_by_lat(lat0, lat1)
    _, vals, _, shifts = tres.generate(5, R_, n_inputs, hyper, radius,
                                       dtype=torch.float64,
                                       radius_iters=200, device="cpu")
    v = vals.numpy()
    n = hyper.nodes(n_inputs)
    k = hyper.nnz(n)
    deg = (v != 0).sum(axis=0)                       # (R, n)
    assert set(np.unique(deg)) <= {k // n, k // n + 1}
    assert (deg.sum(axis=1) == k).all()
    A = _dense(v, shifts)
    lam = np.abs(np.linalg.eigvals(A)).max(axis=1)
    np.testing.assert_allclose(lam, radius, rtol=0.05)


@pytest.mark.parametrize("mode", ["shift", "region"])
def test_power_iteration_matches_numpy(mode):
    """spectral_radius's power iteration (K1's linear mode) against a numpy
    power iteration on the dense A, same start vector and iterations."""
    rng = np.random.default_rng(9)
    n = 120
    shifts = tuple(int(s) for s in rng.choice(n, size=J, replace=False))
    vals = rng.uniform(0, 1, size=(J, R, n))
    if mode == "shift":
        A = _dense(vals, shifts)
        kw = dict(shifts=shifts)
    else:
        cols = rng.integers(0, n, size=(R, n, J)).astype(np.int32)
        A = np.zeros((R, n, n))
        for r in range(R):
            for j in range(J):
                np.add.at(A[r], (np.arange(n), cols[r, :, j]), vals[j, r])
        kw = dict(cols=torch.as_tensor(cols))
    v0 = rng.normal(size=(R, n))
    iters = 60
    v = v0 / np.linalg.norm(v0, axis=1, keepdims=True)
    for _ in range(iters):
        w_ = np.einsum("rij,rj->ri", A, v)
        lam = np.linalg.norm(w_, axis=1)
        v = w_ / np.maximum(lam, 1e-30)[:, None]
    got = tres.power_iteration(torch.as_tensor(vals), torch.as_tensor(v0),
                               iters, **kw)
    np.testing.assert_allclose(got.numpy(), lam, rtol=1e-10)

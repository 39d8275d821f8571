"""Port parity of the ridge trainer's pieces (esn/train.py, the
standardizer fit of esn/standardize.py and the plain version of K14),
against the JAX package on the CPU in float64.

Inputs come from numpy seeds.  Reservoirs are the JAX package's (drawn
with its PRNG keys) carried into the port with convert.py, so both sides
step the same weights.  Noise is JAX's own draw handed to the port's
apply_noise.  Tolerances, stated per test: the same operations in
another summation order (1e-12 of the result's scale), a ridge solve in
float64 (1e-9 of Wout's scale), the promoted solve that JAX does by QR
and the port by LU (1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.esn import reservoir as jres
from speedy_ml_tpu.esn import standardize as jstd
from speedy_ml_tpu.esn import train as jtrain
from speedy_ml_tpu_torch.convert import reservoir_from_numpy
from speedy_ml_tpu_torch.esn import standardize as tstd
from speedy_ml_tpu_torch.esn import train as ttrain
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
from speedy_ml_tpu_torch.kernels.gram_update import (gram_update,
                                                     gram_update_plain)
from torch_lane import one_thread_per_pool  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _rel(got, ref):
    """max |got - ref| over max |ref|."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _jhyper(h: ESNHyper):
    return jres.ESNHyper(**dataclasses.asdict(h))


def _reservoirs(R, I, m, topology, seed=0):
    """The JAX package's reservoir (f64) and its port conversion."""
    h = ESNHyper(m=m, deg=3)
    cols, vals, win, shifts = jres.generate(
        jax.random.key(seed), R, I, _jhyper(h), 0.5, dtype=jnp.float64,
        radius_iters=30, topology=topology)
    n = vals.shape[2]
    jr = jres.BatchedReservoir(
        cols=cols, vals=vals, win_vals=win, n_in=I,
        wout=jnp.zeros((R, 0, n)), mean=jnp.zeros((R, I)),
        std=jnp.ones((R, I)), shifts=shifts)
    tr = reservoir_from_numpy(jax.tree_util.tree_map(np.asarray, jr),
                              device="cpu", dtype=torch.float64)
    return jr, tr, h


@pytest.mark.parametrize("total", [1, 12, 37, 40, 64, 96])
def test_find_closest_divisor_matches(total):
    """Exactly equal over targets 0..total+5."""
    for target in range(total + 6):
        assert (ttrain.find_closest_divisor(target, total)
                == jtrain.find_closest_divisor(target, total))


@pytest.mark.parametrize("per_region", [False, True],
                         ids=["apply_noise", "apply_noise_keys"])
@pytest.mark.parametrize("precip", [False, True], ids=["plain", "precip"])
def test_apply_noise_matches_jax_draw(per_region, precip):
    """Given JAX's own draw, the port's noise equals JAX's (1e-12)."""
    rng = np.random.default_rng(1)
    R, I = 5, 40
    u = rng.normal(size=(R, I))
    kw = {}
    if precip:
        kw = dict(precip_slice=(24, 32),
                  precip_mean=rng.uniform(0.5, 1.5, size=(R, 1)),
                  precip_std=rng.uniform(0.5, 2.0, size=(R, 1)))
    key = jax.random.key(7)
    if per_region:
        keys = jax.random.split(key, R)
        ref = jtrain.apply_noise_keys(keys, jnp.asarray(u), 0.2, **kw)
        g = jax.vmap(lambda k, row: jax.random.normal(k, row.shape,
                                                      row.dtype))(
            keys, jnp.asarray(u))
        fn = ttrain.apply_noise_keys
    else:
        ref = jtrain.apply_noise(key, jnp.asarray(u), 0.2, **kw)
        g = jax.random.normal(key, u.shape, dtype=jnp.float64)
        fn = ttrain.apply_noise
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = fn(_t(g), _t(u), 0.2, **tkw)
    assert _rel(got, ref) <= 1e-12
    assert not np.allclose(np.asarray(ref), u)


@pytest.mark.parametrize("R", [6, 7], ids=["even", "odd"])
def test_compute_standardizer_with_floor_matches(R):
    """Per-component mean/std with the relative floor, an even and an
    odd region count (the median of an even count averages the middle
    pair): 1e-12.  Some components are near-constant so the floor acts."""
    rng = np.random.default_rng(R)
    nvar, nz, nx, ny = 4, 2, 3, 3
    comp_in = jstd.component_expansion(nx, ny, nvar, nz, logp=True,
                                       precip=True, sst=True, tisr=True)
    comp_out = jstd.component_expansion(nx - 2, ny - 2, nvar, nz, logp=True,
                                        precip=True, sst=False, tisr=False)
    nc = jstd.n_components(nvar, nz, logp=True, precip=True, sst=True,
                           tisr=True)
    T, I = 9, len(comp_in)
    scale = rng.uniform(0.5, 3.0, size=(1, R, nc))
    scale[..., 1] = 1e-4                       # a near-constant level
    scale[..., nc - 1] = 1e-3                  # a near-constant 2-D field
    scale[:, 0, 2] = 0.0                       # constant in one region
    # small offsets: s2/count - mean^2 cancels, in both packages alike
    series = 0.1 + rng.normal(size=(T, R, I)) * scale[:, :, comp_in]
    ref = jstd.compute_standardizer(jnp.asarray(series), comp_in, comp_out,
                                    nc, nvar_nz=(nvar, nz))
    got = tstd.compute_standardizer(_t(series), comp_in, comp_out, nc,
                                    nvar_nz=(nvar, nz))
    for f in ("comp_mean", "comp_std", "in_mean", "in_std", "out_mean",
              "out_std"):
        assert _rel(getattr(got, f), getattr(ref, f)) <= 1e-12, f
    floored = tstd.floor_component_std(got.comp_std, nvar, nz)
    assert torch.equal(floored, got.comp_std)
    med = tstd.median_over_regions(_t(scale[0]))
    np.testing.assert_allclose(med.numpy(), np.median(scale[0], axis=0),
                               rtol=1e-15)


def _series(T, R, I, O, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, R, I)), rng.normal(size=(T, R, O)),
            None if S == 0 else rng.normal(size=(T, R, S)))


@pytest.mark.parametrize("S", [0, 7], ids=["ml_only", "hybrid"])
@pytest.mark.parametrize("topology", ["shift", "random"])
def test_discard_and_accumulate_match(topology, S):
    """Noise off: discard_transient's state and accumulate_batches'
    normal equations and final state, with the shift topology and with
    `cols` (the reference's random graph), m <= 600: 1e-12 of the max of
    ss and of st."""
    R, I, O = 4, 48, 9
    jr, tr, h = _reservoirs(R, I, 480, topology)
    assert (tr.shifts is None) == (topology == "random")
    train_in, target, model = _series(40, R, I, O, S, 2)
    jx0 = jtrain.discard_transient(jr, _jhyper(h), jnp.asarray(train_in[:6]))
    tx0 = ttrain.discard_transient(tr, h, _t(train_in[:6]))
    assert _rel(tx0, jx0) <= 1e-12
    jeq, jx = jtrain.accumulate_batches(
        jr, _jhyper(h), jnp.asarray(train_in[6:]), jnp.asarray(target[6:]),
        None if model is None else jnp.asarray(model[6:]), jx0, 5)
    teq, tx = ttrain.accumulate_batches(
        tr, h, _t(train_in[6:]), _t(target[6:]),
        None if model is None else _t(model[6:]), tx0, 5)
    assert teq.ss.shape == (R, S + tr.n, S + tr.n)
    assert _rel(teq.ss, jeq.ss) <= 1e-12
    assert _rel(teq.st, jeq.st) <= 1e-12
    assert _rel(tx, jx) <= 1e-12


@pytest.mark.parametrize("S", [0, 5], ids=["ml_only", "hybrid"])
def test_gram_update_plain_matches_jax_einsums(S):
    """K14's plain version against the JAX batch_step einsums, added to
    a nonzero start: 1e-12."""
    rng = np.random.default_rng(3)
    C, R, n, O = 6, 3, 20, 4
    A = S + n
    states = np.tanh(rng.normal(size=(C, R, n)))
    model = rng.normal(size=(C, R, S)) if S else None
    target = rng.normal(size=(C, R, O))
    ss0, st0 = rng.normal(size=(R, A, A)), rng.normal(size=(R, O, A))
    sq = np.asarray(jres.quad_expand(jnp.asarray(states)))
    aug = sq if model is None else np.concatenate([model, sq], axis=2)
    ref_ss = ss0 + jnp.einsum("brm,brk->rmk", aug, aug)
    ref_st = st0 + jnp.einsum("bro,brk->rok", target, aug)
    ss, st = _t(ss0), _t(st0)
    out = gram_update(ss, st, _t(states), None if model is None
                      else _t(model), _t(target))
    assert out[0] is ss and out[1] is st            # in place
    assert _rel(ss, ref_ss) <= 1e-12 and _rel(st, ref_st) <= 1e-12
    ss2, st2 = _t(ss0), _t(st0)
    gram_update_plain(ss2, st2, _t(states), None if model is None
                      else _t(model), _t(target))
    assert torch.equal(ss2, ss) and torch.equal(st2, st)
    assert gram_update.launches == 0


def _normal_eq(R, A, O, T, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    aug = rng.normal(size=(R, T, A)) * rng.uniform(0.1, 3.0, size=(R, 1, A))
    tgt = rng.normal(size=(R, T, O))
    ss = np.einsum("rta,rtb->rab", aug, aug).astype(dtype)
    st = np.einsum("rto,rta->roa", tgt, aug).astype(dtype)
    return ss, st


@pytest.mark.parametrize("using_prior", [True, False])
def test_solve_wout_matches(using_prior):
    """A well-conditioned Gram (more samples than columns), n_speedy > 0
    and prior_val > 0: Wout within 1e-9 of its scale."""
    R, A, O, S = 3, 30, 6, 8
    ss, st = _normal_eq(R, A, O, 80, 4)
    h = ESNHyper(beta_res=0.01, beta_model=0.5, prior_val=0.3,
                 using_prior=using_prior)
    ref = jtrain.solve_wout(jtrain.NormalEq(jnp.asarray(ss), jnp.asarray(st)),
                            _jhyper(h), S)
    got = ttrain.solve_wout(ttrain.NormalEq(_t(ss), _t(st)), h, S)
    assert got.dtype == torch.float64
    assert _rel(got, ref) <= 1e-9


def test_solve_wout_f32_gram_promoted_to_f64():
    """An f32 Gram with solve_dtype=float64: each region is cast before
    the 1e-6 ridge (which f32 would round away).  JAX solves by QR, the
    port by LU: 1e-6 of Wout's scale; Wout comes back in f32."""
    R, A, O, S = 2, 24, 5, 6
    ss, st = _normal_eq(R, A, O, 60, 5, dtype=np.float32)
    h = ESNHyper(prior_val=0.2)
    ref = jtrain.solve_wout(jtrain.NormalEq(jnp.asarray(ss), jnp.asarray(st)),
                            _jhyper(h), S, solve_dtype=jnp.float64)
    got = ttrain.solve_wout(
        ttrain.NormalEq(torch.from_numpy(ss), torch.from_numpy(st)), h, S,
        solve_dtype=torch.float64)
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    assert _rel(got.double(), np.asarray(ref, dtype=np.float64)) <= 1e-6


def test_solve_wout_leaves_the_gram_untouched():
    """The ridge and the scaling go on copies: the NormalEq is unchanged,
    and a second solve gives the same Wout."""
    ss, st = _normal_eq(5, 20, 4, 50, 6)
    eq = ttrain.NormalEq(_t(ss), _t(st))
    one = ttrain.solve_wout(eq, ESNHyper(prior_val=0.5), 5)
    assert torch.equal(eq.ss, _t(ss)) and torch.equal(eq.st, _t(st))
    assert torch.equal(one, ttrain.solve_wout(eq, ESNHyper(prior_val=0.5),
                                              5))


def test_pinv_svd_matches():
    """Batched pseudo-inverse with the hard threshold: 1e-10."""
    rng = np.random.default_rng(8)
    a = rng.normal(size=(3, 7, 5))
    a[0, :, 4] = 1e-4 * a[0, :, 0]             # a singular value < thres
    ref = jtrain.pinv_svd(jnp.asarray(a))
    got = ttrain.pinv_svd(_t(a))
    assert _rel(got, ref) <= 1e-10


def test_sharded_solve_is_a_later_slice():
    """The sharded solve has come (A16a): each shard's regions solved
    alone are solve_wout's rows bit for bit, in the solve dtype asked
    for (JAX parity: tests/test_torch_sharded.py)."""
    from speedy_ml_tpu_torch.parallel.mesh import Mesh, gather_rows
    rng = np.random.default_rng(9)
    aug = rng.normal(size=(4, 20, 6))
    eq = ttrain.NormalEq(_t(np.einsum("rta,rtb->rab", aug, aug)),
                         _t(np.einsum("rto,rta->roa",
                                      rng.normal(size=(4, 20, 3)), aug)))
    hyper = ESNHyper(beta_res=0.1, beta_model=1.0, prior_val=0.5)
    for solve_dtype in (None, torch.float64):
        got = ttrain.solve_wout_sharded(eq, hyper, 2, Mesh(["cpu"] * 2),
                                        solve_dtype=solve_dtype)
        assert len(got) == 2
        assert torch.equal(gather_rows(got, "cpu"),
                           ttrain.solve_wout(eq, hyper, 2, solve_dtype))
    with pytest.raises(ValueError, match="axis"):
        ttrain.solve_wout_sharded(eq, hyper, 2, Mesh(["cpu"] * 2),
                                  axis="lat")

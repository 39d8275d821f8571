"""Port parity of the slab ocean (A10b): esn/ocean.py, the ocean trainers
(hybrid/training.py fit_ocean_class, train_ocean_class, train_hybrid;
hybrid/chunked.py ocean_series_production, train_hybrid_production),
HybridAtmosphere.start_prediction, the ocean packs of a checkpoint and
K22's wrapper, on the CPU at T10 (32 x 16, 8 levels, 128 regions) in
float64 against the JAX package (the running ocean:
tests/test_torch_ocean_cycle.py, which takes its hybrids from here).

Inputs are made from a seed with numpy.  SLAB_STRIDE (and slab_stride)
is set to 3-5 on the instances, as tests/test_ocean.py does.  Tolerances,
as a fraction of each array's largest magnitude unless named otherwise:
  - ocean_index_map, ocean_target_slice, sst_core_from_input: equal;
    rolling_mean 1e-12 (a cumulative sum in another order);
  - ocean_series_production (a time chunk that does not divide the
    series): 1e-12 of the series, the targets and the mean SST;
  - fit_ocean_class and train_ocean_class with the JAX package's
    reservoir (patched in for the port's generate), noise off, at a
    ridge of 1e-2: Wout 1e-8 (a ridge solve of Grams summed in another
    order); mean_sst and std_sst equal (the same standardizer's values);
  - train_hybrid(ocean=True), train_hybrid_production(ocean=True,
    ocean_region_chunk=16): base_sst 1e-12, sea_mask equal;
  - start_prediction, with and without model_next: 1e-12;
  - checkpoints with ocean packs saved by either package and loaded by
    the other: equal.
"""

import dataclasses
import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.data import checkpoint as jck
from speedy_ml_tpu.esn import ocean as jocean
from speedy_ml_tpu.esn import reservoir as jres
from speedy_ml_tpu.esn.domain import RegionLayout as JRegionLayout
from speedy_ml_tpu.esn.standardize import Standardizer as JStandardizer
from speedy_ml_tpu.hybrid import chunked as jchunked
from speedy_ml_tpu.hybrid import model as jmodel
from speedy_ml_tpu.hybrid import training as jtraining
from speedy_ml_tpu.hybrid.build import build_untrained_hybrid as jbuild
from speedy_ml_tpu_torch.convert import (ocean_packs_from_numpy,
                                         params_from_numpy)
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data import checkpoint as tck
from speedy_ml_tpu_torch.esn import ocean
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
from speedy_ml_tpu_torch.esn.standardize import Standardizer
from speedy_ml_tpu_torch.hybrid import chunked, training
from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
from speedy_ml_tpu_torch.kernels import slab_ocean as k22
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
NZ = 8
N_REGIONS = 128
HYPER = ESNHyper(m=300, noise_mag=0.0)
# the ocean's settings of tests/test_ocean.py, the ridge 1e-2 (see the
# module docstring of tests/test_torch_training.py: at the reference's
# 1e-4 with a few samples the Grams' rounding moves Wout by more than
# the pipeline's differences)
OHYPER = ESNHyper(m=300, sigma=0.6, beta_res=1e-2, noise_mag=0.0,
                  using_prior=False)
CPU = dict(device="cpu", dtype=torch.float64)


def _jhyper(h):
    return jres.ESNHyper(**dataclasses.asdict(h))


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _signal_close(got, ref, rtol=1e-9):
    """|got - ref| within rtol of ref's signal (its largest departure from
    its mean)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    signal = max(np.abs(ref - ref.mean()).max(), 1e-300)
    err = np.abs(got - ref).max()
    assert err <= rtol * signal, f"err {err:.3e}, signal {signal:.3e}"


def fabricate_truth(T, seed=0):
    """Smooth fields with noise, after tests/test_ocean.py (numpy)."""
    g = JGeometry(**GEOM)
    rng = np.random.default_rng(seed)
    lat = g.lat_radians[:, None]
    lon = g.lon_radians[None, :]
    t = np.arange(T)[:, None, None]
    base = np.cos(lat) * np.cos(2 * lon + 0.1 * t) + 0.3 * np.sin(0.05 * t)
    atmo = np.zeros((T, 4, NZ, g.nlat, g.nlon))
    for v, (scale, off) in enumerate(((250.0, 250.0), (10.0, 0.0),
                                      (5.0, 0.0), (5.0, 5.0))):
        for k in range(NZ):
            atmo[:, v, k] = (off + 0.05 * scale * base * (1 + 0.1 * k)
                             + 0.01 * scale * rng.standard_normal(
                                 (T, g.nlat, g.nlon)))
    return dict(atmo=atmo, logp=0.01 * base,
                precip=np.maximum(0.0, 1e-3 * base),
                sst=288.0 + 5.0 * base
                + 0.2 * rng.standard_normal((T, g.nlat, g.nlon)),
                tisr=300.0 + 100.0 * base)


def land_fraction(seed=5):
    g = JGeometry(**GEOM)
    rng = np.random.default_rng(seed)
    return np.where(rng.random((g.nlat, g.nlon)) < 0.6, 0.0,
                    rng.random((g.nlat, g.nlon)))


@pytest.fixture(scope="module")
def layouts():
    return (JRegionLayout(JGeometry(**GEOM), n_regions=N_REGIONS, overlap=1),
            RegionLayout(Geometry(**GEOM), n_regions=N_REGIONS, overlap=1))


@pytest.fixture
def jax_reservoir(monkeypatch):
    """The port's generate patched to return the JAX package's reservoir
    drawn from jax.random.key(42) (whatever the seed); returns that key."""
    key = jax.random.key(42)

    def generate(seed, n_regions, n_inputs, hyper, radius,
                 dtype=torch.float32, topology="shift", device=None, **kw):
        cols, vals, win, shifts = jres.generate(
            key, n_regions, n_inputs, _jhyper(hyper), np.asarray(radius),
            dtype=jnp.float64, topology=topology)
        return (torch.as_tensor(np.asarray(cols), dtype=torch.int32,
                                device=device),
                torch.as_tensor(np.asarray(vals), dtype=dtype, device=device),
                torch.as_tensor(np.asarray(win), dtype=dtype, device=device),
                None if shifts is None else tuple(int(s) for s in shifts))

    monkeypatch.setattr(training, "generate", generate)
    return key


# ---------------------------------------------------------- esn/ocean.py

@pytest.mark.parametrize("ci", [0, 1, 2])
def test_ocean_functions_match_jax(layouts, ci):
    jl, tl = layouts
    jc, tc = jl.classes[ci], tl.classes[ci]
    np.testing.assert_array_equal(ocean.ocean_index_map(tc, NZ),
                                  jocean.ocean_index_map(jc, NZ))
    assert ocean.ocean_target_slice(tc, NZ) == \
        tuple(jocean.ocean_target_slice(jc, NZ))
    rng = np.random.default_rng(ci)
    xi, yi = tc.input_shape
    blk = rng.standard_normal((tc.count, xi * yi))
    np.testing.assert_array_equal(
        ocean.sst_core_from_input(tc, torch.as_tensor(blk)).numpy(),
        np.asarray(jocean.sst_core_from_input(jc, jnp.asarray(blk))))
    series = rng.standard_normal((23, tc.count, 5))
    for W in (1, 4, 7, 28):
        assert _rel(ocean.rolling_mean(torch.as_tensor(series), W),
                    jocean.rolling_mean(jnp.asarray(series), W)) <= 1e-12
    assert ocean.OCEAN_HYPER == ESNHyper(
        **dataclasses.asdict(jocean.OCEAN_HYPER))


# ------------------------------------------------------------- trainers

def _port_std(tl, cls, truth):
    series = training.pack_class_series(tl, cls, truth)
    return training.class_standardizer(tl, cls, series, NZ)


def _jax_std(std: Standardizer):
    return JStandardizer(**{k: jnp.asarray(getattr(std, k).numpy())
                            for k in ("comp_mean", "comp_std", "in_mean",
                                      "in_std", "out_mean", "out_std")})


def test_ocean_series_production_matches_jax(layouts):
    """Time chunks of 9 over 40 samples, the rolling window of 7 carried
    across their edges."""
    jl, tl = layouts
    truth = fabricate_truth(40, seed=1)
    std = _port_std(tl, tl.classes[1], truth)
    got = chunked.ocean_series_production(
        tl, tl.classes[1], std, chunked.ArraySource(truth), NZ,
        slab_stride=7, time_chunk=9, **CPU)
    ref = jchunked.ocean_series_production(
        jl, jl.classes[1], _jax_std(std), jchunked.ArraySource(truth), NZ,
        slab_stride=7, time_chunk=9, dtype=jnp.float64)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-12


def _fit_inputs(tl, ci, T_slab=9, seed=2):
    """(o_series, target, atmo pack with a seeded standardizer) of class
    ci."""
    cls = tl.classes[ci]
    rng = np.random.default_rng(seed)
    I_o = len(ocean.ocean_index_map(cls, NZ))
    xc, yc = cls.core_shape
    o_series = rng.standard_normal((T_slab, cls.count, I_o))
    target = rng.standard_normal((T_slab, cls.count, xc * yc))
    nc = 4 * NZ + 4
    std = types.SimpleNamespace(
        comp_mean=torch.as_tensor(rng.uniform(280, 300, (cls.count, nc))),
        comp_std=torch.as_tensor(rng.uniform(1, 5, (cls.count, nc))))
    return o_series, target, types.SimpleNamespace(std=std)


@pytest.mark.parametrize("hybrid_ocean", [False, True],
                         ids=["ml_only", "hybrid"])
def test_fit_ocean_class_matches_jax(layouts, jax_reservoir, hybrid_ocean):
    """Two region chunks of 64 and 32 regions."""
    jl, tl = layouts
    o_series, target, pack = _fit_inputs(tl, 1)
    jpack = types.SimpleNamespace(std=types.SimpleNamespace(
        comp_mean=jnp.asarray(pack.std.comp_mean.numpy()),
        comp_std=jnp.asarray(pack.std.comp_std.numpy())))
    ref = jtraining.fit_ocean_class(
        jl.classes[1], jnp.asarray(o_series), jnp.asarray(target), jpack,
        _jhyper(OHYPER), jax_reservoir, NZ, dtype=jnp.float64,
        hybrid_ocean=hybrid_ocean, region_chunk=64)
    got = training.fit_ocean_class(
        tl.classes[1], o_series, target, pack, OHYPER, 0, NZ,
        hybrid_ocean=hybrid_ocean, region_chunk=64, **CPU)
    assert got.hybrid_readout == ref.hybrid_readout == hybrid_ocean
    assert got.res.wout.shape == ref.res.wout.shape
    assert _rel(got.res.wout, ref.res.wout) <= 1e-8
    np.testing.assert_array_equal(got.mean_sst.numpy(),
                                  np.asarray(ref.mean_sst))
    np.testing.assert_array_equal(got.std_sst.numpy(),
                                  np.asarray(ref.std_sst))
    np.testing.assert_array_equal(got.idx_map, ref.idx_map)


@pytest.mark.parametrize("hybrid_ocean", [False, True],
                         ids=["ml_only", "hybrid"])
def test_train_ocean_class_matches_jax(layouts, jax_reservoir, hybrid_ocean):
    """From a truth of 50 samples at a slab stride of 5 (10 slab samples),
    with the atmosphere standardizer of the port's class_standardizer."""
    jl, tl = layouts
    truth = fabricate_truth(50, seed=3)
    std = _port_std(tl, tl.classes[0], truth)
    tpack = types.SimpleNamespace(std=std)
    jpack = types.SimpleNamespace(std=_jax_std(std))
    ref = jtraining.train_ocean_class(
        jl, jl.classes[0], jpack, _jhyper(OHYPER), jax_reservoir, NZ,
        slab_stride=5, dtype=jnp.float64, truth=truth,
        hybrid_ocean=hybrid_ocean)
    got = training.train_ocean_class(
        tl, tl.classes[0], tpack, OHYPER, 0, NZ, slab_stride=5, truth=truth,
        hybrid_ocean=hybrid_ocean, **CPU)
    assert _rel(got.res.wout, ref.res.wout) <= 1e-8
    np.testing.assert_array_equal(got.mean_sst.numpy(),
                                  np.asarray(ref.mean_sst))
    np.testing.assert_array_equal(got.std_sst.numpy(),
                                  np.asarray(ref.std_sst))


def _gcms(fm):
    g = JGeometry(**GEOM)
    jgcm = types.SimpleNamespace(geom=g, dtype=jnp.float64, nsteps_day=36,
                                 bd=types.SimpleNamespace(
                                     fmask_l=jnp.asarray(fm)))
    tgcm = types.SimpleNamespace(geom=Geometry(**GEOM), dtype=torch.float64,
                                 nsteps_day=36, bd=types.SimpleNamespace(
                                     fmask_l=torch.as_tensor(fm)))
    return jgcm, tgcm


def _check_ocean_hybrid(got, ref, hybrid_ocean):
    assert got.ml_only and ref.ml_only
    assert _rel(got.base_sst, ref.base_sst) <= 1e-12
    np.testing.assert_array_equal(got.sea_mask.numpy(),
                                  np.asarray(ref.sea_mask))
    for tp, jp in zip(got.ocean_packs, ref.ocean_packs):
        assert tp.hybrid_readout == jp.hybrid_readout == hybrid_ocean
        assert tuple(tp.res.wout.shape) == jp.res.wout.shape
        assert bool(torch.isfinite(tp.res.wout).all())
        assert float(tp.res.wout.abs().max()) > 0


def _jax_res(res):
    return jres.BatchedReservoir(
        cols=jnp.asarray(res.cols.numpy()), vals=jnp.asarray(res.vals.numpy()),
        win_vals=jnp.asarray(res.win_vals.numpy()),
        wout=jnp.asarray(res.wout.numpy()), mean=jnp.asarray(res.mean.numpy()),
        std=jnp.asarray(res.std.numpy()), n_in=res.n_in, shifts=res.shifts)


def _jax_trainers(monkeypatch, jl, got):
    """The JAX package's class trainers patched to hand back the port's
    trained packs (their parity is held above and in
    tests/test_torch_training.py), so that its train_hybrid and
    train_hybrid_production compute base_sst and sea_mask and assemble the
    hybrid without compiling the trainers again."""
    by_name = {p.cls.name: p for p in got.packs}
    ocean_by_name = {p.cls.name: p for p in got.ocean_packs}
    cls_of = {c.name: c for c in jl.classes}

    def atmo(layout, cls, *a, **kw):
        p = by_name[cls.name]
        return jmodel.ClassPack(cls=cls_of[cls.name], res=_jax_res(p.res),
                                hyper=_jhyper(p.hyper), std=_jax_std(p.std))

    def slab(*a, **kw):
        cls = a[1] if isinstance(a[0], JRegionLayout) else a[0]
        p = ocean_by_name[cls.name]
        return jmodel.OceanPack(
            cls=cls_of[cls.name], res=_jax_res(p.res), hyper=_jhyper(p.hyper),
            idx_map=p.idx_map, mean_sst=jnp.asarray(p.mean_sst.numpy()),
            std_sst=jnp.asarray(p.std_sst.numpy()),
            hybrid_readout=p.hybrid_readout)

    monkeypatch.setattr(jtraining, "train_class", atmo)
    monkeypatch.setattr(jchunked, "train_class_production", atmo)
    monkeypatch.setattr(jtraining, "train_ocean_class", slab)
    monkeypatch.setattr(jtraining, "fit_ocean_class", slab)


def test_train_hybrid_ocean_matches_jax(layouts, monkeypatch):
    """train_hybrid(ocean=True) from 112 samples (4 slab samples at the
    stride of 28)."""
    jl, tl = layouts
    truth = fabricate_truth(112, seed=4)
    jgcm, tgcm = _gcms(land_fraction())
    kw = dict(ocean=True, n_discard=4, n_batches=4)
    got = training.train_hybrid(tgcm, tl, truth, None, HYPER, 1,
                                ocean_hyper=OHYPER, **kw, **CPU)
    _jax_trainers(monkeypatch, jl, got)
    ref = jtraining.train_hybrid(jgcm, jl, truth, None, _jhyper(HYPER),
                                 jax.random.PRNGKey(1),
                                 ocean_hyper=_jhyper(OHYPER),
                                 dtype=jnp.float64, **kw)
    _check_ocean_hybrid(got, ref, False)


def test_train_hybrid_production_ocean_matches_jax(layouts, monkeypatch):
    """train_hybrid_production(ocean=True, ocean_region_chunk=16,
    hybrid_ocean=True) from 40 samples at a slab stride of 5: JAX's
    ocean_series_production makes its base_sst."""
    jl, tl = layouts
    truth = fabricate_truth(40, seed=6)
    jgcm, tgcm = _gcms(land_fraction())
    kw = dict(hybrid=False, ocean=True, hybrid_ocean=True, slab_stride=5,
              ocean_region_chunk=16, n_discard=2)
    got = chunked.train_hybrid_production(
        tgcm, tl, chunked.ArraySource(truth), HYPER, 2, ocean_hyper=OHYPER,
        **kw, **CPU)
    _jax_trainers(monkeypatch, jl, got)
    ref = jchunked.train_hybrid_production(
        jgcm, jl, jchunked.ArraySource(truth), _jhyper(HYPER),
        jax.random.PRNGKey(2), ocean_hyper=_jhyper(OHYPER),
        dtype=jnp.float64, **kw)
    _check_ocean_hybrid(got, ref, True)


# --------------------------------------------- the armed and running ocean

@functools.lru_cache(maxsize=None)
def _jax_base():
    """The JAX package's untrained ML-only hybrid (m = 300) and seeded slab
    reservoirs for each class (the JAX package's generate), built once."""
    jgcm, _ = _gcms(land_fraction())
    jb = jbuild(jgcm, n_regions=N_REGIONS, m=HYPER.m,
                key=jax.random.PRNGKey(0), ml_only=True, radius_iters=30)
    slabs = []
    for i, cls in enumerate(jb.layout.classes):
        idx = jocean.ocean_index_map(cls, NZ)
        slabs.append(jres.generate(
            jax.random.PRNGKey(100 + i), cls.count, len(idx),
            _jhyper(OHYPER), np.full(cls.count, 0.9), dtype=jnp.float64,
            radius_iters=30))
    return jb, slabs


def jax_ocean_packs(jl, hybrid_readout, seed=7):
    """Seeded slab packs for each class: a random Wout whose outputs are
    O(1) standardized SST, mean_sst near 285 K and std_sst near 4 K."""
    rng = np.random.default_rng(seed)
    out = []
    for cls, (cols, vals, win, shifts) in zip(jl.classes, _jax_base()[1]):
        idx = jocean.ocean_index_map(cls, NZ)
        n = vals.shape[2]
        xc, yc = cls.core_shape
        S = xc * yc if hybrid_readout else 0
        wout = rng.normal(0.0, 1.0 / np.sqrt(n), (cls.count, xc * yc, S + n))
        res = jres.BatchedReservoir(
            cols=cols, vals=vals, win_vals=win, wout=jnp.asarray(wout),
            mean=jnp.zeros((cls.count, len(idx))),
            std=jnp.ones((cls.count, len(idx))), n_in=len(idx),
            shifts=shifts)
        out.append(jmodel.OceanPack(
            cls=cls, res=res, hyper=_jhyper(OHYPER), idx_map=idx,
            mean_sst=jnp.asarray(rng.uniform(283, 287, (cls.count, 1))),
            std_sst=jnp.asarray(rng.uniform(3, 5, (cls.count, 1))),
            hybrid_readout=hybrid_readout))
    return out


@functools.lru_cache(maxsize=None)
def ocean_pair(hybrid_readout, ml_only=True):
    """The JAX package's untrained hybrid with seeded ocean packs and the
    land fill of a seeded land mask, and the port's copy (built once each:
    JAX compiles a hybrid's cycle once).  With ml_only false the packs
    get a seeded local-model block and the port's hybrid a port GCM
    (start_prediction runs no window)."""
    jl = JRegionLayout(JGeometry(**GEOM), n_regions=N_REGIONS, overlap=1)
    tl = RegionLayout(Geometry(**GEOM), n_regions=N_REGIONS, overlap=1)
    fm = land_fraction()
    jgcm, tgcm = _gcms(fm)
    jb, _ = _jax_base()
    jpacks = jb.packs
    if not ml_only:
        from speedy_ml_tpu_torch.gcm import GCM
        from speedy_ml_tpu_torch.physics.boundaries import \
            synthetic_boundary_data
        g = Geometry(**GEOM)
        tgcm = GCM(g, dtype=torch.float64, nsteps_day=8, device="cpu",
                   bd=synthetic_boundary_data(g, dtype=torch.float64))
        rng = np.random.default_rng(11)
        jpacks = []
        for p in jb.packs:
            xc, yc = p.cls.core_shape
            R, O, _ = p.res.wout.shape
            lm = jnp.asarray(rng.normal(0.0, 1e-3, (R, O, O - xc * yc)))
            jpacks.append(p._replace(res=dataclasses.replace(
                p.res, wout=jnp.concatenate([lm, p.res.wout], axis=2))))
    jops = jax_ocean_packs(jb.layout, hybrid_readout)
    base = 287.0 + np.random.default_rng(8).normal(0.0, 2.0, fm.shape)
    jhyb = jmodel.HybridAtmosphere(jgcm, jb.layout, jpacks,
                                   ml_only=ml_only, ocean_packs=jops,
                                   base_sst=jnp.asarray(base),
                                   sea_mask=jnp.asarray(fm > 0.0))
    host = jax.tree_util.tree_map(np.asarray, jhyb.params)
    packs = params_from_numpy(host[0], tl, HYPER, **CPU)
    opacks = ocean_packs_from_numpy(host[1], tl, OHYPER,
                                    hybrid_readout=hybrid_readout, **CPU)
    thyb = HybridAtmosphere(tgcm, tl, packs, ml_only=ml_only,
                            ocean_packs=opacks,
                            base_sst=torch.as_tensor(base),
                            sea_mask=torch.as_tensor(fm > 0.0),
                            device="cpu")
    return jhyb, thyb


def sync_window(T=6, seed=9):
    return fabricate_truth(T, seed=seed)


@functools.lru_cache(maxsize=None)
def _jax_started():
    """The JAX package's start_prediction of the coupled ocean pair, with
    model_next (its x, feedback and ocean states do not depend on it), and
    the window and forecast it took; one call (JAX compiles a lax.map per
    call, ~10 s)."""
    jhyb, _ = ocean_pair(True, ml_only=False)
    truth = sync_window()
    m = fabricate_truth(1, seed=10)
    model = dict(atmo=m["atmo"][0], logp=m["logp"][0])
    js = jhyb.start_prediction({k: jnp.asarray(v) for k, v in truth.items()},
                               {k: jnp.asarray(v) for k, v in model.items()},
                               jnp.asarray(truth["sst"][-1]))
    return js, truth, model


@pytest.mark.parametrize("with_model", [False, True],
                         ids=["no_model", "model_next"])
def test_start_prediction_matches_jax(with_model):
    """The coupled hybrid (S > 0, so model_next makes a local model) with
    the hybrid slab readout (lm seeded): x, the feedback, the local model
    (zeros without model_next) and the ocean states, 1e-12 of each
    array's scale."""
    _, thyb = ocean_pair(True, ml_only=False)
    js, truth, model = _jax_started()
    ts = thyb.start_prediction(truth, model if with_model else None,
                               truth["sst"][-1])
    assert ts.step == 0 and len(ts.ocean) == len(js.ocean) == 3
    for tc, jc in zip(ts.classes, js.classes):
        for k in ("x", "feedback"):
            assert _rel(getattr(tc, k), getattr(jc, k)) <= 1e-12, k
        if with_model:
            assert _rel(tc.local_model, jc.local_model) <= 1e-12
            assert float(tc.local_model.abs().max()) > 0
        else:
            assert tc.local_model.shape == jc.local_model.shape
            assert float(tc.local_model.abs().max()) == 0.0
    for to, jo in zip(ts.ocean, js.ocean):
        assert _rel(to.buffer, jo.buffer) <= 1e-12
        assert _rel(to.lm, jo.lm) <= 1e-12
        assert float(to.x.abs().max()) == 0.0


# ------------------------------------------------------------ checkpoints

def _same_ocean(t_hyb, j_hyb):
    for tp, jp in zip(t_hyb.ocean_packs, j_hyb.ocean_packs):
        for k in ("cols", "vals", "win_vals", "wout", "mean", "std"):
            np.testing.assert_array_equal(getattr(tp.res, k).numpy(),
                                          np.asarray(getattr(jp.res, k)))
        assert tp.res.shifts == jp.res.shifts
        assert tp.res.n_in == jp.res.n_in
        np.testing.assert_array_equal(tp.mean_sst.numpy(),
                                      np.asarray(jp.mean_sst))
        np.testing.assert_array_equal(tp.std_sst.numpy(),
                                      np.asarray(jp.std_sst))
        np.testing.assert_array_equal(tp.idx_map, np.asarray(jp.idx_map))
        assert tp.hybrid_readout == jp.hybrid_readout
        assert dataclasses.asdict(tp.hyper) == dataclasses.asdict(jp.hyper)
    np.testing.assert_array_equal(t_hyb.base_sst.numpy(),
                                  np.asarray(j_hyb.base_sst))
    np.testing.assert_array_equal(t_hyb.sea_mask.numpy(),
                                  np.asarray(j_hyb.sea_mask))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_with_ocean_loads_in_the_other_package(layouts, writer,
                                                          tmp_path):
    jl, tl = layouts
    jhyb, thyb = ocean_pair(True)
    path = str(tmp_path / writer)
    if writer == "jax":
        jck.save_hybrid(jhyb, path)
        loaded = tck.load_hybrid(thyb.gcm, tl, path, **CPU)
        _same_ocean(loaded, jhyb)
        _same_ocean(thyb, jhyb)
    else:
        tck.save_hybrid(thyb, path)
        meta = json.loads((tmp_path / writer / "meta.json").read_text())
        assert meta["has_ocean"] and meta["ocean_hybrid_0"]
        loaded = jck.load_hybrid(jhyb.gcm, jl, path, dtype=jnp.float64)
        _same_ocean(thyb, loaded)
        back = tck.load_hybrid(thyb.gcm, tl, path, **CPU)
        _same_ocean(back, loaded)
        for p, q in zip(back.ocean_packs, thyb.ocean_packs):
            assert torch.equal(p.res.wout, q.res.wout)


# ------------------------------------------------------------- K22's wrapper

def test_slab_ocean_counts_nothing_on_cpu_and_refuses_other_devices(
        layouts):
    """CPU tensors take the plain version and count no launch; a device
    without a kernel raises (no silent plain path)."""
    _, thyb = ocean_pair(False)
    thyb.SLAB_STRIDE = 28
    s = dataclasses.replace(thyb.init_state(np.full((16, 32), 290.0)),
                            step=27)
    before = k22.slab_ocean.launches
    s1, _ = thyb.cycle(s, 0, 0.5, 0.05)
    assert k22.slab_ocean.launches == before
    assert s1.sst_grid is not s.sst_grid
    meta = [torch.empty(o.buffer.shape, device="meta") for o in s.ocean]
    with pytest.raises(ValueError, match="no kernel"):
        k22.slab_ocean("push", bufs=meta, step=0,
                       fbs=[c.feedback for c in s.classes],
                       idx_maps=thyb.ocean_index)
    with pytest.raises(ValueError, match="form"):
        k22.slab_ocean("mean", bufs=meta)

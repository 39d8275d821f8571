"""Port parity of the trainers (hybrid/training.py, hybrid/chunked.py)
and of the self-contained training data, on the CPU in float64.

Sizes of tests/test_chunked.py: T10 on a 32 x 16 grid with 2 levels,
32 regions, m = 432.  The port's `generate` is monkeypatched (in the
namespaces of hybrid/training.py and hybrid/chunked.py) to return the
JAX package's reservoir, so both trainers step the same weights; noise
is off where the port is held to JAX (the two draw different numbers).
Tolerances: packing and standardizer fits 1e-12 of each array's scale;
Wout 1e-8 of its scale (a ridge solve of Grams summed in another order);
chunked against unchunked and chunk sizes against each other in the port
1e-12 of the normal equations; the nature run and the forecasts (T10
with 8 levels) 1e-9 of each field level's signal, the GCM tests'
tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.data.calendar import ModelDate as JModelDate
from speedy_ml_tpu.esn import reservoir as jres
from speedy_ml_tpu.esn.domain import RegionLayout as JRegionLayout
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.hybrid import chunked as jchunked
from speedy_ml_tpu.hybrid import training as jtraining
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu_torch.convert import boundary_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
from speedy_ml_tpu_torch.esn.train import NormalEq
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid import chunked, training
from speedy_ml_tpu_torch.hybrid.driver import run_prediction
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=2)
NZ = 2
# beta_res 0.1 (a ridge of 1e-2 with using_prior): with ~40 samples
# against A = 576 columns the reference's 1e-6 ridge leaves the solve so
# ill-conditioned that the Grams' rounding (their sums in another order)
# moves Wout by ~3e-8; this ridge keeps the comparison on the pipeline
HYPER = ESNHyper(m=432, deg=3, sigma=0.5, leakage=1.0, beta_res=0.1,
                 beta_model=1.0, noise_mag=0.0)
CPU = dict(device="cpu", dtype=torch.float64)


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _jhyper(h):
    return jres.ESNHyper(**dataclasses.asdict(h))


def synth_truth(seed, T, nlat=16, nlon=32, nz=NZ):
    """Uniform fields in physical ranges (test_chunked.py's)."""
    rng = np.random.default_rng(seed)
    u = lambda shape, lo, hi: rng.uniform(lo, hi, size=shape)
    atmo = np.stack([u((T, nz, nlat, nlon), 220.0, 290.0),
                     u((T, nz, nlat, nlon), -30.0, 30.0),
                     u((T, nz, nlat, nlon), -20.0, 20.0),
                     u((T, nz, nlat, nlon), 0.0, 12.0)], axis=1)
    return dict(atmo=atmo, logp=u((T, nlat, nlon), -0.1, 0.1),
                precip=u((T, nlat, nlon), 0.0, 2e-4),
                sst=u((T, nlat, nlon), 271.0, 302.0),
                tisr=u((T, nlat, nlon), 0.0, 420.0))


def synth_model(seed, T):
    t = synth_truth(seed, T)
    return dict(atmo=t["atmo"], logp=t["logp"])


@pytest.fixture(scope="module")
def layouts():
    return (JRegionLayout(JGeometry(**GEOM), n_regions=32, overlap=1),
            RegionLayout(Geometry(**GEOM), n_regions=32, overlap=1))


@pytest.fixture
def jax_reservoir(monkeypatch):
    """Patch the port's generate to return the JAX package's reservoir
    drawn from jax.random.key(42); returns that key."""
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
    monkeypatch.setattr(chunked, "generate", generate)
    return key


@pytest.mark.parametrize("ci", [0, 1], ids=["pole", "interior"])
def test_pack_series_and_standardizer_match(layouts, ci):
    """pack_class_series, pack_class_model_series and class_standardizer
    against the JAX package: 1e-12."""
    jl, tl = layouts
    truth, model = synth_truth(0, 12), synth_model(1, 12)
    js = jtraining.pack_class_series(jl, jl.classes[ci], truth)
    ts = training.pack_class_series(tl, tl.classes[ci], truth)
    assert ts.shape == js.shape and _rel(ts, js) <= 1e-12
    jm = jtraining.pack_class_model_series(jl, jl.classes[ci], model)
    tm = training.pack_class_model_series(tl, tl.classes[ci], model)
    assert tm.shape == jm.shape and _rel(tm, jm) <= 1e-12
    jstd = jtraining.class_standardizer(jl, jl.classes[ci], js, NZ)
    tstd = training.class_standardizer(tl, tl.classes[ci], ts, NZ)
    for f in ("comp_mean", "comp_std", "in_mean", "in_std", "out_mean",
              "out_std"):
        assert _rel(getattr(tstd, f), getattr(jstd, f)) <= 1e-12, f


def test_train_class_matches_jax(layouts, jax_reservoir):
    """The in-memory trainer, noise off: Wout within 1e-8 of its scale."""
    jl, tl = layouts
    T, n_discard, n_batches = 46, 6, 4
    truth, model = synth_truth(2, T), synth_model(3, T)
    ref = jtraining.train_class(jl, jl.classes[1], truth, model,
                                _jhyper(HYPER), jax_reservoir, NZ,
                                n_discard=n_discard, n_batches=n_batches,
                                dtype=jnp.float64)
    got = training.train_class(tl, tl.classes[1], truth, model, HYPER, 0, NZ,
                               n_discard=n_discard, n_batches=n_batches,
                               **CPU)
    assert got.res.wout.shape == ref.res.wout.shape
    assert _rel(got.res.wout, ref.res.wout) <= 1e-8
    assert _rel(got.std.comp_std, ref.std.comp_std) <= 1e-12


def test_train_class_production_matches_jax(layouts, jax_reservoir):
    """The chunked trainer, noise off, two region chunks and a time
    chunk across n_discard (even chunks: each shape is a JAX compile;
    the port's ragged chunks are held to its in-memory trainer below):
    Wout within 1e-8 of its scale."""
    jl, tl = layouts
    T = 40
    truth, model = synth_truth(4, T), synth_model(5, T)
    kw = dict(region_chunk=8, time_chunk=8, n_discard=6)
    ref = jchunked.train_class_production(
        jl, jl.classes[1], jchunked.ArraySource(truth, model),
        _jhyper(HYPER), jax_reservoir, NZ, dtype=jnp.float64, **kw)
    got = chunked.train_class_production(
        tl, tl.classes[1], chunked.ArraySource(truth, model), HYPER, 0, NZ,
        **kw, **CPU)
    assert got.res.wout.shape == ref.res.wout.shape
    assert _rel(got.res.wout, ref.res.wout) <= 1e-8
    assert _rel(got.std.comp_mean, ref.std.comp_mean) <= 1e-12


def test_streaming_standardizer_matches_jax(layouts):
    """Streamed in chunks of 7 samples, the pole class: 1e-12."""
    jl, tl = layouts
    truth = synth_truth(6, 30)
    ref = jchunked.streaming_standardizer(
        jl, jl.classes[0], jchunked.ArraySource(truth), NZ, time_chunk=7,
        dtype=jnp.float64)
    got = chunked.streaming_standardizer(
        tl, tl.classes[0], chunked.ArraySource(truth), NZ, time_chunk=7,
        **CPU)
    for f in ("comp_mean", "comp_std", "in_mean", "in_std", "out_mean",
              "out_std"):
        assert _rel(getattr(got, f), getattr(ref, f)) <= 1e-12, f


def _equations(tr, region_chunk):
    parts = [tr.normal_equations(r0, min(r0 + region_chunk, tr.cls.count))
             for r0 in range(0, tr.cls.count, region_chunk)]
    return NormalEq(torch.cat([p.ss for p in parts]),
                    torch.cat([p.st for p in parts]))


def _close_eq(a, b, tol=1e-12):
    assert _rel(a.ss, b.ss) <= tol and _rel(a.st, b.st) <= tol


@pytest.mark.parametrize("noise", [0.0, 0.2], ids=["noise_off", "noise_on"])
def test_chunked_equals_unchunked(layouts, noise):
    """In the port the in-memory and the chunked trainer draw the same
    noise, so with or without it the chunked Wout equals the in-memory
    one over the same complete batches (1e-8 of its scale)."""
    _, tl = layouts
    T, n_discard, n_batches = 46, 6, 4
    truth, model = synth_truth(7, T), synth_model(8, T)
    hyper = dataclasses.replace(HYPER, noise_mag=noise)
    ref = training.train_class(tl, tl.classes[1], truth, model, hyper, 11,
                               NZ, n_discard=n_discard, n_batches=n_batches,
                               **CPU)
    L = T - n_discard
    bs = training.find_closest_divisor(max(1, L // n_batches), L)
    got = chunked.train_class_production(
        tl, tl.classes[1], chunked.ArraySource(truth, model), hyper, 11, NZ,
        region_chunk=5, time_chunk=7, n_discard=n_discard,
        n_pairs=((L - 1) // bs) * bs, **CPU)
    assert _rel(got.res.wout, ref.res.wout) <= 1e-8


def test_noise_is_invariant_to_chunk_sizes(layouts):
    """Noise on: any (region_chunk, time_chunk) gives the same normal
    equations (1e-12), and they differ from the noise-free ones."""
    _, tl = layouts
    truth, model = synth_truth(9, 30), synth_model(10, 30)
    src = chunked.ArraySource(truth, model)
    hyper = dataclasses.replace(HYPER, noise_mag=0.2)
    mk = lambda h, tc: chunked.class_trainer(tl, tl.classes[1], src, h, 5,
                                             NZ, time_chunk=tc, n_discard=4,
                                             **CPU)
    a = _equations(mk(hyper, 30), 16)
    b = _equations(mk(hyper, 5), 3)
    _close_eq(b, a)
    c = _equations(mk(HYPER, 30), 16)
    assert _rel(c.ss, a.ss) > 1e-6


def test_stride_sums_the_subseries(layouts):
    """stride=2: the normal equations are the sum of those of the two
    interleaved series trained on their own (1e-12)."""
    _, tl = layouts
    T = 36
    truth = synth_truth(11, T)
    cls = tl.classes[1]
    std = chunked.streaming_standardizer(tl, cls, chunked.ArraySource(truth),
                                         NZ, **CPU)
    mk = lambda src, stride: chunked.class_trainer(
        tl, cls, src, HYPER, 5, NZ, time_chunk=5, stride=stride, n_discard=3,
        std=std, hybrid=False, **CPU)
    both = _equations(mk(chunked.ArraySource(truth), 2), 7)
    parts = [_equations(mk(chunked.ArraySource(
        {k: v[s::2] for k, v in truth.items()}), 1), 7) for s in (0, 1)]
    _close_eq(both, NormalEq(parts[0].ss + parts[1].ss,
                             parts[0].st + parts[1].st))
    assert both.ss.shape[1] == both.ss.shape[2] == both.st.shape[2]


# ----------------------------------------------------------------------
# the nature run and the imperfect model's forecasts
# ----------------------------------------------------------------------

GCM_GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)


def _close_fields(got, ref, rtol=1e-9):
    """1e-9 of each field level's signal, floored at 1e-3 of the whole
    array's magnitude (test_torch_gcm.py's measure)."""
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    r = ref.reshape(-1, *ref.shape[-2:])
    g = got.reshape(r.shape)
    floor = 1e-3 * np.abs(r).max()
    for a, b in zip(g, r):
        scale = max(np.abs(b - b.mean()).max(), floor, 1e-300)
        assert np.abs(a - b).max() <= rtol * scale


@pytest.fixture(scope="module")
def nature_gcms():
    """The JAX package's and the port's T10 GCMs (nsteps_day = 8) on the
    synthetic aquaplanet, float64."""
    jg = JGeometry(**GCM_GEOM)
    jgcm = JGCM(jg, dtype=jnp.float64, nsteps_day=8,
                bd=jsynthetic(jg, JST(jg, dtype=jnp.float64)))
    tgcm = GCM(Geometry(**GCM_GEOM), dtype=torch.float64, nsteps_day=8,
               bd=boundary_from_numpy(jgcm.bd, **CPU), device="cpu")
    return jgcm, tgcm


@pytest.fixture(scope="module")
def nature_pair(nature_gcms):
    jgcm, tgcm = nature_gcms
    jt, jsnaps, jdates = jtraining.generate_nature_run(
        jgcm, JModelDate(1990, 1, 1), 4, spinup_days=0)
    tt, tsnaps, tdates = training.generate_nature_run(
        tgcm, ModelDate(1990, 1, 1), 4, spinup_days=0)
    jm = jtraining.make_imperfect_forecasts(jgcm, jt, jdates)
    tm = training.make_imperfect_forecasts(tgcm, tt, tdates)
    return (jt, jsnaps, jdates, jm), (tt, tsnaps, tdates, tm), tgcm


def test_nature_run_and_forecasts_match_jax(nature_pair):
    """4 samples at 6 h (2 GCM steps each, nsteps_day=8) from a rest
    state, spinup_days=0, then the 6-h forecasts from each sample: 1e-9
    of each field level's signal."""
    (jt, jsnaps, jdates, jm), (tt, tsnaps, tdates, tm), _ = nature_pair
    assert [(d.year, d.month, d.day, d.hour) for d in tdates] == \
        [(d.year, d.month, d.day, d.hour) for d in jdates]
    assert len(tsnaps) == len(jsnaps) == 1
    for k in ("atmo", "logp", "precip", "sst", "tisr"):
        _close_fields(tt[k], jt[k])
    assert float(tt["precip"].max()) > 0.0
    for k in ("atmo", "logp"):
        _close_fields(tm[k], jm[k])
    # the forecasts moved away from the truth they started from
    assert float((tm["atmo"][1] - tt["atmo"][0]).abs().max()) > 1e-3


def test_train_hybrid_production_runs_the_cycle(nature_pair):
    """The production entry point on the nature run (tiny: 128 regions,
    m=600): a coupled HybridAtmosphere with finite Wout that runs
    coupled cycles; the timings name every stage."""
    _, (tt, _, tdates, tm), tgcm = nature_pair
    layout = RegionLayout(tgcm.geom, n_regions=128)
    timings = {}
    hyb = chunked.train_hybrid_production(
        tgcm, layout, chunked.ArraySource(tt, tm), ESNHyper(m=600), 33,
        time_chunk=2, n_discard=1, region_chunk=24,
        solve_dtype=torch.float64, timings=timings, device="cpu")
    assert sorted(timings) == ["accumulate", "generate", "solve",
                               "standardizer"]
    assert not hyb.ml_only
    for p in hyb.packs:
        assert p.res.n_speedy > 0 and bool(torch.isfinite(p.res.wout).all())
    state, dates = run_prediction(hyb, hyb.init_state(tt["sst"][0]),
                                  tdates[-1], 2, stop_if_unsafe=False)
    assert len(dates) == 2
    for cs in state.classes:
        assert bool(torch.isfinite(cs.x).all())


def test_nature_run_spinup_matches_jax(nature_gcms):
    """generate_nature_run with a day of spin-up (GCM.run_days: the day's
    8 steps, then the slab coupler) before its 4 samples: the truth, the
    dates and the surface the spin-up coupled, 1e-9 of each field level's
    signal."""
    jgcm, tgcm = nature_gcms
    jt, jsnaps, jdates = jtraining.generate_nature_run(
        jgcm, JModelDate(1990, 1, 1), 4, spinup_days=1)
    tt, tsnaps, tdates = training.generate_nature_run(
        tgcm, ModelDate(1990, 1, 1), 4, spinup_days=1)
    assert [(d.year, d.month, d.day, d.hour) for d in tdates] == \
        [(d.year, d.month, d.day, d.hour) for d in jdates]
    assert (tdates[0].month, tdates[0].day) == (1, 2)
    for k in ("atmo", "logp", "precip", "sst", "tisr"):
        _close_fields(tt[k], jt[k])
    for k in jsnaps[0].sfc.__dataclass_fields__:
        _close_fields(getattr(tsnaps[0].sfc, k), getattr(jsnaps[0].sfc, k))
    assert tsnaps[0].istep == int(jsnaps[0].istep) == 16


def test_unported_options_raise(layouts, nature_pair):
    """The vertical groups, once unported, are taken
    (tests/test_torch_vertical.py holds them against the JAX package);
    what still raises is what the JAX package refuses too: the slab ocean
    with vertical groups.  A group's series take its bands."""
    from speedy_ml_tpu_torch.esn.domain import vert_specs
    _, tl = layouts
    _, (tt, _, _, tm), tgcm = nature_pair
    with pytest.raises(NotImplementedError, match="vertical localization"):
        training.train_hybrid(tgcm, tl, tt, tm, HYPER, 0, ocean=True,
                              num_vert_levels=2, device="cpu")
    top, bot = vert_specs(8, 2, 1)
    cls = tl.classes[0]
    full = training.pack_class_series(tl, cls, tt)
    xi, yi = cls.input_shape
    assert training.pack_class_series(tl, cls, tt, zspec=top).shape[2] \
        == 4 * 5 * xi * yi + xi * yi
    assert training.pack_class_series(tl, cls, tt, zspec=bot).shape[2] \
        == 4 * 5 * xi * yi + 4 * xi * yi
    assert full.shape[2] == 4 * 8 * xi * yi + 4 * xi * yi
    xc, yc = cls.core_shape
    assert training.pack_class_model_series(tl, cls, tm, zspec=top) \
        .shape[2] == 4 * 4 * xc * yc

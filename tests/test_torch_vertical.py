"""Port parity of vertical localization (A10c-2): vertical groups of
levels, each (horizontal class, group) a pack of its own, against the
JAX package at T10 with 8 levels in float64 on the CPU.

Two groups with an overlap of one level (num_vert_levels=2,
vert_overlap=1): cores [0, 4) and [4, 8), inputs [0, 5) and [3, 8); only
the bottom group carries the logp/precip/sst blocks, both TISR.
- vert_specs, full_column_spec and the bands' index tables (K3's
  feedback and local-model gathers, K2's store): the tables gather what
  the JAX pack_vector packs from the group's slice, exactly, and the
  cores of every group tile the grid once;
- train_hybrid(num_vert_levels=2, vert_overlap=1) on synthetic truth and
  forecasts (tests/test_torch_training.py's, noise off, the JAX
  package's reservoirs: each pack's seed maps to its fold_in key):
  Wout within 1e-8 of its scale at a ridge of 1e-2, the standardizers
  1e-12;
- on a 32-region layout without a halo (one class, two packs, so that
  the JAX package compiles little): two coupled cycles of the localized
  hybrid (the port's packs converted
  from the JAX ones) and start_prediction: 1e-9 of each variable's
  signal, as tests/test_torch_cycle.py holds the main path;
- the localized checkpoint: saved by each package and loaded by the
  other, every parameter and zspec the same, and the port's loaded twin
  cycles bit for bit as the hybrid it was saved from;
- the slab ocean with vertical groups raises, as in the JAX package.
One JAX build (the GCM, the trained hybrid and its cycle) serves the
module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.data import checkpoint as jck
from speedy_ml_tpu.esn import domain as jdomain
from speedy_ml_tpu.esn import reservoir as jres
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.hybrid import training as jtraining
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu_torch.convert import boundary_from_numpy, params_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data import checkpoint as tck
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.esn import domain
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid import training
from speedy_ml_tpu_torch.hybrid.build import derive_seed
from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere, OceanPack
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
NZ = 8
# the bands' tables on the 128-region layout with a halo of one point
# (three classes); the trained hybrid on 32 regions of 4 x 4 points
# without a halo (one class, two packs): the JAX trainer and cycle
# compile once a pack's shape
N_REGIONS = 128
TRAIN_REGIONS, TRAIN_HALO = 32, 0
GROUPS, OVERLAP = 2, 1
SEED = 5
T = 24
HYPER = ESNHyper(m=432, deg=3, sigma=0.5, leakage=1.0, beta_res=0.1,
                 beta_model=1.0, noise_mag=0.0)
KW = dict(n_discard=6, n_batches=4)
F64 = torch.float64


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(got, ref):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _close(got, ref, rtol, variable=0):
    """|got - ref| <= rtol * signal + 2 ulps of ref; the signal of each
    variable (labels broadcast to ref) its largest |ref - mean|."""
    ref, got = np.asarray(ref), _np(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    label = np.broadcast_to(variable, ref.shape)
    signal = np.empty(ref.shape)
    for v in np.unique(label):
        sel = label == v
        signal[sel] = np.abs(ref[sel] - ref[sel].mean()).max()
    tol = rtol * signal + 2 * np.finfo(ref.dtype).eps * np.abs(ref)
    err = np.abs(got - ref)
    assert (err <= tol).all(), f"err {err.max():.3e}, tol {tol.min():.3e}"


def synth(seed, T):
    """Fields in physical ranges (tests/test_torch_training.py's
    synth_truth, 8 levels)."""
    rng = np.random.default_rng(seed)
    u = lambda shape, lo, hi: rng.uniform(lo, hi, size=shape)
    g = (16, 32)
    atmo = np.stack([u((T, NZ) + g, 220.0, 290.0),
                     u((T, NZ) + g, -30.0, 30.0),
                     u((T, NZ) + g, -20.0, 20.0),
                     u((T, NZ) + g, 0.0, 12.0)], axis=1)
    return dict(atmo=atmo, logp=u((T,) + g, -0.1, 0.1),
                precip=u((T,) + g, 0.0, 2e-4), sst=u((T,) + g, 271.0, 302.0),
                tisr=u((T,) + g, 0.0, 420.0))


@pytest.fixture(scope="module")
def trained():
    """The JAX package's localized hybrid trained on synthetic data, the
    port's trained with the JAX reservoirs, and the port's hybrid of the
    JAX packs (converted), all on a T10L8 GCM (2 steps a window)."""
    jg = JGeometry(**GEOM)
    jgcm = JGCM(jg, dtype=jnp.float64, nsteps_day=8,
                bd=jsynthetic(jg, JST(jg, dtype=jnp.float64)))
    jl = jdomain.RegionLayout(jg, n_regions=TRAIN_REGIONS,
                              overlap=TRAIN_HALO)
    g = Geometry(**GEOM)
    tgcm = GCM(g, dtype=F64, nsteps_day=8, device="cpu",
               bd=boundary_from_numpy(jgcm.bd, device="cpu", dtype=F64))
    tl = domain.RegionLayout(g, n_regions=TRAIN_REGIONS, overlap=TRAIN_HALO)
    truth, model = synth(1, T), synth(2, T)
    model = dict(atmo=model["atmo"], logp=model["logp"])
    key = jax.random.PRNGKey(3)
    jhyb = jtraining.train_hybrid(
        jgcm, jl, truth, model, jres.ESNHyper(**dataclasses.asdict(HYPER)),
        key, num_vert_levels=GROUPS, vert_overlap=OVERLAP,
        dtype=jnp.float64, **KW)
    # pack (i, g)'s seed in the port -> its key in the JAX package
    keys = {derive_seed(SEED, 16 * i + gi): jax.random.fold_in(key,
                                                              16 * i + gi)
            for i in range(len(tl.classes)) for gi in range(GROUPS)}

    def generate(seed, n_regions, n_inputs, hyper, radius,
                 dtype=torch.float32, topology="shift", device=None, **kw):
        cols, vals, win, shifts = jres.generate(
            keys[seed], n_regions, n_inputs,
            jres.ESNHyper(**dataclasses.asdict(hyper)), np.asarray(radius),
            dtype=jnp.float64, topology=topology)
        return (torch.as_tensor(np.array(cols), dtype=torch.int32),
                torch.as_tensor(np.array(vals), dtype=dtype),
                torch.as_tensor(np.array(win), dtype=dtype),
                None if shifts is None else tuple(int(s) for s in shifts))

    mp = pytest.MonkeyPatch()
    mp.setattr(training, "generate", generate)
    try:
        thyb = training.train_hybrid(tgcm, tl, truth, model, HYPER, SEED,
                                     num_vert_levels=GROUPS,
                                     vert_overlap=OVERLAP, device="cpu",
                                     dtype=F64, **KW)
    finally:
        mp.undo()
    atmo = jax.tree_util.tree_map(np.asarray, jhyb.params[0])
    conv = HybridAtmosphere(tgcm, tl, params_from_numpy(
        atmo, tl, HYPER, device="cpu", dtype=F64,
        zspecs=[tuple(p.zspec) for p in jhyb.packs]), device="cpu")
    return dict(jhyb=jhyb, thyb=thyb, conv=conv, truth=truth, model=model,
                jl=jl, tl=tl, jgcm=jgcm, tgcm=tgcm)


def test_vert_specs_and_full_column():
    for nz, n, o in ((8, 2, 1), (8, 4, 0), (8, 2, 3), (6, 3, 1)):
        assert domain.vert_specs(nz, n, o) == jdomain.vert_specs(nz, n, o)
    assert domain.full_column_spec(8) == jdomain.full_column_spec(8)
    assert domain.FULL_COLUMN is None
    with pytest.raises(ValueError, match="not divisible"):
        domain.vert_specs(8, 3, 1)
    top, bot = domain.vert_specs(8, 2, 1)
    assert (top.zi0, top.zi1, bot.zi0, bot.zi1) == (0, 5, 3, 8)
    assert domain.band(top, 8, core=False) == (0, 5)
    assert domain.band(bot, 8, core=True) == (4, 8)
    assert domain.band(None, 8, core=True) == (0, 8)


def test_band_tables_gather_the_jax_vectors():
    """Each group's feedback, local-model and store tables against the
    port's pack_vector of the group's slice (tests/test_torch_domain.py
    holds it to the JAX package's) on seeded fields, every class of the
    128-region layout; the first pack's input table also against the JAX
    pack_vector itself."""
    jl = jdomain.RegionLayout(JGeometry(**GEOM), n_regions=N_REGIONS)
    tl = domain.RegionLayout(Geometry(**GEOM), n_regions=N_REGIONS)
    rng = np.random.default_rng(4)
    atmo = rng.normal(size=(4, NZ, 16, 32))
    f2 = [rng.normal(size=(16, 32)) for _ in range(4)]
    flat = np.concatenate([atmo.ravel()] + [f.ravel() for f in f2])
    specs = jdomain.vert_specs(NZ, GROUPS, OVERLAP)
    tspecs = domain.vert_specs(NZ, GROUPS, OVERLAP)
    t = torch.as_tensor
    for ci, (jc, tc) in enumerate(zip(jl.classes, tl.classes)):
        for zs, tz in zip(specs, tspecs):
            b = tz.bottom
            pk = tl.pack_vector
            ref = pk(tc, t(atmo[:, tz.zi0:tz.zi1]),
                     *(t(f) if b or k == 3 else None
                       for k, f in enumerate(f2)))
            if ci == 0 and not b:
                jref = jl.pack_vector(jc, jnp.asarray(atmo[:, zs.zi0:zs.zi1]),
                                      tisr=jnp.asarray(f2[3]))
                np.testing.assert_array_equal(_np(ref), np.asarray(jref))
            idx = tl.pack_table(tc, 4, NZ, logp=b, precip=b, sst=b,
                                tisr=True,
                                levels=domain.band(tz, NZ, core=False))
            np.testing.assert_array_equal(flat[idx], _np(ref))
            core = pk(tc, t(atmo[:, tz.z0:tz.z1]),
                      logp=t(f2[0]) if b else None,
                      precip=t(f2[1]) if b else None, core_only=True)
            np.testing.assert_array_equal(flat[tl.core_table(tc, 4, NZ, tz)],
                                          _np(core))
    classes = [c for c in tl.classes for _ in tspecs]
    zs = [z for _ in tl.classes for z in tspecs]
    idx = tl.core_output_index(classes, 4, NZ, zs)
    table = tl.core_source_table(classes, 4, NZ, zs)
    vecs = np.concatenate([flat[i].ravel() for i in idx])
    np.testing.assert_array_equal(vecs[table], flat[:table.size])
    with pytest.raises(ValueError, match="tile the grid"):
        tl.core_output_index(classes, 4, NZ, [tspecs[1]] * len(classes))


def test_train_hybrid_with_vertical_groups_matches_jax(trained):
    jhyb, thyb = trained["jhyb"], trained["thyb"]
    assert len(thyb.packs) == len(jhyb.packs) == GROUPS
    for jp, tp in zip(jhyb.packs, thyb.packs):
        assert tuple(tp.zspec) == tuple(jp.zspec)
        assert tp.cls.name == jp.cls.name
        assert tp.res.wout.shape == jp.res.wout.shape
        assert _rel(tp.res.wout, jp.res.wout) <= 1e-8
        for k in ("comp_mean", "comp_std", "in_mean", "out_std"):
            assert _rel(getattr(tp.std, k), getattr(jp.std, k)) <= 1e-12
    top, bot = thyb.packs[0], thyb.packs[1]
    assert not top.bottom and bot.bottom
    assert top.res.n_speedy < bot.res.n_speedy
    assert top.res.n_outputs < bot.res.n_outputs


def _cycles(jhyb, thyb, js, ts, n=2):
    date = ModelDate(1990, 1, 1)
    variables = np.arange(4).reshape(4, 1, 1, 1)
    for _ in range(n):
        js, jd = jhyb.cycle(js, jnp.asarray(date.month - 1),
                            jnp.asarray(date.tmonth), jnp.asarray(date.tyear))
        ts, td = thyb.cycle(ts, date.month - 1, date.tmonth, date.tyear)
        for jc, tc in zip(js.classes, ts.classes):
            for k in ("x", "feedback", "local_model"):
                _close(getattr(tc, k), getattr(jc, k), 1e-9)
        for k in ("atmo", "speedy_atmo"):
            _close(td[k], jd[k], 1e-9, variables)
        for k in ("logp", "precip", "speedy_logp"):
            _close(td[k], jd[k], 1e-9)
        date = date.advance_hours(6)
    assert bool(ts.safe) and bool(js.safe)
    return ts, td


def test_localized_cycles_and_start_prediction_match_jax(trained):
    jhyb, conv, truth, model = (trained["jhyb"], trained["conv"],
                                trained["truth"], trained["model"])
    sst = truth["sst"][-1]
    js = jhyb.init_state(jnp.asarray(sst))
    ts = conv.init_state(sst)
    _cycles(jhyb, conv, js, ts)
    sync = {k: v[-4:] for k, v in truth.items()}
    nxt = {k: v[-1] for k, v in model.items()}
    js = jhyb.start_prediction(sync, nxt, jnp.asarray(sst))
    ts = conv.start_prediction(sync, nxt, sst)
    for jc, tc in zip(js.classes, ts.classes):
        for k in ("x", "feedback", "local_model"):
            _close(getattr(tc, k), getattr(jc, k), 1e-9)
    _cycles(jhyb, conv, js, ts, n=1)


def _same_params(a, b):
    assert len(a.packs) == len(b.packs)
    for p, q in zip(a.packs, b.packs):
        assert p.cls.name == q.cls.name
        assert tuple(p.zspec) == tuple(q.zspec)
        for k in ("vals", "win_vals", "wout", "mean", "std"):
            np.testing.assert_array_equal(_np(getattr(p.res, k)),
                                          _np(getattr(q.res, k)))
        for k in ("comp_mean", "comp_std", "in_mean", "in_std", "out_mean",
                  "out_std"):
            np.testing.assert_array_equal(_np(getattr(p.std, k)),
                                          _np(getattr(q.std, k)))


def test_localized_checkpoint_moves_both_ways(trained, tmp_path):
    jhyb, conv, tgcm, jgcm = (trained["jhyb"], trained["conv"],
                              trained["tgcm"], trained["jgcm"])
    jck.save_hybrid(jhyb, str(tmp_path / "from_jax"))
    back = tck.load_hybrid(tgcm, trained["tl"], str(tmp_path / "from_jax"),
                           dtype=F64, device="cpu")
    _same_params(back, conv)
    tck.save_hybrid(conv, str(tmp_path / "from_port"))
    jback = jck.load_hybrid(jgcm, trained["jl"], str(tmp_path / "from_port"),
                            dtype=jnp.float64)
    _same_params(jback, jhyb)
    sst = trained["truth"]["sst"][-1]
    a, b = conv.init_state(sst), back.init_state(sst)
    for _ in range(2):
        a, da = conv.cycle(a, 0, 0.5, 0.05)
        b, db = back.cycle(b, 0, 0.5, 0.05)
    for k in ("atmo", "logp", "precip", "speedy_atmo", "speedy_logp"):
        assert torch.equal(da[k], db[k])
    # a malformed zspec is refused; the packs of an unlocalized
    # checkpoint keep zspec None
    meta = tck.read_meta(str(tmp_path / "from_port"))
    assert tck.read_zspec(meta, 1) == tuple(conv.packs[1].zspec)
    with pytest.raises(ValueError, match="zspec_0"):
        tck.read_zspec(dict(zspec_0=[0, 4, 0]), 0)
    assert tck.read_zspec({}, 0) is None


def test_slab_ocean_with_vertical_groups_raises(trained):
    conv, tl, truth, model = (trained["conv"], trained["tl"],
                              trained["truth"], trained["model"])
    with pytest.raises(NotImplementedError, match="vertical localization"):
        training.train_hybrid(trained["tgcm"], tl, truth, model, HYPER, 0,
                              ocean=True, num_vert_levels=GROUPS,
                              vert_overlap=OVERLAP, device="cpu")
    p = conv.packs[1]
    op = OceanPack(cls=p.cls, res=p.res, hyper=p.hyper,
                   idx_map=np.zeros(4, dtype=np.int32),
                   mean_sst=torch.zeros((p.cls.count, 1), dtype=F64),
                   std_sst=torch.ones((p.cls.count, 1), dtype=F64))
    with pytest.raises(NotImplementedError, match="vertical localization"):
        HybridAtmosphere(conv.gcm, tl, conv.packs, ocean_packs=[op],
                         device="cpu")
    # one group: vert_overlap has no effect, as in the JAX package
    specs_one = training.vert_specs(NZ, 1, 3)
    assert len(specs_one) == 1 and specs_one[0] == domain.full_column_spec(NZ)

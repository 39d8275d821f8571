"""Port parity of the hybrid cycle: ML-only and coupled.

The JAX package builds an untrained hybrid at T10 (32x16 grid, 128
regions, m=300); its parameters go through
speedy_ml_tpu_torch.convert.params_from_numpy into the port, and both
run cycles from the same state and SST.  No GCM is needed for an ml_only
hybrid: a namespace with geom/dtype/nsteps_day stands in on both sides.
The coupled cycle (ml_only=False) runs the port's GCM on the JAX
package's synthetic boundaries (converted), with 2 GCM steps per window
(nsteps_day=8), in float64: everything it returns is held at rtol 1e-9
of each variable's signal.

Tolerances are a fraction of each variable's signal, its largest
departure from its mean (a variable: one level of one field, or one
component of the feedback vector), so that the 250 K temperature offset and the
~300 K SST do not widen them, plus two ulps of the value the model
stores (the grid value a feedback entry came from): f64 1e-10; f32 with
bf16 Wout 1e-4 (XLA's and PyTorch's f32 tanh differ in the last bits).
The written .npz (float32 on disk) is held at rtol 1e-5.
"""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.data.calendar import ModelDate as JModelDate
from speedy_ml_tpu.hybrid.build import build_untrained_hybrid as jbuild
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.hybrid.driver import run_prediction as jrun
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu_torch.convert import boundary_from_numpy, params_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
from speedy_ml_tpu_torch.esn.standardize import component_expansion
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid.build import build_untrained_hybrid
from speedy_ml_tpu_torch.hybrid.driver import run_prediction
from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
from speedy_ml_tpu_torch.physics import land_sea
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
N_REGIONS, M = 128, 300


def _sst(geom):
    """synthetic_boundary_data's month-0 SST."""
    lat = geom.lat_radians
    ones = np.ones((geom.nlat, geom.nlon))
    return np.maximum(273.0 + 27.0 * np.cos(lat)[:, None] ** 2 * ones
                      + 2.0 * np.sin(lat)[:, None]
                      * np.cos(2 * np.pi * 0.5 / 12) * ones, 271.4)


def _pair(jdtype, tdtype, bf16):
    jgcm = types.SimpleNamespace(geom=JGeometry(**GEOM), dtype=jdtype,
                                 nsteps_day=36)
    jhyb = jbuild(jgcm, n_regions=N_REGIONS, m=M, key=jax.random.PRNGKey(0),
                  ml_only=True, radius_iters=30)
    if bf16:
        jhyb.cast_wout_bf16()
    geom = Geometry(**GEOM)
    layout = RegionLayout(geom, n_regions=N_REGIONS)
    atmo = jax.tree_util.tree_map(np.asarray, jhyb.params[0])
    packs = params_from_numpy(atmo, layout, ESNHyper(m=M), device="cpu",
                              dtype=tdtype)
    tgcm = types.SimpleNamespace(geom=geom, dtype=tdtype, nsteps_day=36)
    thyb = HybridAtmosphere(tgcm, layout, packs, ml_only=True, device="cpu")
    return jhyb, thyb


@pytest.fixture(scope="module")
def pair_f64():
    return _pair(jnp.float64, torch.float64, bf16=False)


def _close(got, ref, rtol, variable=0, stored=None):
    """|got - ref| <= rtol * signal + 2 ulps of `stored` (default ref).

    `variable` labels each element of ref with its variable (an int array
    that broadcasts to ref; 0: one variable); the signal of a variable is
    its largest |ref - mean|."""
    ref = np.asarray(ref)
    got = got.detach().numpy()
    label = np.broadcast_to(variable, ref.shape)
    signal = np.empty(ref.shape)
    for v in np.unique(label):
        sel = label == v
        signal[sel] = np.abs(ref[sel] - ref[sel].mean()).max()
    stored = ref if stored is None else stored
    tol = rtol * signal + 2 * np.finfo(ref.dtype).eps * np.abs(stored)
    err = np.abs(got - ref)
    worst = np.unravel_index(np.argmax(err - tol), err.shape)
    assert (err <= tol).all(), (
        f"{int((err > tol).sum())} of {err.size} beyond tolerance; worst at "
        f"{worst}: err {err[worst]:.3e}, tol {tol[worst]:.3e}")


def _run_cycles(jhyb, thyb, jdtype, rtol, n=3):
    sst = _sst(thyb.geom)
    js = jhyb.init_state(jnp.asarray(sst, dtype=jdtype))
    ts = thyb.init_state(sst)
    date = ModelDate(1990, 1, 1)
    comps = [component_expansion(*p.cls.input_shape, 4, thyb.nz, logp=True,
                                 precip=True, sst=True, tisr=True)
             for p in thyb.packs]
    levels = np.arange(4 * thyb.nz).reshape(4, thyb.nz, 1, 1)
    for _ in range(n):
        js, jd = jhyb.cycle(js, jnp.asarray(date.month - 1),
                            jnp.asarray(date.tmonth, dtype=jdtype),
                            jnp.asarray(date.tyear, dtype=jdtype))
        ts, td = thyb.cycle(ts, date.month - 1, date.tmonth, date.tyear)
        for jc, tc, p, comp in zip(js.classes, ts.classes, thyb.packs,
                                   comps):
            _close(tc.x, jc.x, rtol)
            grid = (np.asarray(jc.feedback) * p.std.in_std.numpy()
                    + p.std.in_mean.numpy())
            _close(tc.feedback, jc.feedback, rtol, comp, stored=grid)
        _close(td["atmo"], jd["atmo"], rtol, levels)
        for k in ("logp", "precip"):
            _close(td[k], jd[k], rtol)
        date = date.advance_hours(6)
    assert ts.step == n and bool(ts.safe)
    # the run is not trivial: the readout moved T away from its mean
    assert float(td["atmo"][0].std()) > 1e-3


def test_three_cycles_f64_match_jax(pair_f64):
    jhyb, thyb = pair_f64
    assert [p.cls.count for p in thyb.packs] == [16, 96, 16]
    _run_cycles(jhyb, thyb, jnp.float64, rtol=1e-10)


def test_three_cycles_f32_bf16_match_jax():
    jhyb, thyb = _pair(jnp.float32, torch.float32, bf16=True)
    assert all(p.res.wout.dtype == torch.bfloat16 for p in thyb.packs)
    _run_cycles(jhyb, thyb, jnp.float32, rtol=1e-4)


def test_cast_wout_bf16_equals_converted_bf16(pair_f64):
    """The port's own cast rounds like JAX's astype(bfloat16)."""
    jhyb, thyb = pair_f64
    ref = [np.asarray(p.res.wout.astype(jnp.bfloat16).astype(jnp.float32))
           for p in jhyb.packs]
    port = HybridAtmosphere(thyb.gcm, thyb.layout, thyb.packs, ml_only=True,
                            device="cpu").cast_wout_bf16()
    for p, r in zip(port.packs, ref):
        np.testing.assert_array_equal(p.res.wout.float().numpy(), r)


def test_run_prediction_writes_same_npz(pair_f64, tmp_path):
    jhyb, thyb = pair_f64
    sst = _sst(thyb.geom)
    jrun(jhyb, jhyb.init_state(jnp.asarray(sst)), JModelDate(1990, 1, 1), 3,
         output_path=str(tmp_path / "jax" / "pred"))
    final, dates = run_prediction(thyb, thyb.init_state(sst),
                                  ModelDate(1990, 1, 1), 3,
                                  output_path=str(tmp_path / "port" / "pred"))
    assert len(dates) == 3 and final.step == 3
    ref = np.load(tmp_path / "jax" / "pred.npz")
    got = np.load(tmp_path / "port" / "pred.npz")
    assert sorted(got.files) == sorted(ref.files) == ["atmo", "logp",
                                                      "precip", "sst"]
    for k in ref.files:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[k]).max())


@pytest.fixture(scope="module")
def coupled_pair():
    jg = JGeometry(**GEOM)
    jgcm = JGCM(jg, dtype=jnp.float64, nsteps_day=8,
                bd=jsynthetic(jg, JST(jg, dtype=jnp.float64)))
    jhyb = jbuild(jgcm, n_regions=N_REGIONS, m=M, key=jax.random.PRNGKey(0),
                  ml_only=False, radius_iters=30)
    geom = Geometry(**GEOM)
    tgcm = GCM(geom, dtype=torch.float64, nsteps_day=8,
               bd=boundary_from_numpy(jgcm.bd, device="cpu",
                                      dtype=torch.float64), device="cpu")
    layout = RegionLayout(geom, n_regions=N_REGIONS)
    atmo = jax.tree_util.tree_map(np.asarray, jhyb.params[0])
    packs = params_from_numpy(atmo, layout, ESNHyper(m=M), device="cpu",
                              dtype=torch.float64)
    thyb = HybridAtmosphere(tgcm, layout, packs, ml_only=False, device="cpu")
    return jhyb, thyb


def test_two_coupled_cycles_f64_match_jax(coupled_pair):
    jhyb, thyb = coupled_pair
    assert jhyb.gcm_steps == thyb.gcm_steps == 2
    assert all(p.res.n_speedy > 0 for p in thyb.packs)
    sst = _sst(thyb.geom)
    js = jhyb.init_state(jnp.asarray(sst))
    ts = thyb.init_state(sst)
    assert ts.safe.dtype == torch.bool and ts.safe.ndim == 0
    date = ModelDate(1990, 1, 1)
    levels = np.arange(4 * thyb.nz).reshape(4, thyb.nz, 1, 1)
    variables = np.arange(4).reshape(4, 1, 1, 1)
    rtol = 1e-9
    for _ in range(2):
        js, jd = jhyb.cycle(js, jnp.asarray(date.month - 1),
                            jnp.asarray(date.tmonth),
                            jnp.asarray(date.tyear))
        ts, td = thyb.cycle(ts, date.month - 1, date.tmonth, date.tyear)
        for jc, tc in zip(js.classes, ts.classes):
            _close(tc.x, jc.x, rtol)
            _close(tc.feedback, jc.feedback, rtol)
            _close(tc.local_model, jc.local_model, rtol)
        _close(td["atmo"], jd["atmo"], rtol, levels)
        # SPEEDY's humidity is rounding noise on its top levels: its
        # signal is taken over the whole variable
        _close(td["speedy_atmo"], jd["speedy_atmo"], rtol, variables)
        for k in ("logp", "precip", "speedy_logp"):
            _close(td[k], jd[k], rtol)
        date = date.advance_hours(6)
    assert bool(ts.safe) and bool(js.safe)
    # the window moved the forecast away from the injected state
    assert float((td["speedy_atmo"] - td["atmo"]).abs().max()) > 1e-3


def test_persist_surface_cycles_carry_the_surface(coupled_pair):
    """persist_surface runs (JAX parity: tests/test_torch_land_sea.py):
    four cycles from step 0 carry the surface and the sums, which grow
    over three windows and are zero after the coupling on the fourth;
    speedy_window with the climatology as its carry is the window
    without one, bit for bit, and with a warmer carry it is not."""
    _, thyb = coupled_pair
    h = HybridAtmosphere(thyb.gcm, thyb.layout, thyb.packs, ml_only=False,
                         device="cpu")
    h.persist_surface = True
    s = h.init_state(_sst(h.geom))
    date = ModelDate(1990, 1, 1)
    sums = []
    for i in range(4):
        s, d = h.cycle(s, date.month - 1, date.tmonth, date.tyear)
        assert s.step == i + 1 and bool(s.safe)
        sums.append(float(s.fluxes.hflux_s.abs().max()))
        for k in s.sfc.__dataclass_fields__:
            assert bool(torch.isfinite(getattr(s.sfc, k)).all()), k
        date = date.advance_hours(6)
    assert 0 < sums[0] < sums[1] < sums[2] and sums[3] == 0.0
    imon, fmon, tyear = 0, 0.5, 0.05
    carry = land_sea.init_surface_state(h.gcm.bd, imon, fmon)
    spec, _ = h.inject_to_speedy(d["atmo"], d["logp"])
    a = h.speedy_window(spec, s.sst_grid, imon, fmon, tyear)
    b = h.speedy_window(spec, s.sst_grid, imon, fmon, tyear,
                        sfc_carry=carry)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    warm = dataclasses.replace(carry, tice_om=carry.tice_om + 5.0)
    c = h.speedy_window(spec, s.sst_grid, imon, fmon, tyear, sfc_carry=warm)
    assert not torch.equal(a[2].hflux_i, c[2].hflux_i)


def test_gcm_sst_anomaly_options_match_jax(coupled_pair):
    """GCM(sstan_monthly=, sstan_year0=, sstom12=) builds on the port as
    in the JAX package: the anomaly at a date (the forint of its three
    months, clamped at the series' ends) at 1e-12, the ocean model's
    climatology and the elnino weights on the GCM's device."""
    jhyb, thyb = coupled_pair
    jgcm, tgcm = jhyb.gcm, thyb.gcm
    rng = np.random.default_rng(12)
    sstan = rng.normal(0, 1.0, (14, tgcm.geom.nlat, tgcm.geom.nlon))
    om12 = np.asarray(jgcm.bd.sst12) + 0.5
    flags = dict(icsea=4, isstan=1)
    jg = JGCM(jgcm.geom, dtype=jnp.float64, nsteps_day=8, bd=jgcm.bd,
              cpl_flags=type(jgcm.cpl)(**flags), sstan_monthly=sstan,
              sstan_year0=1989, sstom12=om12)
    tg = GCM(tgcm.geom, dtype=torch.float64, nsteps_day=8, bd=tgcm.bd,
             cpl_flags=land_sea.CplFlags(**flags), sstan_monthly=sstan,
             sstan_year0=1989, sstom12=om12, device="cpu")
    assert tg.sstan_year0 == 1989
    np.testing.assert_array_equal(tg.sstom12.numpy(), om12)
    np.testing.assert_array_equal(tg.wsst_ob.numpy(),
                                  np.asarray(jg.wsst_ob))
    for d in ((1989, 1, 1), (1989, 6, 20), (1990, 2, 10), (1991, 5, 1)):
        _close(tg.sstan_for(ModelDate(*d)),
               jg.sstan_for(JModelDate(*d)), 1e-12)


def test_safety_gate_holds_speedy_and_stops_driver(coupled_pair):
    """An unphysical assembled state sets safe=False, keeps SPEEDY's
    output finite (the injected grids stand in) and stops run_prediction
    by cycle 2 (ppo_iogrid.f90:563-577, parallelmain.f90:268-270)."""
    _, thyb = coupled_pair
    packs = [p._replace(res=dataclasses.replace(p.res, wout=p.res.wout * 1e7))
             for p in thyb.packs]
    hyb = HybridAtmosphere(thyb.gcm, thyb.layout, packs, ml_only=False,
                           device="cpu")
    hstate = hyb.init_state(_sst(hyb.geom))
    hstate = dataclasses.replace(hstate, classes=tuple(
        dataclasses.replace(cs, feedback=torch.ones_like(cs.feedback))
        for cs in hstate.classes))
    hstate2, diag = hyb.cycle(hstate, 0, 0.5, 0.05)
    assert not bool(hstate2.safe), "gate should trip on unphysical state"
    assert bool(torch.isfinite(diag["speedy_atmo"]).all())
    assert torch.equal(diag["speedy_atmo"], diag["atmo"])
    assert bool(torch.isfinite(hstate2.sst_grid).all())
    _, dates = run_prediction(hyb, hstate, ModelDate(1990, 1, 1), 8)
    assert len(dates) <= 2, f"driver ran {len(dates)} cycles past the gate"


def test_untrained_coupled_build_matches_the_layout(coupled_pair):
    _, thyb = coupled_pair
    hyb = build_untrained_hybrid(thyb.gcm, n_regions=N_REGIONS, m=M,
                                 radius_iters=5, device="cpu")
    assert not hyb.ml_only and hyb.gcm_steps == 2
    for p, q in zip(hyb.packs, thyb.packs):
        xc, yc = p.cls.core_shape
        assert p.res.n_speedy == p.res.n_outputs - xc * yc
        assert p.res.wout.shape == q.res.wout.shape
    with pytest.raises(ValueError, match="needs a GCM"):
        build_untrained_hybrid(None, n_regions=N_REGIONS, m=M,
                               ml_only=False, device="cpu")


def test_unported_options_raise(pair_f64, coupled_pair, monkeypatch):
    """No option of the JAX package's cycle raises any more: the sharded
    cycle (shard_gcm=False and, with the GCM sharded, the default) and
    ml_only=False run, so do SPPT, RDF and cgrate, the climatology tables,
    emit_components, truth_provider and time_mean_path
    (tests/test_torch_cycle_options.py), cycles_per_dispatch > 1
    (tests/test_torch_dispatch.py) and the captured loop on a mesh
    (tests/test_torch_mesh_loop.py); what stays is the checks of the
    hybrid's arguments."""
    _, thyb = pair_f64
    _, chyb = coupled_pair
    with pytest.raises(ValueError, match="needs a GCM"):
        HybridAtmosphere(thyb.gcm, thyb.layout, thyb.packs, ml_only=False,
                         device="cpu")
    # the slab ocean runs (tests/test_torch_ocean.py); its packs, like the
    # atmosphere's, must be on the hybrid's device
    from speedy_ml_tpu_torch.esn.ocean import ocean_index_map
    from speedy_ml_tpu_torch.hybrid.model import OceanPack
    on_meta = []
    for p in thyb.packs:
        xc, yc = p.cls.core_shape
        res = dataclasses.replace(p.res, wout=torch.zeros(
            (p.cls.count, xc * yc, p.res.n), device="meta"))
        on_meta.append(OceanPack(
            cls=p.cls, res=res, hyper=p.hyper,
            idx_map=ocean_index_map(p.cls, thyb.nz),
            mean_sst=torch.zeros((p.cls.count, 1), dtype=torch.float64),
            std_sst=torch.ones((p.cls.count, 1), dtype=torch.float64)))
    with pytest.raises(ValueError, match="ocean pack .*lives on meta"):
        HybridAtmosphere(thyb.gcm, thyb.layout, thyb.packs, ml_only=True,
                         ocean_packs=on_meta, device="cpu")
    with pytest.raises(ValueError, match="base_sst must be a tensor on cpu"):
        HybridAtmosphere(thyb.gcm, thyb.layout, thyb.packs, ml_only=True,
                         base_sst=np.zeros(3), device="cpu")
    from speedy_ml_tpu_torch.parallel.mesh import Mesh
    for h in (thyb, chyb):
        # the sharded cycle (tests/test_torch_sharded.py), with the GCM
        # sharded too by default (tests/test_torch_sharded_gcm.py), on a
        # copy of the hybrid and of its GCM; the captured loop runs on a
        # mesh too (tests/test_torch_mesh_loop.py)
        sharded = copy.copy(h)
        sharded.set_mesh(Mesh(["cpu"] * 2))
        assert h.mesh is None and sharded.mesh is not None
        if not h.ml_only:
            assert h.gcm.mesh is None and sharded.gcm.mesh is not None
        s = h.init_state(_sst(h.geom))
        final, dates = run_prediction(h, s, ModelDate(1990, 1, 1), 1,
                                      cycles_per_dispatch=2)
        assert len(dates) == 1 and final.step == 1
        meshed = copy.copy(h)
        meshed.set_mesh(Mesh(["cpu"] * 2), shard_gcm=False)
        final, dates = run_prediction(
            meshed, meshed.init_state(_sst(h.geom)), ModelDate(1990, 1, 1),
            1, cycles_per_dispatch=2)
        assert len(dates) == 1 and len(final.classes[0].x) == 2
    g, bd = chyb.gcm.geom, chyb.gcm.bd
    # without bd the GCM reads the boundary files, from $SPEEDY_ML_BC_PATH
    # when no bc_path is given (tests/test_torch_boundaries.py)
    monkeypatch.delenv("SPEEDY_ML_BC_PATH", raising=False)
    with pytest.raises(FileNotFoundError, match="boundary files"):
        GCM(g, dtype=torch.float64, device="cpu")
    # the optional physics is ported (tests/test_torch_optional_physics.py):
    # the options are taken, and RDF's patterns are checked
    assert GCM(g, dtype=torch.float64, device="cpu", bd=bd,
               sppt_on=True).sppt is not None
    assert GCM(g, dtype=torch.float64, device="cpu", bd=bd,
               cgrate_on=True).dyn.cgrate_on
    with pytest.raises(ValueError, match="randfh"):
        type(chyb.gcm.phys)(g, chyb.gcm.const, randfh=np.zeros(1),
                            device="cpu")
    # m-sharding is ported (tests/test_torch_sharded_gcm.py); a mesh must
    # start on the transform's device
    with pytest.raises(ValueError, match="first device"):
        copy.copy(chyb.gcm.sht).set_mesh(Mesh(["meta", "cpu"]))

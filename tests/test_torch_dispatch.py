"""The batched prediction loop (run_prediction with cycles_per_dispatch >
1, hybrid/graph.py) on the CPU at T10 (32 x 16, 8 levels, 128 regions,
m = 300) in float64, with 2 GCM steps a window.

On the CPU a dispatch runs the cycle's body eagerly through the plain
versions (the card replays captured CUDA graphs of the same body:
chip_smoke.py phase 17).  Cases and tolerances:
  - cycles_per_dispatch 3 over 7 cycles (dispatches of 3, 3, 1) against
    the per-cycle loop from the same state, for the coupled cycle (from
    12:00, so a dispatch crosses a day), the ML-only cycle, the
    persistent surface from step 0 (its coupler fires on step 3), the
    slab ocean at SLAB_STRIDE 3 (slab steps on 2 and 5; the stride set on
    the instance as tests/test_torch_ocean_cycle.py does), ML-only and
    under the persistent coupled cycle, vertical groups (two, ML-only,
    trained by the port's train_hybrid on a seeded synthetic truth), and
    the options (both tables, a bias ramp, emit_components): the stream,
    the time means, the dates and the final state within 1e-12 of each
    array's largest magnitude;
  - the ML-only batched stream and time means against the JAX package's
    run_prediction(cycles_per_dispatch=3), with the hybrids of
    tests/test_torch_cycle_options.py: rtol 1e-5, the per-cycle path's
    run_prediction tolerance (the stream is float32 on disk; the JAX
    batched loop also rounds fmon, tyear and the bias to float32 before
    the cycle);
  - a gate tripped mid-dispatch by a NaN at one point of the state's SST
    grid (the feedback carries it into the second cycle's readout): the
    per-cycle and the batched dates stop on that cycle, and so do the
    JAX package's batched loop's dates given the same gate flags (its
    driver run on a stand-in hybrid whose cycle reports them);
  - a truth provider with cycles_per_dispatch 3 takes the per-cycle path;
  - the cycle's row of per-cycle scalars holds the kernels' by-value
    arguments: K17's scalars and month indices, K23's day and bias, the
    TISR table's row and K22's slot.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.data.calendar import ModelDate as JModelDate
from speedy_ml_tpu.hybrid.driver import run_prediction as jrun
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data.calendar import ModelDate, hour_of_year_365
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.esn.ocean import ocean_index_map
from speedy_ml_tpu_torch.esn.reservoir import (BatchedReservoir, ESNHyper,
                                               generate)
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid import graph
from speedy_ml_tpu_torch.hybrid.build import build_untrained_hybrid
from speedy_ml_tpu_torch.hybrid.driver import run_prediction
from speedy_ml_tpu_torch.hybrid.model import (ROW_SF, ROW_SLOT, ROW_SST,
                                              ROW_TISR, HybridAtmosphere,
                                              OceanPack, ocean_snapshot)
from speedy_ml_tpu_torch.hybrid.training import train_hybrid
from speedy_ml_tpu_torch.kernels import surface_forcing as sfk
from speedy_ml_tpu_torch.physics.boundaries import synthetic_boundary_data
from test_torch_cycle import _sst
from test_torch_cycle_options import _ml_pair, tables
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
N_REGIONS, M = 128, 300
K, N = 3, 7
TOL = 1e-12


@pytest.fixture(scope="module")
def gcm():
    g = Geometry(**GEOM)
    return GCM(g, dtype=torch.float64, nsteps_day=8, device="cpu",
               bd=synthetic_boundary_data(g, dtype=torch.float64))


@pytest.fixture(scope="module")
def coupled(gcm):
    return build_untrained_hybrid(gcm, n_regions=N_REGIONS, m=M,
                                  ml_only=False, device="cpu")


@pytest.fixture(scope="module")
def ml_only(gcm):
    return build_untrained_hybrid(gcm, n_regions=N_REGIONS, m=M,
                                  ml_only=True, device="cpu")


def ocean_packs(hyb, seed=9):
    """Seeded untrained slab-ocean packs (m = 100) for hyb's classes."""
    hyper = ESNHyper(m=100, sigma=0.6)
    out = []
    for i, cls in enumerate(hyb.layout.classes):
        idx = ocean_index_map(cls, hyb.nz)
        R, I = cls.count, len(idx)
        cols, vals, win, shifts = generate(seed + i, R, I, hyper, 0.9,
                                           dtype=torch.float64,
                                           radius_iters=5, device="cpu")
        xc, yc = cls.core_shape
        rng = np.random.default_rng(seed + 50 + i)
        wout = torch.as_tensor(rng.normal(0.0, 1e-3,
                                          (R, xc * yc, vals.shape[2])))
        res = BatchedReservoir(cols=cols, vals=vals, win_vals=win, wout=wout,
                               mean=torch.zeros((R, I), dtype=torch.float64),
                               std=torch.ones((R, I), dtype=torch.float64),
                               n_in=I, shifts=shifts)
        out.append(OceanPack(
            cls=cls, res=res, hyper=hyper, idx_map=idx,
            mean_sst=torch.full((R, 1), 288.0, dtype=torch.float64),
            std_sst=torch.ones((R, 1), dtype=torch.float64)))
    return out


def with_ocean(hyb, persist):
    """hyb's atmosphere with seeded ocean packs, a land fill on a seeded
    mask and SLAB_STRIDE 3."""
    g = hyb.geom
    rng = np.random.default_rng(4)
    land = torch.as_tensor(rng.uniform(size=(g.nlat, g.nlon)) < 0.3)
    h = HybridAtmosphere(hyb.gcm, hyb.layout, hyb.packs, ml_only=hyb.ml_only,
                         ocean_packs=ocean_packs(hyb),
                         base_sst=torch.full((g.nlat, g.nlon), 287.0,
                                             dtype=torch.float64),
                         sea_mask=land.double(), device="cpu")
    h.SLAB_STRIDE = 3
    h.persist_surface = persist
    return h


def vertical(gcm):
    """An ML-only hybrid with two vertical groups of levels ([0, 4) seeing
    [0, 5), [4, 8) seeing [3, 8)), trained by train_hybrid on a seeded
    synthetic truth of 24 samples."""
    g = gcm.geom
    rng = np.random.default_rng(6)
    T, grid = 24, (g.nlat, g.nlon)
    atmo = 250.0 + rng.normal(0.0, 1.0, (T, 4, g.nlev) + grid)
    atmo[:, 3] = np.abs(rng.normal(0.0, 1e-3, (T, g.nlev) + grid))
    truth = dict(atmo=atmo, logp=rng.normal(0.0, 0.01, (T,) + grid),
                 precip=np.abs(rng.normal(0.0, 1e-3, (T,) + grid)),
                 sst=290.0 + rng.normal(0.0, 1.0, (T,) + grid),
                 tisr=300.0 + rng.normal(0.0, 10.0, (T,) + grid))
    return train_hybrid(gcm, RegionLayout(g, n_regions=N_REGIONS, overlap=1),
                        truth, None, ESNHyper(m=M, noise_mag=0.0,
                                              beta_res=0.1), 3,
                        num_vert_levels=2, vert_overlap=1, device="cpu",
                        dtype=torch.float64)


def _tensors_close(a, b, what):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    scale = max(1.0, float(np.nanmax(np.abs(b)))) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale,
                               equal_nan=True, err_msg=what)


def run_both(h, s0, date, tmp_path, n=N, tm=True, **kw):
    """run_prediction per cycle and in dispatches of K from s0, each with a
    writer (and time means); returns per run (final, dates, stream,
    time means)."""
    out = []
    for k in (1, K):
        d = tmp_path / f"k{k}"
        s = ocean_snapshot(s0) if h.ocean_packs else s0
        fin, dates = run_prediction(
            h, s, date, n, output_path=str(d / "pred"),
            time_mean_path=str(d / "tm.npz") if tm else None,
            cycles_per_dispatch=k, **kw)
        out.append((fin, dates, np.load(d / "pred.npz"),
                    np.load(d / "tm.npz") if tm else None))
    return out


def assert_same_runs(runs, same_final=True):
    (f1, d1, z1, t1), (fk, dk, zk, tk) = runs
    assert dk == d1
    for a, b in ((zk, z1), (tk, t1)):
        if b is None:
            continue
        assert sorted(a.files) == sorted(b.files)
        for key in b.files:
            _tensors_close(a[key], b[key], key)
    if same_final:
        assert fk.step == f1.step and bool(fk.safe) == bool(f1.safe)
        ta, tb = graph.tree_tensors(fk), graph.tree_tensors(f1)
        assert len(ta) == len(tb)
        for x, y in zip(ta, tb):
            _tensors_close(x.numpy(), y.numpy(), "final state")


CASES = ("coupled", "ml_only", "persistent", "slab_ocean",
         "slab_ocean_persistent", "vertical", "options")


@pytest.mark.parametrize("case", CASES)
def test_batched_matches_per_cycle(case, coupled, ml_only, tmp_path):
    sst = _sst(coupled.geom)
    date = ModelDate(1990, 1, 1, 12)
    kw = {}
    if case == "coupled":
        h = coupled
    elif case == "ml_only":
        h = ml_only
    elif case == "persistent":
        h = HybridAtmosphere(coupled.gcm, coupled.layout, coupled.packs,
                             ml_only=False, device="cpu")
        h.persist_surface = True
    elif case == "slab_ocean":
        h = with_ocean(ml_only, persist=False)
    elif case == "slab_ocean_persistent":
        h = with_ocean(coupled, persist=True)
    elif case == "vertical":
        h = vertical(coupled.gcm)
        assert len(h.packs) == 6 and h.ml_only
    else:
        h = HybridAtmosphere(coupled.gcm, coupled.layout, coupled.packs,
                             ml_only=False, device="cpu")
        sst_t, tisr_t = tables(h.geom)
        h.set_sst_table(sst_t)
        h.set_tisr_table(tisr_t, 6)
        h.emit_components = True
        date = ModelDate(1990, 1, 31, 12)    # the time means' two months
        kw = dict(sst_bias_per_year=40.0)
    runs = run_both(h, h.init_state(sst), date, tmp_path, **kw)
    assert_same_runs(runs)
    fin, dates = runs[1][:2]
    assert len(dates) == N and fin.step == N and bool(fin.safe)
    if case == "options":
        assert "vp_atmo" in runs[1][2].files
        np.testing.assert_array_equal(runs[1][3]["month"], [1, 2])
    if case.startswith("slab_ocean"):
        # the slab steps (2 and 5) changed the SST grid
        stream = runs[1][2]["sst"]
        assert not np.array_equal(stream[2], stream[1])
    if case in ("persistent", "slab_ocean_persistent"):
        assert fin.sfc is not None and fin.fluxes is not None


def test_ml_only_batched_matches_jax(tmp_path):
    """The port's batched ML-only run and the JAX package's, from the same
    parameters and state: the npz streams and the time means over a
    month boundary."""
    jhyb, thyb = _ml_pair(jnp.float64, torch.float64)
    sst = _sst(thyb.geom)
    out = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        kw = dict(output_path=str(d / "pred"), cycles_per_dispatch=K,
                  time_mean_path=str(d / "tm.npz"))
        if side == "jax":
            _, dates = jrun(jhyb, jhyb.init_state(jnp.asarray(sst)),
                            JModelDate(1990, 1, 31, 6), N, **kw)
        else:
            _, dates = run_prediction(thyb, thyb.init_state(sst),
                                      ModelDate(1990, 1, 31, 6), N, **kw)
        assert len(dates) == N
        out[side] = (np.load(d / "pred.npz"), np.load(d / "tm.npz"))
    (jp, jt), (tp, tt) = out["jax"], out["port"]
    for a, b in ((tp, jp), (tt, jt)):
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                       atol=1e-5 * np.abs(b[k]).max(),
                                       err_msg=k)
    np.testing.assert_array_equal(tt["month"], [1, 2])


def _jax_dates_for_flags(flags, start, geom):
    """The dates the JAX package's batched loop keeps for a run whose
    cycles report these gate flags: its driver on a stand-in hybrid whose
    cycle only counts its steps and reports flags[step]."""
    from typing import NamedTuple

    class State(NamedTuple):
        step: jnp.ndarray
        sst_grid: jnp.ndarray
        safe: jnp.ndarray

    flags_j = jnp.asarray(flags)
    z = jnp.zeros((geom.nlat, geom.nlon))

    class Stand:
        params = jnp.zeros(())
        gcm = types.SimpleNamespace(dtype=jnp.float64, geom=geom)

        def cycle_with_params(self, prm, s, *date):
            return (State(s.step + 1, s.sst_grid, flags_j[s.step]),
                    dict(atmo=z[None, None], logp=z, precip=z))

    s0 = State(jnp.asarray(0), z, jnp.asarray(True))
    _, dates = jrun(Stand(), s0, JModelDate(start.year, start.month,
                                            start.day, start.hour),
                    len(flags), cycles_per_dispatch=K)
    return [(d.year, d.month, d.day, d.hour) for d in dates]


def test_gate_tripped_mid_dispatch(coupled, tmp_path):
    """A NaN at one point of the state's SST grid: the first cycle is safe
    (its readout reads the feedback from before), the second trips the
    gate; the batched run keeps that cycle's record and drops the rest of
    its dispatch, as the per-cycle loop and the JAX batched loop do."""
    s0 = coupled.init_state(_sst(coupled.geom))
    sst = s0.sst_grid.clone()
    sst[8, 11] = float("nan")
    bad = dataclasses.replace(s0, sst_grid=sst)
    date = ModelDate(1990, 1, 1, 12)
    runs = run_both(coupled, bad, date, tmp_path, tm=False)
    assert_same_runs(runs, same_final=False)
    (f1, d1, _, _), (fk, dk, zk, _) = runs
    assert len(d1) == len(dk) == 2
    assert not bool(f1.safe) and not bool(fk.safe)
    assert fk.step == K                  # the dispatch ran to its end
    assert np.isnan(zk["atmo"][1]).any() and np.isfinite(zk["atmo"][0]).all()
    flags = [True, False] + [False] * (N - 2)
    got = [(d.year, d.month, d.day, d.hour) for d in dk]
    assert _jax_dates_for_flags(flags, date, coupled.geom) == got


def test_truth_provider_takes_the_per_cycle_path(ml_only, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(graph.CycleDispatch, "dispatch", lambda *a: (
        pytest.fail("a truth provider must take the per-cycle path")))
    g = ml_only.geom
    truth = [dict(sst=np.full((g.nlat, g.nlon), 280.0 + i))
             for i in range(4)]
    _, dates = run_prediction(ml_only, ml_only.init_state(_sst(g)),
                              ModelDate(1990, 1, 1), 4,
                              output_path=str(tmp_path / "pred"),
                              truth_provider=lambda i: truth[i],
                              cycles_per_dispatch=K)
    z = np.load(tmp_path / "pred.npz")
    assert len(dates) == 4
    np.testing.assert_array_equal(z["truth_sst"][:, 0, 0],
                                  [280.0, 281.0, 282.0, 283.0])


def test_scalar_row_holds_the_by_value_arguments(coupled):
    h = with_ocean(coupled, persist=True)
    sst_t, tisr_t = tables(h.geom)
    h.set_sst_table(sst_t)
    h.set_tisr_table(tisr_t, 6)
    phys = h.gcm.phys
    for date, step, bias in ((ModelDate(1990, 3, 2, 18), 4, 0.25),
                             (ModelDate(1991, 12, 31, 6), 29, -1.5)):
        imon, fmon, tyear = date.month - 1, date.tmonth, date.tyear
        hour = hour_of_year_365(date)
        row = h.scalar_row(imon, fmon, tyear, hour, bias, step=step)
        v, ix = sfk.scalar_values((imon, fmon), 0.0, tyear, phys.gamlat,
                                  phys.pexp)
        scal, ixc = sfk._scalars((imon, fmon), 0.0, tyear, phys.gamlat,
                                 phys.pexp)
        assert row[:ROW_SF] == v + [float(i) for i in ix]
        assert v == list(scal) and ix == list(ixc)
        assert row[ROW_SST:ROW_SST + 2] == [float((hour // 24) % 365), bias]
        assert row[ROW_TISR] == float((hour // 6) % tisr_t.shape[0])
        assert row[ROW_SLOT] == float(step % (h.SLAB_STRIDE - 1))

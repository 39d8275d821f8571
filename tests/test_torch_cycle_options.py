"""Port parity of the forecast's options (A10c-1 and the host half of A11):
the SST and TISR climatology tables with the bias ramp (K23 sst_by_date,
the TISR row as a view), the readout's v_p/v_ml components (K2's
components form), and run_prediction's truth streams and monthly time
means, on the CPU at T10 (32 x 16, 8 levels, 128 regions, m=300) in
float64 against the JAX package, with the hybrids of
tests/test_torch_cycle.py.

Tolerances (ROADMAP C):
  - sst_by_date with a bias across 273 K and tisr_field with a table at
    hours_per_entry 1 and 6: 1e-12 (both are exact: equal);
  - ML-only cycles with each table and with the components, and two
    coupled cycles across a day boundary with the tables and the
    components on (one JAX coupled compile, a module fixture): 1e-9 of
    each variable's signal, the six vp_*/vml_* grids included;
  - float32 with bf16 Wout: the components path within 1e-4 of the
    signal of JAX's, and off the path without components by more than
    that (the JAX components einsum does not round the vector to bf16);
  - run_prediction with a truth provider and the time means over a month
    boundary: the npz streams (float32 on disk) and the time-mean file at
    rtol 1e-5;
  - the port's timemean and diagnostics functions against the JAX ones
    at 1e-12;
  - the host builds of K23 (kernels/csrc/glue_host.cpp) and of K2's
    components form (kernels/csrc/dense_host.cpp) against their plain
    versions: bit for bit (exact operands for K2), and K2's on random
    operands within chip_smoke's K2_RTOL.
The launch code runs only on a card (chip_smoke.py phase 14).
"""

import ctypes
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu import diagnostics as jdiag
from speedy_ml_tpu import timemean as jtm
from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.data.calendar import ModelDate as JModelDate
from speedy_ml_tpu.dycore.state import SpectralState as JSpectralState
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.hybrid.build import build_untrained_hybrid as jbuild
from speedy_ml_tpu.hybrid import model as jmodel
from speedy_ml_tpu.hybrid.driver import run_prediction as jrun
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu_torch import diagnostics as tdiag
from speedy_ml_tpu_torch import timemean as ttm
from speedy_ml_tpu_torch.convert import boundary_from_numpy, params_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data.calendar import ModelDate, hour_of_year_365
from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid import model as tmodel
from speedy_ml_tpu_torch.hybrid.driver import run_prediction
from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
from speedy_ml_tpu_torch.kernels import sst_by_date as k23
from speedy_ml_tpu_torch.kernels.core_scatter import (CoreScatter,
                                                      grid_blocks,
                                                      split_grid)
from speedy_ml_tpu_torch.kernels.readout import (readout,
                                                 readout_components_plain,
                                                 readout_plain)
from test_torch_cycle import GEOM, M, N_REGIONS, _close, _sst
from test_torch_dense_kernels import (WIDTHS, exact_readout_inputs,
                                      t10_layout, wout_at, NZ_T10)

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
sys.path.insert(0, str(REPO))
from chip_smoke import K2_RTOL  # noqa: E402  (the card check's tolerance)
from torch_lane import one_thread_per_pool  # noqa: E402, F401

RTOL = 1e-9
OPTIONS = ("sst_table", "tisr_table", "components")
COMPONENT_KEYS = tuple(f"{p}_{f}" for p in ("vp", "vml")
                       for f in ("atmo", "logp", "precip"))
HOURS_PER_ENTRY = 6


def tables(geom, seed=21):
    """A seeded daily SST table (365, lat, lon), the month-0 SST with a
    seasonal term and noise, straddling 273 K, and a TISR table at
    HOURS_PER_ENTRY (1,460 rows), a seasonal cosine of latitude."""
    rng = np.random.default_rng(seed)
    lat = np.asarray(geom.lat_radians)
    day = np.arange(365)[:, None, None]
    sst = (_sst(geom)[None] + 3.0 * np.sin(2 * np.pi * day / 365.0)
           * np.sin(lat)[None, :, None]
           + rng.normal(0.0, 0.4, (365, geom.nlat, geom.nlon)))
    k = np.arange(365 * 24 // HOURS_PER_ENTRY)[:, None, None]
    decl = 0.41 * np.sin(2 * np.pi * k * HOURS_PER_ENTRY / 8760.0)
    tisr = (1361.0 / np.pi * np.clip(np.cos(lat[None, :, None] - decl), 0,
                                     None)
            * np.ones((1, 1, geom.nlon)) + rng.normal(0.0, 2.0, (
                k.shape[0], geom.nlat, geom.nlon)))
    return sst, tisr


def _args(date, dtype, bias=0.0):
    """The cycle's arguments as the JAX run_prediction makes them, and the
    port's host numbers."""
    hoy = hour_of_year_365(date)
    j = (jnp.asarray(date.month - 1), jnp.asarray(date.tmonth, dtype=dtype),
         jnp.asarray(date.tyear, dtype=dtype),
         jnp.asarray(hoy, dtype=jnp.int32), jnp.asarray(bias, dtype=dtype))
    return j, (date.month - 1, date.tmonth, date.tyear, hoy, bias)


def _set(jhyb, thyb, options, sst_t, tisr_t):
    for h in (jhyb, thyb):
        h.sst_table = h.tisr_table = None
        h.tisr_hours_per_entry = 1
        h.emit_components = "components" in options
    if "sst_table" in options:
        jhyb.set_sst_table(sst_t)
        thyb.set_sst_table(sst_t)
    if "tisr_table" in options:
        jhyb.set_tisr_table(tisr_t, HOURS_PER_ENTRY)
        thyb.set_tisr_table(tisr_t, HOURS_PER_ENTRY)


def _ml_pair(jdtype, tdtype, bf16=False, like=None):
    """The ML-only hybrids of test_torch_cycle, on GCM stand-ins that also
    hold the orography the time means read.  like: a JAX hybrid whose
    parameters are cast to jdtype instead of building new ones."""
    jg, g = JGeometry(**GEOM), Geometry(**GEOM)
    phis = np.random.default_rng(3).uniform(0.0, 3e4, (g.nlat, g.nlon))
    jgcm = types.SimpleNamespace(geom=jg, dtype=jdtype, nsteps_day=36,
                                 bd=types.SimpleNamespace(
                                     phis0=jnp.asarray(phis)))
    if like is None:
        jhyb = jbuild(jgcm, n_regions=N_REGIONS, m=M,
                      key=jax.random.PRNGKey(0), ml_only=True,
                      radius_iters=30)
    else:
        cast = lambda a: (a.astype(jdtype) if jnp.issubdtype(
            a.dtype, jnp.floating) else a)
        jhyb = jmodel.HybridAtmosphere(jgcm, like.layout, [
            p._replace(res=jax.tree_util.tree_map(cast, p.res),
                       std=jax.tree_util.tree_map(cast, p.std))
            for p in like.packs], ml_only=True)
    if bf16:
        jhyb.cast_wout_bf16()
    layout = RegionLayout(g, n_regions=N_REGIONS)
    atmo = jax.tree_util.tree_map(np.asarray, jhyb.params[0])
    packs = params_from_numpy(atmo, layout, ESNHyper(m=M), device="cpu",
                              dtype=tdtype)
    tgcm = types.SimpleNamespace(geom=g, dtype=tdtype, nsteps_day=36,
                                 bd=types.SimpleNamespace(
                                     phis0=torch.as_tensor(phis)))
    return jhyb, HybridAtmosphere(tgcm, layout, packs, ml_only=True,
                                  device="cpu")


@pytest.fixture(scope="module")
def ml_pair():
    return _ml_pair(jnp.float64, torch.float64)


def _compare(ts, td, js, jd, thyb, rtol, components):
    levels = np.arange(4 * thyb.nz).reshape(4, thyb.nz, 1, 1)
    for jc, tc in zip(js.classes, ts.classes):
        _close(tc.x, jc.x, rtol)
        _close(tc.feedback, jc.feedback, rtol)
        if tc.local_model.numel():
            _close(tc.local_model, jc.local_model, rtol)
    _close(ts.sst_grid, js.sst_grid, rtol)
    _close(td["atmo"], jd["atmo"], rtol, levels)
    for k in ("logp", "precip"):
        _close(td[k], jd[k], rtol)
    assert all((k in td) == components for k in COMPONENT_KEYS)
    if components:
        assert set(COMPONENT_KEYS) <= set(jd)
        for k in COMPONENT_KEYS:
            if k.startswith("vp_") and not np.asarray(jd[k]).any():
                assert not bool(td[k].any()), k   # ML-only: v_p is 0
            else:
                _close(td[k], jd[k], rtol,
                       levels if k.endswith("atmo") else 0)


# ---------------------------------------------- the tables' functions


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_sst_by_date_matches_jax(ml_pair, dtype):
    """The day's plane with the bias over open water, at dates whose days
    wrap the table, a bias across 273 K (values just below 273 stay, just
    above take it) and a NaN kept; equal to the JAX package's."""
    jhyb, _ = ml_pair
    g = Geometry(**GEOM)
    sst_t, _ = tables(g)
    sst_t[100, 3, 4] = 273.0          # the bias applies above 273 K only
    sst_t[100, 3, 5] = 273.001
    sst_t[100, 3, 6] = np.nan
    tab = torch.as_tensor(sst_t).to(dtype)
    jtab = jnp.asarray(tab.numpy())
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    for hoy, bias in ((0, 0.0), (100 * 24 + 23, 0.75), (8759, -1.5),
                      (365 * 24 + 30, 2.0)):
        got = k23.sst_by_date(tab, k23.table_day(hoy, 365), bias)
        ref = np.asarray(jhyb.sst_by_date(jnp.asarray(hoy, jnp.int32),
                                          jnp.asarray(bias, jdt), jtab))
        np.testing.assert_array_equal(got.numpy(), ref)
        if hoy == 100 * 24 + 23:
            assert float(got[3, 4]) == 273.0 and bool(got[3, 6].isnan())
            assert float(got[3, 5]) > 273.5
    assert int(((tab > 273.0) & (tab < 275.0)).sum()) > 0
    assert int((tab < 273.0).sum()) > 0


@pytest.mark.parametrize("hpe", [1, 6])
def test_tisr_field_with_a_table_matches_jax(ml_pair, hpe):
    """tisr_field(table=) returns the table's row at (hour //
    hours_per_entry) % n: the JAX package's, and a contiguous view of the
    installed table (no copy); without an hour, the analytic plane."""
    jhyb, thyb = ml_pair
    n = 100 if hpe == 1 else 1460
    tab = np.random.default_rng(hpe).uniform(0.0, 500.0, (n, 16, 32))
    thyb.set_tisr_table(tab, hpe)
    try:
        t = thyb.tisr_table
        assert thyb.tisr_hours_per_entry == hpe and t.is_contiguous()
        for hoy in (0, 5, 6, 99, 101, 8759):
            got = thyb.tisr_field(0.3, hoy, table=t, hours_per_entry=hpe)
            ref = jhyb.tisr_field(jnp.asarray(0.3), jnp.asarray(
                hoy, jnp.int32), table=jnp.asarray(tab), hours_per_entry=hpe)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
            assert got.is_contiguous() and got.data_ptr() == t[
                (hoy // hpe) % n].data_ptr()
        analytic = thyb.tisr_field(0.3, None, table=t)
        assert torch.equal(analytic, thyb.tisr_field(0.3))
    finally:
        thyb.tisr_table, thyb.tisr_hours_per_entry = None, 1
    with pytest.raises(ValueError, match="expected"):
        thyb.set_sst_table(np.zeros((365, 8, 32)))


# ----------------------------------------------- the ML-only cycles


@pytest.mark.parametrize("option", OPTIONS)
def test_ml_only_cycles_with_an_option_match_jax(ml_pair, option):
    """Three ML-only cycles from 1990-01-01 18:00 (across a day boundary)
    with one option on: every state and field at 1e-9, the components'
    six grids too (v_p zero: no local model); with the SST table the state
    carries the table's day with the bias ramp."""
    jhyb, thyb = ml_pair
    sst_t, tisr_t = tables(thyb.geom)
    _set(jhyb, thyb, (option,), sst_t, tisr_t)
    try:
        sst = _sst(thyb.geom)
        js = jhyb.init_state(jnp.asarray(sst))
        ts = thyb.init_state(sst)
        date = ModelDate(1990, 1, 1, 18)
        for i in range(3):
            ja, ta = _args(date, jnp.float64, bias=0.5 * i)
            js, jd = jhyb.cycle(js, *ja)
            ts, td = thyb.cycle(ts, *ta)
            _compare(ts, td, js, jd, thyb, RTOL, option == "components")
            if option == "sst_table":
                want = k23.sst_by_date_plain(thyb.sst_table,
                                             k23.table_day(ta[3], 365),
                                             0.5 * i)
                assert torch.equal(ts.sst_grid, want)
            date = date.advance_hours(6)
    finally:
        _set(jhyb, thyb, (), None, None)


def test_components_f32_bf16_match_jax_unrounded(ml_pair):
    """float32 with bf16 Wout (the f64 pair's parameters cast): the
    components path (the vector unrounded, as JAX's promoting einsum)
    within 1e-4 of the JAX package's signal, and the path without
    components (the vector rounded to bf16) off it by more than that."""
    jhyb, thyb = _ml_pair(jnp.float32, torch.float32, bf16=True,
                          like=ml_pair[0])
    assert all(p.res.wout.dtype == jnp.bfloat16 for p in jhyb.packs)
    assert all(p.res.vals.dtype == jnp.float32 for p in jhyb.packs)
    for h in (jhyb, thyb):
        h.emit_components = True
    sst = _sst(thyb.geom)
    js = jhyb.init_state(jnp.asarray(sst, dtype=jnp.float32))
    ts = thyb.init_state(sst)
    date = ModelDate(1990, 1, 1)
    for _ in range(2):
        ja, ta = _args(date, jnp.float32)
        js, jd = jhyb.cycle(js, *ja)
        thyb.emit_components = False
        _, plain = thyb.cycle(ts, *ta)
        thyb.emit_components = True
        ts, td = thyb.cycle(ts, *ta)
        _compare(ts, td, js, jd, thyb, 1e-4, True)
        date = date.advance_hours(6)
    # the second cycle (the first reads out a zero state): T's levels
    ref = np.asarray(jd["atmo"][0])
    signal = np.abs(ref - ref.mean(axis=(1, 2), keepdims=True)).max()
    off = float(np.abs(plain["atmo"][0].numpy() - ref).max()) / signal
    assert off > 1e-4, f"the rounded path is only {off:.2e} off"


def test_run_prediction_truth_and_time_means_match_jax(ml_pair, tmp_path):
    """run_prediction with both tables, the components, a bias ramp, a
    seeded truth provider and the time means, from 1990-01-31 12:00 over
    the month boundary: the same npz keys and streams as the JAX writer's,
    and the same time-mean file (two months)."""
    jhyb, thyb = ml_pair
    g = thyb.geom
    sst_t, tisr_t = tables(g)
    _set(jhyb, thyb, OPTIONS, sst_t, tisr_t)
    rng = np.random.default_rng(7)
    truth = [dict(atmo=rng.normal(250.0, 5.0, (4, 8, g.nlat, g.nlon)),
                  sst=rng.normal(290.0, 2.0, (g.nlat, g.nlon)))
             for _ in range(5)]
    sst = _sst(g)
    out = {}
    try:
        for side in ("jax", "port"):
            d = tmp_path / side
            kw = dict(output_path=str(d / "pred"), sst_bias_per_year=40.0,
                      truth_provider=lambda i: truth[i],
                      time_mean_path=str(d / "tm.npz"))
            if side == "jax":
                final, dates = jrun(jhyb, jhyb.init_state(jnp.asarray(sst)),
                                    JModelDate(1990, 1, 31, 12), 5, **kw)
            else:
                final, dates = run_prediction(
                    thyb, thyb.init_state(sst), ModelDate(1990, 1, 31, 12),
                    5, **kw)
            assert len(dates) == 5
            out[side] = (np.load(d / "pred.npz"), np.load(d / "tm.npz"))
    finally:
        _set(jhyb, thyb, (), None, None)
    (jp, jt), (tp, tt) = out["jax"], out["port"]
    want = sorted(["atmo", "logp", "precip", "sst", "truth_atmo",
                   "truth_sst", *COMPONENT_KEYS])
    assert sorted(tp.files) == sorted(jp.files) == want
    for k in jp.files:
        assert tp[k].shape == jp[k].shape and tp[k].dtype == jp[k].dtype
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(jp[k]).max(), err_msg=k)
    np.testing.assert_array_equal(tp["truth_sst"], np.stack(
        [t["sst"] for t in truth]).astype(np.float32))
    assert sorted(tt.files) == sorted(jt.files)
    np.testing.assert_array_equal(tt["month"], [1, 2])
    np.testing.assert_array_equal(tt["n_samples"], [2, 3])
    for k in jt.files:
        np.testing.assert_allclose(tt[k], jt[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(jt[k]).max(), err_msg=k)


# -------------------------------------------------- the coupled cycles


@pytest.fixture(scope="module")
def coupled_options():
    """One JAX coupled hybrid (the coupled pair of test_torch_cycle) with
    both tables and the components on, and the port's twin."""
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
    _set(jhyb, thyb, OPTIONS, *tables(geom))
    return jhyb, thyb


def test_coupled_cycles_with_tables_and_components_match_jax(
        coupled_options):
    """Two coupled cycles across a day (and month) boundary, 1990-01-31
    18:00 and 1990-02-01 00:00, with both tables and the components: the
    states, SPEEDY's fields and the six component grids at 1e-9; v_p is
    not zero once the local model is (the second cycle); the state's SST
    is the table's day with the bias ramp, and it fed SPEEDY's window."""
    jhyb, thyb = coupled_options
    sst = _sst(thyb.geom)
    js = jhyb.init_state(jnp.asarray(sst))
    ts = thyb.init_state(sst)
    variables = np.arange(4).reshape(4, 1, 1, 1)
    date = ModelDate(1990, 1, 31, 18)
    for i in range(2):
        ja, ta = _args(date, jnp.float64, bias=0.25 + i)
        js, jd = jhyb.cycle(js, *ja)
        ts, td = thyb.cycle(ts, *ta)
        _compare(ts, td, js, jd, thyb, RTOL, True)
        _close(td["speedy_atmo"], jd["speedy_atmo"], RTOL, variables)
        _close(td["speedy_logp"], jd["speedy_logp"], RTOL)
        assert torch.equal(ts.sst_grid, k23.sst_by_date_plain(
            thyb.sst_table, k23.table_day(ta[3], 365), 0.25 + i))
        assert bool(td["vp_atmo"].abs().max() > 0) == (i == 1)
        date = date.advance_hours(6)
    assert bool(ts.safe) and bool(js.safe)


def test_coupled_cycle_launches_k23_once_and_reads_the_tisr_row(
        coupled_options, monkeypatch):
    """The wiring: a coupled cycle with both tables calls K23 once and
    K17b never, and hands K3 the TISR table's row itself (no copy); with
    ocean packs or without an hour of the year the SST table is not read;
    without tables K23 is not called."""
    _, thyb = coupled_options
    calls, tisr_seen = [], []
    real = tmodel.sst_by_date
    monkeypatch.setattr(tmodel, "sst_by_date",
                        lambda *a: calls.append(a[1:]) or real(*a))
    monkeypatch.setattr(tmodel, "tisr_plane",
                        lambda *a: pytest.fail("K17b called"))
    gather = tmodel.window_gather
    monkeypatch.setattr(tmodel, "window_gather", lambda fields, *a: (
        tisr_seen.append(fields[4]) or gather(fields, *a)))
    s = thyb.init_state(_sst(thyb.geom))
    date = ModelDate(1990, 3, 2, 6)
    _, ta = _args(date, jnp.float64, bias=1.0)
    thyb.cycle(s, *ta)
    row = thyb.tisr_table[(ta[3] // HOURS_PER_ENTRY) % 1460]
    assert calls == [(k23.table_day(ta[3], 365), 1.0)]
    assert tisr_seen[0].data_ptr() == row.data_ptr()
    calls.clear()
    thyb.cycle(s, *ta[:3])            # no hour of the year: no table
    saved, thyb.sst_table = thyb.sst_table, None
    try:
        thyb.cycle(s, *ta)
    finally:
        thyb.sst_table = saved
    assert calls == []


# ------------------------------------------- timemean and diagnostics


def test_timemean_and_diagnostics_functions_match_jax():
    """The port's copies against the JAX package's: pressure levels, MSL
    pressure, sigma->p, the verification statistics, the monthly means of
    a stream over a month boundary (1e-12); global_diagnostics and the
    gate's predicate on torch tensors."""
    g = Geometry(**GEOM)
    jg = JGeometry(**GEOM)
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(ttm.output_pressure_levels(g.full_sigma),
                                  jtm.output_pressure_levels(jg.full_sigma))
    ps = rng.uniform(500.0, 1040.0, (g.nlat, g.nlon))
    t0 = rng.uniform(230.0, 310.0, (g.nlat, g.nlon))
    phis = rng.uniform(0.0, 3e4, (g.nlat, g.nlon))
    np.testing.assert_allclose(ttm.mean_sea_level_pressure(ps, t0, phis),
                               jtm.mean_sea_level_pressure(ps, t0, phis),
                               rtol=1e-12)
    field = rng.normal(250.0, 20.0, (8, g.nlat, g.nlon))
    psn = rng.uniform(0.5, 1.04, (g.nlat, g.nlon))
    lev = ttm.output_pressure_levels(g.full_sigma)
    np.testing.assert_allclose(
        tdiag.sigma_to_pressure(field, psn, g.full_sigma, lev),
        jdiag.sigma_to_pressure(field, psn, jg.full_sigma, lev), rtol=1e-12)
    a, b = rng.normal(0, 1, (2, 3, g.nlat, g.nlon))
    clim = tdiag.climatology(a)
    np.testing.assert_allclose(clim, jdiag.climatology(a), rtol=1e-12)
    for fn in ("weighted_rms", "weighted_bias"):
        assert abs(getattr(tdiag, fn)(a, b, g)
                   - getattr(jdiag, fn)(a, b, jg)) <= 1e-12
    assert abs(tdiag.anomaly_correlation(a, b, clim, g)
               - jdiag.anomaly_correlation(a, b, clim, jg)) <= 1e-12
    np.testing.assert_allclose(tdiag.lat_weights(g), jdiag.lat_weights(jg),
                               rtol=1e-12)
    T = 10
    stream = dict(atmo=rng.normal(260.0, 10.0, (T, 4, 8, g.nlat, g.nlon)),
                  logp=rng.normal(0.0, 0.02, (T, g.nlat, g.nlon)),
                  precip=rng.uniform(0, 1e-3, (T, g.nlat, g.nlon)),
                  sst=rng.normal(290.0, 2.0, (T, g.nlat, g.nlon)))
    got = ttm.monthly_means_from_stream(stream, ModelDate(1990, 1, 30), g,
                                        phis=phis)
    ref = jtm.monthly_means_from_stream(stream, JModelDate(1990, 1, 30), jg,
                                        phis=phis)
    assert [m["month"] for m in got] == [m["month"] for m in ref] == [1, 2]
    for m, r in zip(got, ref):
        assert sorted(m) == sorted(r)
        for k in m:
            np.testing.assert_allclose(m[k], r[k], rtol=1e-12, err_msg=k)
    # the spectral state's amplitudes and the gate's predicate
    cplx = lambda *s: rng.normal(0, 1, s) + 1j * rng.normal(0, 1, s)
    K, Mx, Nx = 8, jg.mx, jg.nx
    arrs = dict(vor=cplx(2, K, Mx, Nx), div=cplx(2, K, Mx, Nx),
                t=cplx(2, K, Mx, Nx), ps=cplx(2, Mx, Nx),
                tr=cplx(2, 1, K, Mx, Nx))
    dg = tdiag.global_diagnostics(SpectralState(
        **{k: torch.as_tensor(v) for k, v in arrs.items()}), None)
    dj = jdiag.global_diagnostics(JSpectralState(
        **{k: jnp.asarray(v) for k, v in arrs.items()}), None)
    assert sorted(dg) == sorted(dj)
    for k in dj:
        assert abs(float(dg[k]) - float(dj[k])) <= 1e-12 * max(
            1.0, abs(float(dj[k]))), k
    grids = [rng.normal(280, 10, (8, g.nlat, g.nlon)),
             rng.normal(0, 20, (8, g.nlat, g.nlon)),
             rng.normal(0, 20, (8, g.nlat, g.nlon)),
             rng.uniform(0, 10, (8, g.nlat, g.nlon))]
    for bad in (None, (0, 400.0), (3, 31.0), (1, -151.0)):
        gs = [x.copy() for x in grids]
        if bad is not None:
            gs[bad[0]][2, 3, 4] = bad[1]
        assert bool(tdiag.state_in_physical_range(
            *[torch.as_tensor(x) for x in gs])) == bool(
            jdiag.state_in_physical_range(*[jnp.asarray(x) for x in gs]))


# ------------------------------------------------ the host builds


def _build(tmp_path_factory, src, name):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' arithmetic for the host")
    so = tmp_path_factory.mktemp(name) / f"lib{name}.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    str(CSRC / src), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def glue_lib(tmp_path_factory):
    """csrc/glue_host.cpp (K23's host build among the glue kernels')."""
    lib = _build(tmp_path_factory, "glue_host.cpp", "glue_host")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sst_by_date_host.argtypes = [i, vp, ll, ll, ll, ctypes.c_double, vp]
    lib.sst_by_date_host.restype = i
    return lib


@pytest.fixture(scope="module")
def dense_lib(tmp_path_factory):
    """csrc/dense_host.cpp (K2's components form)."""
    lib = _build(tmp_path_factory, "dense_host.cpp", "dense_host")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.readout_components_host.argtypes = ([i] + [vp] * 5 + [i] * 5
                                            + [vp] * 5 + [ll] * 4)
    lib.readout_components_host.restype = i
    lib.readout_tile_rows_host.argtypes = [i] * 3
    return lib


def _ptr(t):
    if t is None:
        return None
    assert t.is_contiguous() and t.device.type == "cpu"
    return t.data_ptr()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_sst_by_date_host_matches_plain(glue_lib, dtype):
    """K23's host build at T30 (48 x 96) and T10 against
    sst_by_date_plain, bit for bit, for days at both ends of the table and
    biases of both signs; exactly 273 K takes no bias, NaN stays; a day
    outside the table is refused."""
    rng = np.random.default_rng(23)
    for nlat, nlon in ((48, 96), (16, 32)):
        tab = torch.as_tensor(rng.uniform(268.0, 305.0, (365, nlat, nlon))
                              ).to(dtype)
        tab[0, 0, :3] = torch.tensor([273.0, float("nan"), 273.0001])
        for day, bias in ((0, 0.37), (364, -2.5), (180, 0.0)):
            out = torch.empty((nlat, nlon), dtype=dtype)
            assert glue_lib.sst_by_date_host(
                int(dtype == torch.float64), _ptr(tab), 365, day,
                nlat * nlon, bias, _ptr(out)) == 0
            want = k23.sst_by_date_plain(tab, day, bias)
            assert torch.equal(out.nan_to_num(-1.0), want.nan_to_num(-1.0))
            if day == 0:
                assert float(out[0, 0]) == 273.0 and bool(out[0, 1].isnan())
    assert glue_lib.sst_by_date_host(1, _ptr(tab), 365, 365, 10, 0.0,
                                     _ptr(out)) == 1


def _host_components(lib, wout, x, lm=None, mean=None, std=None, tile=None,
                     grid=None, index=None, q=(0, 0), p=(0, 0), parts=None):
    R, O, A = wout.shape
    out = None if grid is not None else torch.empty((R, O),
                                                    dtype=torch.float32)
    if parts is None:
        parts = [torch.empty((R, O), dtype=torch.float32) for _ in range(2)]
    path = lib.readout_components_host(
        int(wout.dtype == torch.bfloat16), _ptr(wout), _ptr(x), _ptr(lm),
        _ptr(mean), _ptr(std), R, O, A - x.shape[1], x.shape[1], tile or O,
        _ptr(out), _ptr(parts[0]), _ptr(parts[1]), _ptr(grid), _ptr(index),
        *q, *p)
    return out, parts, path


@pytest.mark.parametrize("offset", [0, 8])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_readout_components_host_exact(dense_lib, width, offset):
    """K2's components form at the T30 widths, Wout 0 and 8 bytes past a
    16-byte boundary (so the split at S = 132 falls inside a word and on
    a word's edge): out, v_p and v_ml equal readout_components_plain bit
    for bit on exact operands, and the main output is off the rounding
    readout's (the vector unrounded)."""
    S, n = WIDTHS[width]
    w0, x, lm, mean, std = exact_readout_inputs(S + n, 2, 5, S, n)
    w = wout_at(w0, offset)
    out, (vp, vml), path = _host_components(dense_lib, w, x, lm)
    assert path == 1
    ref = readout_components_plain(w, x, lm)
    assert torch.equal(out, ref[0]) and torch.equal(vp, ref[1])
    assert torch.equal(vml, ref[2])
    assert bool(vp.any()) == (S > 0)
    assert not torch.equal(out, readout_plain(w, x, lm))
    out, _, _ = _host_components(dense_lib, w, x, lm, mean, std)
    assert torch.equal(out, readout_components_plain(w, x, lm, mean, std)[0])


@pytest.mark.parametrize("case", ["bf16 scalar", "f32 vector",
                                  "f32 scalar"])
def test_readout_components_host_other_paths(dense_lib, case):
    """The scalar path and the f32 vector path of the components form, on
    exact operands."""
    S, n, dtype, offset = {"bf16 scalar": (3, 38, torch.bfloat16, 0),
                           "f32 vector": (132, 5760, torch.float32, 0),
                           "f32 scalar": (4, 40, torch.float32, 8)}[case]
    w0, x, lm, mean, std = exact_readout_inputs(7, 3, 6, S, n, dtype)
    w = wout_at(w0, offset)
    out, (vp, vml), path = _host_components(dense_lib, w, x, lm, mean, std)
    assert path == int(case.endswith("vector"))
    ref = readout_components_plain(w, x, lm, mean, std)
    assert torch.equal(out, ref[0]) and torch.equal(vp, ref[1])
    assert torch.equal(vml, ref[2])


@pytest.mark.parametrize("form", ["coupled", "ML-only"])
def test_readout_components_scatter(dense_lib, form):
    """The components form's store into three grids on the T10 layout
    (each class with the card's rows per block; the grids start as NaN):
    every element of the three written; the main grid bit for bit the
    plain components then scatter_plain (with the clamps, which bite), v_p
    and v_ml the plain parts scattered without them; on random operands
    the parts within K2_RTOL of their scale.  The CPU route of `readout`
    with parts gives the plain grids."""
    lay, _, index = t10_layout()
    g = lay.geom
    total, q, p = grid_blocks(4, NZ_T10, g.nlat, g.nlon)
    grids = [torch.full((total,), float("nan")) for _ in range(3)]
    plain = [torch.full((total,), float("nan")) for _ in range(3)]
    rng = np.random.default_rng(29)
    scale = 0.0
    for c, (cls, idx) in enumerate(zip(lay.classes, index)):
        R, O = idx.shape
        S = O - cls.core_shape[0] * cls.core_shape[1] if form == "coupled" \
            else 0
        w = torch.as_tensor(rng.normal(0, 0.02, (R, O, S + 40)).astype(
            np.float32)).to(torch.bfloat16)
        x = torch.as_tensor(np.tanh(rng.normal(0, 1, (R, 40))).astype(
            np.float32))
        lm = torch.as_tensor(rng.normal(0, 1, (R, S)).astype(
            np.float32)) if S else None
        mean, std = (torch.as_tensor(rng.uniform(*b, (R, O)).astype(
            np.float32)) for b in ((-1e-5, 1e-5), (0.5, 2.0)))
        tile = dense_lib.readout_tile_rows_host(132, R, O)
        _, _, path = _host_components(dense_lib, w, x, lm, mean, std, tile,
                                      grids[0], idx, q, p, grids[1:])
        assert path == 1
        sc = CoreScatter(plain[0], idx, q, p)
        readout(w, x, lm, mean, std, scatter=sc, parts=plain[1:])
        ref = readout_components_plain(w, x, lm, mean, std)
        scale = max(scale, float(ref[2].abs().max()))
    assert not any(bool(t.isnan().any()) for t in grids + plain)
    err = max(float((a - b).abs().max()) for a, b in zip(grids, plain))
    assert err <= K2_RTOL * scale
    atmo, _, precip = split_grid(grids[0], 4, NZ_T10, g.nlat, g.nlon)
    assert float(atmo[3].min()) == float(torch.tensor(1e-6))
    assert 0 < int((precip == 0).sum()) < precip.numel()
    # the parts are not clamped: humidity below 1e-6 and small precip stay
    vml_atmo, _, vml_precip = split_grid(grids[2], 4, NZ_T10, g.nlat,
                                         g.nlon)
    assert float(vml_atmo[3].min()) < 0 and bool(
        ((vml_precip > 0) & (vml_precip < 1e-5)).any() | (
            vml_precip < 0).any())
    vp_sum = float(grids[1].abs().sum())
    assert (vp_sum > 0) == (form == "coupled")


def test_sst_by_date_refuses_other_devices():
    """A meta tensor: no kernel, raise; a day outside the table: raise."""
    with pytest.raises(ValueError, match="no kernel"):
        k23.sst_by_date(torch.zeros(365, 4, 8, device="meta"), 3, 0.5)
    with pytest.raises(ValueError, match="outside"):
        k23.sst_by_date(torch.zeros(365, 4, 8), 365, 0.5)
    n = k23.sst_by_date.launches
    k23.sst_by_date(torch.zeros(365, 4, 8), 3, 0.5)
    assert k23.sst_by_date.launches == n     # the CPU route counts nothing

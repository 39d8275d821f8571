"""Port parity of the experiment programs (speedy_ml_tpu_torch/experiments)
against transcriptions of the JAX package's scripts, on the CPU in
float64.

The JAX side is a transcription, in this file, of the lines of
scripts/climate_run.py and scripts/skill_experiment_production.py that
make each stage, run in one subprocess with one XLA thread (as
tests/test_torch_cli.py runs the JAX package): stage D's baseline
(climate_run.py:265-331) and the skill protocol's training and
evaluation (skill_experiment_production.py:154-234).  The set-up is T10
on a 32 x 16 grid with 8 levels, 128 regions, m = 300, on the synthetic
aquaplanet; 16 GCM steps a day, so a 6-h window is 4 steps (the
aquaplanet nature run at 8 steps a day goes NaN within its spin-up).
The twin data are N = 112 training samples and 40 more, after a 5-day
spin-up, made once by the port's stage A into its cache file, which the
JAX side reads as the scripts read theirs.

Tolerances: stage D's carried state 1e-9 of each field's scale, its
float32 sums, counts and daily series 2 float32 ulps of each field's
scale; the skill RMSE lists 1e-9 (the JAX weights carried across by
convert.py); stage E's result against the transcription of
climate_run.py:350-441 with the JAX package's analysis on the same files
(numpy only, a T30 grid, so that the Nino-3.4 box holds latitudes)
1e-12.  The other cases run the port alone: the 365-day calendar, the
twin cache's checks, stage skipping, the ".atmo" checkpoint deleted, no
default output path, the figures, the command without CUDA.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_lane import one_thread_per_pool  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
N_REGIONS, NSD, M = 128, 16, 300
N, MARGIN, SPIN = 112, 40, 5
BETA = 0.05
SPY_D = 6            # stage D's day-of-year bins: 2 days wrap around them
DAYS_D = 2
ICS = (N + 8, N + 32)
NCYC = 4
TOPOLOGY = "random"

JAX_SIDE = """
import dataclasses, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from speedy_ml_tpu.analysis import sigma_to_pressure
from speedy_ml_tpu.core import Geometry
from speedy_ml_tpu.core.spectral import SpectralTransform
from speedy_ml_tpu.data.calendar import ModelDate
from speedy_ml_tpu.esn.domain import RegionLayout
from speedy_ml_tpu.esn.reservoir import ESNHyper
from speedy_ml_tpu.gcm import GCM
from speedy_ml_tpu.hybrid.chunked import ArraySource, train_hybrid_production
from speedy_ml_tpu.physics.boundaries import synthetic_boundary_data

OUT = sys.argv[1]
P = json.loads(sys.argv[2])
N, SYNC = P["n"], 24
geom = Geometry(**P["geom"])
DT = jnp.float64
sht = SpectralTransform(geom, dtype=DT)
bd_true = synthetic_boundary_data(geom, sht)
bd_imp = dataclasses.replace(bd_true, sst12=bd_true.sst12 + 3.0,
                             stl12=bd_true.stl12 + 3.0,
                             alb0=bd_true.alb0 * 2.0)
gcm_imp = GCM(geom, dtype=DT, bd=bd_imp, nsteps_day=P["nsd"])
layout = RegionLayout(geom, n_regions=P["regions"], overlap=1)

# the twin cache (climate_run.py:164-166)
z = np.load(P["cache"])
truth = {k[2:]: z[k] for k in z.files if k.startswith("t_")}
model = {k[2:]: z[k] for k in z.files if k.startswith("m_")}
dates = [ModelDate(1990, 1, 1).advance_hours(P["spin"] * 24)]
for _ in range(N + P["margin"] - 1):
    dates.append(dates[-1].advance_hours(6))

def leaves(obj, prefix):
    return {f"{prefix}{f.name}": np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}

# stage D (climate_run.py:265-331), SPY day-of-year bins, DAYS days
SPY = P["spy_d"]
date = dates[N + SYNC + 8]
state, _ = gcm_imp.init_state(date)
forcing = gcm_imp.forcing_for(state.sfc, date.tyear)
state = gcm_imp.stepone(state, forcing)
steps = gcm_imp.nsteps_day * 6 // 24

@jax.jit
def day4(state, forcing):
    def body(s, _):
        pre = s.fluxes.precip
        s = gcm_imp.run_window(s, forcing, steps)
        sp = s.spectral
        u, v = gcm_imp.sht.uv_grid(sp.vor[0], sp.div[0])
        atmo = jnp.stack([gcm_imp.sht.spec_to_grid(sp.t[0]), u, v,
                          gcm_imp.sht.spec_to_grid(sp.tr[0, 0])])
        logp = gcm_imp.sht.spec_to_grid(sp.ps[0])
        precip = (s.fluxes.precip - pre) / 21600.0
        return s, (atmo, logp, precip)
    return jax.lax.scan(body, state, None, length=4)

sums = {k: np.zeros((SPY, 8, geom.nlat, geom.nlon), np.float32)
        for k in ("t", "u", "q")}
sums["ps"] = np.zeros((SPY, geom.nlat, geom.nlon), np.float32)
counts = np.zeros(SPY, np.int64)
sst_series, precip_series, logp_series = [], [], []
pos = 0
for day in range(P["days_d"]):
    forcing = gcm_imp.forcing_for(state.sfc, date.tyear)
    state = dataclasses.replace(
        state, fluxes=jax.tree_util.tree_map(jnp.zeros_like, state.fluxes))
    state, (atmo, logp, precip) = day4(state, forcing)
    a, lp, pr = (np.asarray(atmo), np.asarray(logp), np.asarray(precip))
    assert np.isfinite(lp).all()
    idx = (pos + np.arange(4)) % SPY
    for vi, k in ((0, "t"), (1, "u"), (3, "q")):
        np.add.at(sums[k], idx, sigma_to_pressure(a[:, vi], lp))
    np.add.at(sums["ps"], idx, np.exp(lp) * 1000.0)
    np.add.at(counts, idx, 1)
    sst_series.append(np.asarray(state.sfc.sst_am))
    precip_series.append(pr.mean(axis=0))
    logp_series.append(lp[-1])
    pos += 4
    date = date.advance_day()
    state = dataclasses.replace(state, sfc=gcm_imp._couple_jit(
        state.sfc, dict(hflux_l=state.fluxes.hflux_l,
                        hflux_s=state.fluxes.hflux_s,
                        hflux_i=state.fluxes.hflux_i),
        jnp.asarray(date.month - 1),
        jnp.asarray(date.tmonth, dtype=DT), None))
c = np.maximum(counts, 1)
np.savez_compressed(
    f"{OUT}/speedy_baseline.npz",
    **{f"climo_{k}": (v / (c[:, None, None, None] if v.ndim == 4
                           else c[:, None, None])).astype(np.float32)
       for k, v in sums.items()},
    sst_daily=np.stack(sst_series).astype(np.float32),
    precip_daily=np.stack(precip_series).astype(np.float32),
    logp_daily=np.stack(logp_series).astype(np.float32))
np.savez(f"{OUT}/baseline_state.npz", **leaves(state.spectral, "spec_"),
         **leaves(state.sfc, "sfc_"))

# the skill protocol (skill_experiment_production.py:154-234), one arm,
# the ICs and cycles of P; the baseline window is the hybrid's 6 h
train_truth = {k: np.asarray(v[:N]) for k, v in truth.items()}
train_model = {k: np.asarray(v[:N]) for k, v in model.items()}
src = ArraySource(train_truth, train_model)
w = np.cos(geom.lat_radians)[:, None]

def np_rmse(a, b):
    return float(np.sqrt((w * (a - b) ** 2).sum() / (w.sum() * geom.nlon)))

hyper = ESNHyper(m=P["m"], deg=6, noise_mag=0.2, beta_res=P["beta"])
hyb = train_hybrid_production(gcm_imp, layout, src, hyper,
                              jax.random.key(0), hybrid=True,
                              region_chunk=96, time_chunk=256,
                              dtype=DT, topology=P["topology"])
params = {}
for i, (res, std) in enumerate(hyb.params[0]):
    for k in ("cols", "vals", "win_vals", "wout", "mean", "std", "n_in",
              "shifts", "win_cols"):
        if getattr(res, k) is not None:
            params[f"{i}_res_{k}"] = np.asarray(getattr(res, k))
    for k in ("comp_mean", "comp_std", "in_mean", "in_std", "out_mean",
              "out_std"):
        params[f"{i}_std_{k}"] = np.asarray(getattr(std, k))
np.savez(f"{OUT}/params.npz", **params)

@jax.jit
def baseline_init(atmo, logp):
    spec, _ = hyb.inject_to_speedy(atmo, logp)
    return spec

@jax.jit
def baseline_extract(state):
    return gcm_imp.sht.spec_to_grid(state.spectral.t[0])

per_ic = []
for ic in P["ics"]:
    sync = {k: v[ic - SYNC:ic] for k, v in truth.items()}
    model_next = dict(atmo=model["atmo"][ic], logp=model["logp"][ic])
    st = hyb.start_prediction(sync, model_next,
                              jnp.asarray(truth["sst"][ic - 1]))
    d = dates[ic]
    spec = baseline_init(jnp.asarray(truth["atmo"][ic - 1]),
                         jnp.asarray(truth["logp"][ic - 1]))
    state_imp, forcing = gcm_imp.init_state(dates[ic - 1], spectral=spec)
    state_imp = gcm_imp.stepone(state_imp, forcing)
    dd = dates[ic - 1]
    errs_h, errs_s = [], []
    for c in range(P["ncyc"]):
        st, diag = hyb.cycle(st, jnp.asarray(d.month - 1),
                             jnp.asarray(d.tmonth, dtype=DT),
                             jnp.asarray(d.tyear, dtype=DT))
        forcing = gcm_imp.forcing_for(state_imp.sfc, dd.tyear)
        state_imp = gcm_imp.run_window(state_imp, forcing, steps)
        dd = dd.advance_hours(6)
        d = d.advance_hours(6)
        k = ic + c
        if k >= truth["atmo"].shape[0]:
            break
        tr = np.asarray(truth["atmo"][k][0])
        errs_h.append(np_rmse(np.asarray(diag["atmo"][0]), tr))
        errs_s.append(np_rmse(np.asarray(baseline_extract(state_imp)), tr))
    per_ic.append(dict(ic=ic, hybrid=errs_h, speedy=errs_s))
with open(f"{OUT}/skill.json", "w") as f:
    json.dump(per_ic, f)
"""
ONE_THREAD_ENV = dict(
    XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1",
    OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")


@pytest.fixture(scope="module")
def twin():
    from speedy_ml_tpu_torch.core.geometry import Geometry
    from speedy_ml_tpu_torch.experiments.twin import twin_setup
    return twin_setup(Geometry(**GEOM), dtype=torch.float64,
                      n_regions=N_REGIONS, nsteps_day=NSD, device="cpu")


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("twin_cache")


@pytest.fixture(scope="module")
def twin_data_shared(cache_dir, twin):
    """The twin data, made by the port's stage A into cache_dir."""
    from speedy_ml_tpu_torch.experiments.twin import twin_data
    data = twin_data(twin.gcm_true, twin.gcm_imp, N, cache_dir,
                     source=twin.source, spinup_days=SPIN, margin=MARGIN,
                     log=lambda s: None)
    assert data.generated
    return data


@pytest.fixture(scope="module")
def jax_run(twin_data_shared, cache_dir, tmp_path_factory):
    """The JAX transcriptions started in a subprocess on the port's twin
    cache; they run while the port's own cases do.  Yields (the process,
    its directory)."""
    from speedy_ml_tpu_torch.experiments.twin import twin_cache_path
    tmp = tmp_path_factory.mktemp("jax_experiments")
    params = dict(geom=GEOM, nsd=NSD, regions=N_REGIONS, n=N, margin=MARGIN,
                  spin=SPIN, spy_d=SPY_D, days_d=DAYS_D, m=M, beta=BETA,
                  topology=TOPOLOGY, ics=list(ICS), ncyc=NCYC,
                  cache=str(twin_cache_path(cache_dir, N, "synth")))
    with open(tmp / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SIDE, str(tmp), json.dumps(params)],
            cwd=REPO, env=dict(os.environ, **ONE_THREAD_ENV),
            stdout=subprocess.DEVNULL, stderr=err)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_side(jax_run):
    """The JAX side's files: stage D's baseline and final state, the
    skill arm's parameters and RMSE lists."""
    proc, tmp = jax_run
    rc = proc.wait(timeout=1200)
    assert rc == 0, (tmp / "stderr.txt").read_text()[-4000:]
    return tmp


def _scale_close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-300)
    return float(np.abs(got - ref).max()) <= rtol * scale


def _ulps_close(got, ref, ulps):
    """Within `ulps` float32 spacings of the array's scale."""
    assert got.shape == ref.shape and ref.dtype == np.float32
    tol = ulps * float(np.spacing(np.float32(np.abs(ref).max())))
    return float(np.abs(got.astype(np.float64)
                        - ref.astype(np.float64)).max()) <= tol


def test_twin_cache_mmap_equals_npz(jax_run, twin_data_shared, cache_dir,
                                    tmp_path):
    """The memory-mapped form: extracted once into one .npy file a key
    (no .tmp directory left), the same arrays as the npz.  (The first
    case of the file: it starts the JAX side.)"""
    import shutil
    from speedy_ml_tpu_torch.experiments.twin import (twin_cache_path,
                                                      twin_data)
    src = twin_cache_path(cache_dir, N, "synth")
    shutil.copy(src, tmp_path / src.name)
    none = types.SimpleNamespace()
    got = twin_data(none, none, N, tmp_path, source="synth",
                    spinup_days=SPIN, margin=MARGIN, mmap=True,
                    log=lambda s: None)
    assert not got.generated
    mdir = tmp_path / (src.stem + "_mmap")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [src.name, mdir.name])
    for side, ref in (("truth", twin_data_shared.truth),
                      ("model", twin_data_shared.model)):
        d = getattr(got, side)
        assert sorted(d) == sorted(ref)
        for k in ref:
            assert isinstance(d[k], np.memmap), k
            np.testing.assert_array_equal(d[k], ref[k])
    assert [str(d) for d in got.dates] == \
        [str(d) for d in twin_data_shared.dates]


def test_skill_arm_trains_and_evaluates(twin, twin_data_shared):
    """skill_arm in the port alone: the arm's result has the script's
    keys, a lead a cycle, finite RMSE."""
    from speedy_ml_tpu_torch.experiments.skill_experiment import skill_arm
    d = twin_data_shared
    r = skill_arm(twin.gcm_imp, twin.layout, d.truth, d.model, d.dates,
                  n_train=N, m=M, topology="shift", n_ic=1, ncyc=3,
                  log=lambda s: None)
    assert sorted(r) == sorted(
        ["n_train", "m", "n_ic", "train_wall_s", "lead_days", "hybrid_rmse",
         "speedy_rmse", "hybrid_mean", "speedy_mean",
         "beats_speedy_all_leads", "per_ic"])
    assert r["lead_days"] == [0.25, 0.5, 0.75]
    assert np.isfinite(r["hybrid_rmse"]).all()
    assert np.isfinite(r["speedy_rmse"]).all()
    assert r["per_ic"][0]["ic"] == N + 8


# ---------------------------------------------------------------- stage E

E_GEOM = dict(trunc=30, nlon=96, nlat=48, nlev=8)
E_SPY, E_CYCLES, E_N = 8, 20, 20


def _stage_e_files(tmp: Path):
    """A seeded stream in three parts, a baseline file, stage C's json
    and truth, on the T30 grid."""
    rng = np.random.default_rng(11)
    nz, ny, nx = 8, 48, 96
    sig = np.linspace(0.05, 0.95, nz)[None, :, None, None]

    def atmo(T):
        t = 215 + 70 * sig + rng.normal(0, 2, (T, nz, ny, nx))
        u = 10 * (1 - sig) + rng.normal(0, 3, (T, nz, ny, nx))
        q = 10 * sig ** 3 + np.abs(rng.normal(0, 0.2, (T, nz, ny, nx)))
        return np.stack([t, u, u * 0.3, q], axis=1)

    for i, T in enumerate((7, 7, 6)):
        np.savez(tmp / f"hybrid_climate.part{i}.npz",
                 atmo=atmo(T).astype(np.float32),
                 logp=rng.normal(0, 0.01, (T, ny, nx)).astype(np.float32),
                 precip=rng.gamma(0.5, 2e-5, (T, ny, nx)).astype(np.float32),
                 sst=(290 + rng.normal(0, 1, (T, ny, nx))).astype(np.float32))
    climo = lambda *s: (250 + rng.normal(0, 5, s)).astype(np.float32)
    np.savez_compressed(
        tmp / "speedy_baseline.npz", climo_t=climo(E_SPY, 8, ny, nx),
        climo_u=climo(E_SPY, 8, ny, nx), climo_q=climo(E_SPY, 8, ny, nx),
        climo_ps=climo(E_SPY, ny, nx),
        sst_daily=climo(5, ny, nx), precip_daily=np.abs(climo(5, ny, nx)),
        logp_daily=climo(5, ny, nx))
    (tmp / "stage_c_done.json").write_text(json.dumps(dict(
        cycles=E_CYCLES, wall_s=12.5, safe=True, start="a", end="b",
        dispatch=4, sim_years=0.014)))
    truth = dict(atmo=atmo(E_N + 4), logp=rng.normal(0, 0.01, (E_N + 4, ny,
                                                                nx)),
                 precip=rng.gamma(0.5, 2e-5, (E_N + 4, ny, nx)))
    return truth


def _stage_e_transcription(tmp: Path, truth: dict, geom) -> dict:
    """climate_run.py:347-441 with the JAX package's analysis (numpy),
    SPY = E_SPY, N = E_N, the figures left out."""
    from speedy_ml_tpu.analysis import (climo_bias_from_climatology,
                                        doy_climatology,
                                        iter_prediction_parts,
                                        load_prediction_series, mass_drift,
                                        nino34_index, power_spectrum,
                                        sigma_to_pressure,
                                        streaming_doy_climatology,
                                        total_atmosphere_mass)
    SPY, N, STREAM = E_SPY, E_N, str(tmp / "hybrid_climate.npz")
    lat = np.rad2deg(geom.lat_radians)
    lon = np.arange(geom.nlon) * 360.0 / geom.nlon
    sst = load_prediction_series(STREAM, "sst")
    logp = load_prediction_series(STREAM, "logp")
    n_cycles = sst.shape[0]
    sim_years = n_cycles / SPY
    clim_h = streaming_doy_climatology(STREAM, SPY)
    tr = {k: v[:min(N, (N // SPY) * SPY)] for k, v in truth.items()}
    clim_t = {}
    for vi, k in ((0, "t"), (1, "u"), (3, "q")):
        clim_t[k] = doy_climatology(
            sigma_to_pressure(tr["atmo"][:, vi], tr["logp"]), SPY)
    clim_t["ps"] = doy_climatology(np.exp(tr["logp"]) * 1000.0, SPY)
    zb = np.load(tmp / "speedy_baseline.npz")
    clim_s = {k: zb[f"climo_{k}"] for k in ("t", "u", "q", "ps")}
    suite_h = climo_bias_from_climatology(clim_h, clim_t)
    suite_s = climo_bias_from_climatology(clim_s, clim_t)
    nino = nino34_index(sst, lat, lon, SPY)
    per, pw = power_spectrum(nino, 0.25)
    band = (per > 2 * 365) & (per < 7 * 365)
    peak_period_years = float(per[band][np.argmax(pw[band])] / 365.0) \
        if band.any() else None
    w = np.cos(np.deg2rad(lat))[:, None]
    gm = lambda f: float((f * w).sum() / (w.sum() * geom.nlon))
    acc_first, n_first, acc_last, n_last = 0.0, 0, 0.0, 0
    pos = 0
    for d in iter_prediction_parts(STREAM, keys=["atmo"]):
        B = d["atmo"].shape[0]
        for b in range(B):
            if pos + b < SPY:
                acc_first += gm(d["atmo"][b, 0, -1]); n_first += 1
            if pos + b >= n_cycles - SPY:
                acc_last += gm(d["atmo"][b, 0, -1]); n_last += 1
        pos += B
    t_first = acc_first / max(n_first, 1)
    t_last = acc_last / max(n_last, 1)
    t_drift_per_decade = (t_last - t_first) / max(sim_years - 1, 1) * 10.0
    md = mass_drift(logp[::4], lat)
    mass = total_atmosphere_mass(logp[::40], lat)
    stage_c = json.loads((tmp / "stage_c_done.json").read_text())
    return dict(
        m=3000, n_train=N, years_requested=20,
        sim_years=round(sim_years, 2),
        cycles=n_cycles,
        wall_s=stage_c["wall_s"],
        sim_years_per_day=round(sim_years / (stage_c["wall_s"] / 86400.0), 1),
        safe_never_tripped=bool(stage_c["safe"]),
        slab_ocean=True, ocean_beta=0.01, sst_bias=0.0,
        t_sfc_global_first_year=round(t_first, 3),
        t_sfc_global_last_year=round(t_last, 3),
        t_drift_K_per_decade=round(t_drift_per_decade, 4),
        mass_drift_rel=round(md, 6),
        mass_mean_kg=float(mass.mean()),
        nino34_std=round(float(nino.std()), 4),
        nino34_peak_period_years=peak_period_years,
        climo_rms_hybrid=suite_h["rms"], climo_rms_speedy=suite_s["rms"],
        hybrid_beats_speedy_climo={
            k: bool(suite_h["rms"][k] < suite_s["rms"][k])
            for k in suite_h["rms"]},
        figures=[],
        calendar="365-day" if "end" in stage_c else "leap-aware (r4 run)",
        prediction_start=stage_c.get("start"),
        prediction_end=stage_c.get("end"),
        boundary="synth")


def _same_result(got, ref, path="result"):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            _same_result(got[k], ref[k], f"{path}[{k!r}]")
    elif isinstance(ref, float):
        assert isinstance(got, float), path
        assert abs(got - ref) <= 1e-12 * max(abs(ref), 1e-300), path
    else:
        assert got == ref, path


@pytest.fixture(scope="module")
def stage_e(tmp_path_factory):
    from speedy_ml_tpu_torch.core.geometry import Geometry
    from speedy_ml_tpu_torch.experiments.climate_run import climate_products
    tmp = tmp_path_factory.mktemp("stage_e")
    truth = _stage_e_files(tmp)
    geom = Geometry(**E_GEOM)
    products = climate_products(str(tmp / "hybrid_climate.npz"),
                                tmp / "speedy_baseline.npz", truth, geom,
                                E_N, samples_per_year=E_SPY)
    return tmp, truth, geom, products


def test_verify_climate_matches_transcription(stage_e):
    """verify_climate on a seeded stream, baseline and truth: the
    script's keys, each value within 1e-12 of the transcription's (the
    peak RSS aside), the file written without NaN."""
    from speedy_ml_tpu_torch.experiments.climate_run import verify_climate
    tmp, truth, geom, products = stage_e
    got = verify_climate(products, tmp / "stage_c_done.json",
                         tmp / "CLIMATE_RUN.json", m=3000, n_train=E_N,
                         years=20, ocean_beta=0.01, boundary="synth")
    ref = _stage_e_transcription(tmp, truth, geom)
    assert json.loads((tmp / "CLIMATE_RUN.json").read_text()) == got
    assert got.pop("peak_rss_pct") > 0
    _same_result(got, ref)
    assert got["nino34_std"] > 0 and got["cycles"] == E_CYCLES


def test_climate_figures_drawn(stage_e, tmp_path):
    """climate_figures draws the four figures (matplotlib is here); the
    wavelet, of every 28th index value, gets a 16-year seeded index."""
    from speedy_ml_tpu_torch.experiments.climate_run import (FIGURES,
                                                             climate_figures)
    nino = np.random.default_rng(2).normal(0, 1, 16 * 1460)
    drawn = climate_figures(dict(stage_e[3], nino=nino), tmp_path,
                            log=lambda s: None)
    assert drawn == list(FIGURES)
    for name in FIGURES:
        assert (tmp_path / name).stat().st_size > 5000, name


# ----------------------------------------------------------- port alone

@pytest.mark.parametrize("start,n", [((1991, 2, 27, 6), 2 * 1460),
                                     ((1992, 2, 28, 18), 1460 + 7),
                                     ((1990, 12, 31, 12), 3 * 1460 + 1)])
def test_cal365_end_date_equals_jax(start, n):
    """Stage C's end date after n cycles on the 365-day calendar: the JAX
    package's ModelDate's, a whole number of years on for 1460 cycles a
    year."""
    from speedy_ml_tpu.data.calendar import ModelDate as JDate
    from speedy_ml_tpu_torch.data.calendar import ModelDate
    from speedy_ml_tpu_torch.experiments.climate_run import (SPY,
                                                             cal365_start)
    d, j = cal365_start(ModelDate(*start)), JDate(*start, cal365=True)
    for _ in range(n):
        d, j = d.advance_hours(6), j.advance_hours(6)
    assert str(d) == str(j)
    if n % SPY == 0:
        assert (d.year - start[0], d.month, d.day) == \
            (n // SPY, start[1], start[2])


def test_twin_cache_regenerated_when_bad(twin, tmp_path):
    """A generated cache is read back; one with a NaN, and one too short
    for the call, are deleted and generated again, finite."""
    from speedy_ml_tpu_torch.experiments.twin import (twin_cache_path,
                                                      twin_data, twin_dates)
    tw, quiet = twin, (lambda s: None)
    kw = dict(source=tw.source, spinup_days=1, log=quiet)
    first = twin_data(tw.gcm_true, tw.gcm_imp, 4, tmp_path, margin=4, **kw)
    path = twin_cache_path(tmp_path, 4, "synth")
    assert first.generated and path.exists()
    assert sorted(first.truth) == ["atmo", "logp", "precip", "sst", "tisr"]
    assert sorted(first.model) == ["atmo", "logp"]
    assert [str(d) for d in first.dates] == \
        [str(d) for d in twin_dates(8, 1)]
    again = twin_data(tw.gcm_true, tw.gcm_imp, 4, tmp_path, margin=4, **kw)
    assert not again.generated
    np.testing.assert_array_equal(again.truth["atmo"], first.truth["atmo"])
    z = dict(np.load(path))
    z["t_atmo"][2, 0, 3] = np.nan
    np.savez(path, **z)
    bad = twin_data(tw.gcm_true, tw.gcm_imp, 4, tmp_path, margin=4, **kw)
    assert bad.generated and np.isfinite(bad.truth["atmo"]).all()
    np.testing.assert_array_equal(bad.truth["atmo"], first.truth["atmo"])
    longer = twin_data(tw.gcm_true, tw.gcm_imp, 4, tmp_path, margin=6, **kw)
    assert longer.generated and longer.truth["atmo"].shape[0] == 10
    assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]


@pytest.fixture(scope="module")
def climate_dir(twin_data_shared, cache_dir, twin, tmp_path_factory):
    """run_climate at T10 on the shared twin cache, twice: stage C 8
    cycles in dispatches of 4, stage D 2 days, an 8-sample climatology
    year, the ocean reservoir at m = 300 (OCEAN_HYPER's 4,000 does not
    fit a CPU test)."""
    from speedy_ml_tpu_torch.experiments import climate_run
    out = tmp_path_factory.mktemp("climate")
    cfg = climate_run.ClimateConfig(m=M, n=N, atmo_beta=1.0, dispatch=4)
    kw = dict(twin=twin, cache_dir=cache_dir, cycles=8, baseline_days=2,
              samples_per_year=8, spinup_days=SPIN, margin=MARGIN,
              log=lambda s: None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(climate_run, "OCEAN_HYPER", dataclasses.replace(
            climate_run.OCEAN_HYPER, m=300))
        first = climate_run.run_climate(cfg, out, out / "CLIMATE_RUN.json",
                                        **kw)
        second = climate_run.run_climate(cfg, out, out / "CLIMATE_RUN.json",
                                         **kw)
    return out, first, second


def test_run_climate_stages_and_skipping(climate_dir):
    """The first run runs B-E (A: the cache is there) and writes each
    stage's files; the second runs no stage and returns the same
    result."""
    out, (res1, ran1), (res2, ran2) = climate_dir
    assert ran1 == ["B", "C", "D", "E"] and ran2 == []
    assert res1 == res2
    names = {p.name for p in out.iterdir()}
    assert {"hybrid_m300_N112.ckpt", "train_meta.json",
            "hybrid_climate.part0.npz", "monthly_means.npz",
            "stage_c_done.json", "speedy_baseline.npz",
            "CLIMATE_RUN.json"} <= names
    done = json.loads((out / "stage_c_done.json").read_text())
    assert sorted(done) == ["cycles", "dispatch", "end", "safe", "sim_years",
                            "start", "wall_s"]
    assert done["cycles"] == res1["cycles"] == 8
    assert "cal365=True" in done["start"]
    assert res1["nino34_std"] is None      # T10 has no Nino-3.4 latitude
    assert np.isfinite([res1["t_sfc_global_first_year"],
                        res1["mass_drift_rel"]]).all()


def test_run_climate_deletes_the_atmosphere_checkpoint(climate_dir):
    """C3: once the whole hybrid is saved, the ".atmo" checkpoint that
    held the atmosphere while the ocean trained is gone."""
    out = climate_dir[0]
    assert (out / "hybrid_m300_N112.ckpt" / "meta.json").exists()
    assert not (out / "hybrid_m300_N112.ckpt.atmo").exists()
    assert not [p for p in out.rglob("*") if ".atmo" in p.name]
    meta = json.loads((out / "hybrid_m300_N112.ckpt" / "meta.json")
                      .read_text())
    assert meta["has_ocean"]


def test_run_climate_draws_its_figures(climate_dir):
    """The figures the result lists are the files drawn (on the T10 grid
    the Nino-3.4 ones are left out)."""
    out, (res, _), _ = climate_dir
    assert res["figures"] == ["fig_climo_bias.png", "fig_precip.png"]
    for name in res["figures"]:
        assert (out / name).stat().st_size > 5000


def test_run_skill_merges_arms(monkeypatch, tmp_path, twin,
                               twin_data_shared, cache_dir):
    """run_skill merges its arms into an existing result file, writes
    after each arm, then the meta; skill_figure draws the shift arm."""
    from speedy_ml_tpu_torch.experiments import skill_experiment as se
    written = []

    def arm(*a, topology, **kw):
        written.append(sorted(json.loads(path.read_text())))
        return dict(lead_days=[0.25, 0.5], hybrid_rmse=[1.0, 2.0],
                    speedy_rmse=[1.5, 2.5], topology=topology)

    path = tmp_path / "SKILL_PROD_RESULT.json"
    path.write_text(json.dumps({"older": {"kept": 1}}))
    monkeypatch.setattr(se, "skill_arm", arm)
    res = se.run_skill(se.SkillConfig(n_train=N, m=M), path, twin=twin,
                       cache_dir=cache_dir, spinup_days=SPIN, margin=MARGIN,
                       log=lambda s: None)
    assert written == [["older"], ["older", "shift"]]
    assert sorted(res) == ["meta", "older", "random", "shift"]
    assert res["meta"]["geometry"] == "T10 32x16x8"
    assert res["meta"]["n_regions"] == N_REGIONS
    assert json.loads(path.read_text()) == res
    fig = se.skill_figure(path, tmp_path / "fig.png")
    assert Path(fig).stat().st_size > 5000


def test_no_default_output_path():
    """No function or config of the experiments has a path for a
    default: every file goes where the caller says."""
    from speedy_ml_tpu_torch.experiments import (__main__, climate_run,
                                                 skill_experiment, twin)
    for mod in (climate_run, skill_experiment, twin, __main__):
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if fn.__module__ != mod.__name__:
                continue
            for p in inspect.signature(fn).parameters.values():
                assert not isinstance(p.default, (str, Path)) or \
                    "/" not in str(p.default), (mod.__name__, name, p)
    for cfg in (climate_run.ClimateConfig(), skill_experiment.SkillConfig()):
        for f in dataclasses.fields(cfg):
            assert not isinstance(getattr(cfg, f.name), (str, Path)), f.name
    with pytest.raises(SystemExit):
        __main__._parser().parse_args(["climate"])     # --out is required


def test_module_entry_without_cuda_exits_and_writes_nothing(tmp_path):
    """`python -m speedy_ml_tpu_torch.experiments climate --out DIR` with
    no CUDA device: non-zero exit, resolve_device's message, DIR not
    made."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for program in ("climate", "skill"):
        out = subprocess.run(
            [sys.executable, "-m", "speedy_ml_tpu_torch.experiments",
             program, "--out", str(tmp_path / "out")], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert "no CUDA device is available" in out.stderr
    assert list(tmp_path.iterdir()) == []


# ------------------------------------------------- against the JAX side

def test_stage_d_baseline_matches_transcription(jax_side, twin,
                                                twin_data_shared, tmp_path):
    """speedy_baseline for 2 days from the stage's date against the
    transcription of climate_run.py:265-331: the carried spectral state
    and surface 1e-9 of each field's scale, the float32 climatologies
    and daily series 2 float32 ulps of each field's scale."""
    from speedy_ml_tpu_torch.experiments.climate_run import (SYNC,
                                                             speedy_baseline)
    path = tmp_path / "speedy_baseline.npz"
    state = speedy_baseline(twin.gcm_imp,
                            twin_data_shared.dates[N + SYNC + 8], DAYS_D,
                            path, samples_per_year=SPY_D, log=lambda s: None)
    ref = np.load(jax_side / "baseline_state.npz")
    for k in ref.files:
        part, name = k.split("_", 1)
        got = getattr(state.spectral if part == "spec" else state.sfc, name)
        assert _scale_close(got.numpy(), ref[k], 1e-9), k
    a, b = np.load(path), np.load(jax_side / "speedy_baseline.npz")
    assert sorted(a.files) == sorted(b.files) == sorted(
        ["climo_t", "climo_u", "climo_q", "climo_ps", "sst_daily",
         "precip_daily", "logp_daily"])
    for k in b.files:
        assert a[k].dtype == np.float32 and np.isfinite(b[k]).all(), k
        assert _ulps_close(a[k], b[k], 2), k
    assert a["sst_daily"].shape == (DAYS_D, 16, 32)


def _jax_packs(path, layout):
    """The JAX arm's (reservoir, standardizer) pairs from its file."""
    z = np.load(path)
    pairs = []
    for i in range(len(layout.classes)):
        get = lambda pre, k: z[f"{i}_{pre}_{k}"] \
            if f"{i}_{pre}_{k}" in z.files else None
        res = types.SimpleNamespace(**{k: get("res", k) for k in (
            "cols", "vals", "win_vals", "wout", "mean", "std", "n_in",
            "shifts", "win_cols")})
        std = types.SimpleNamespace(**{k: get("std", k) for k in (
            "comp_mean", "comp_std", "in_mean", "in_std", "out_mean",
            "out_std")})
        pairs.append((res, std))
    return pairs


def test_skill_forecasts_match_transcription(jax_side, twin,
                                             twin_data_shared):
    """The skill protocol's evaluation with the JAX arm's weights carried
    across by convert.py ("random" topology): 2 ICs x 4 cycles, both
    RMSE lists 1e-9."""
    from speedy_ml_tpu_torch.convert import params_from_numpy
    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
    from speedy_ml_tpu_torch.experiments.skill_experiment import \
        skill_forecasts
    from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere

    packs = params_from_numpy(_jax_packs(jax_side / "params.npz",
                                         twin.layout),
                              twin.layout, ESNHyper(m=M), device="cpu",
                              dtype=torch.float64)
    hyb = HybridAtmosphere(twin.gcm_imp, twin.layout, packs, ml_only=False,
                           device="cpu")
    d = twin_data_shared
    got = skill_forecasts(hyb, twin.gcm_imp, d.truth, d.model, d.dates, ICS,
                          NCYC, tag=TOPOLOGY, log=lambda s: None)
    ref = json.loads((jax_side / "skill.json").read_text())
    assert [p["ic"] for p in got] == [p["ic"] for p in ref] == list(ICS)
    for g, r in zip(got, ref):
        for k in ("hybrid", "speedy"):
            assert len(g[k]) == len(r[k]) == NCYC
            assert np.isfinite(r[k]).all()
            np.testing.assert_allclose(g[k], r[k], rtol=1e-9, atol=0)

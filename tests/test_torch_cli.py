"""Port parity of the config-driven entry point (config.py, main.py) and
of the host modules it needs (analysis.py, plots.py,
data/netcdf_export.py, runtime/native.py), on the CPU in float64.

The CLI case writes synthetic ERA year-files and forecast-state files
(smooth seeded fields in physical ranges, hourly records) and runs
`main train` then `main predict` (two cycles) on one tiny config, T10
on a 32 x 16 grid with 8 levels, 128 regions, m = 600, two GCM steps a
window (nsteps_day = 8), coupled, no slab ocean and no persistent
surface, beta_res 0.1, no training noise, in each package.  The port's
`generate` is patched to hand back the JAX package's reservoir of each
class (jax.random.fold_in(jax.random.key(seed), i)), so both sides
train the same reservoirs.  Tolerances: Wout 1e-8 of each class's
scale; the prediction and time-mean streams 1e-9 of each array's scale,
where prediction.npz, which the writer stores in float32, may also be
one float32 ulp of the element apart (a difference of 1e-12 can round
either way).  The ridge is tests/test_torch_training.py's: at
beta_res 1e-2 the solve amplifies the Grams' summation-order rounding to
~2e-9 of Wout, port against JAX, and the streams by as much.
A second case runs `main run` in the port alone with the defaults' slab
ocean and persistent surface (self-contained, a slab step every 3
cycles): `main predict` from its checkpoint must repeat its stream bit
for bit.  The other cases compare the host modules with the JAX
package's copies exactly.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_lane import one_thread_per_pool  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
YEAR = 1990
NZ, NLAT, NLON = 8, 16, 32
TINY = dict(trunc=10, nlon=NLON, nlat=NLAT, nlev=NZ, n_regions=128,
            nsteps_day=8, dtype="float64", start_year=YEAR)
ATMO = dict(m=600, deg=3, beta_res=0.1, noise_mag=0.0)
# the ERA run: 72 hourly samples in 6 sub-series, a 12-h sync window,
# two 6-h cycles
ERA_RUN = dict(training_hours=72, discard_hours=24, sync_hours=12,
               prediction_hours=12, n_batches=4, slab_ocean=False,
               persist_surface=False)
N_HOURS = 96


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _close(got, ref, rtol):
    """Each element within rtol of the array's scale or, in a float32
    array, within one float32 ulp of the reference element."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    tol = rtol * max(float(np.abs(ref).max()), 1e-300)
    if ref.dtype == np.float32:
        tol = np.maximum(tol, np.spacing(np.abs(ref)).astype(np.float64))
    return bool((d <= tol).all())


def era_fields(seed: int, n_hours: int) -> dict:
    """Smooth fields in physical ranges with a daily cycle and seeded
    noise: T by level and latitude, a westerly jet, moisture near the
    surface, the raw ERA units (q in kg/kg).  Stored in float64: both
    packages take the log of the precipitation in the file's type, and
    float32 logs of two libraries differ in the last bit."""
    rng = np.random.default_rng(seed)
    sig = np.linspace(0.05, 0.95, NZ)[None, :, None, None]
    lat = np.linspace(-1.4, 1.4, NLAT)[None, None, :, None]
    lon = np.linspace(0, 2 * np.pi, NLON, endpoint=False)[None, None,
                                                          None, :]
    hr = np.arange(n_hours)[:, None, None, None]
    day = np.sin(2 * np.pi * hr / 24 + lon)
    c2 = np.cos(lat) ** 2
    n3 = lambda s: rng.normal(0, s, (n_hours, NZ, NLAT, NLON))
    n2 = lambda s: rng.normal(0, s, (n_hours, NLAT, NLON))
    return {
        "Temperature": 215 + 70 * sig + 25 * (c2 - 0.5) + day + n3(0.5),
        "U-wind": 20 * np.cos(lat) * (1 - sig) + 2 * day + n3(1.0),
        "V-wind": day + n3(1.0),
        "Specific-Humidity": (0.012 * sig ** 3 * c2 * (1 + 0.1 * day)
                              + np.abs(n3(2e-5))),
        "logp": 0.01 * day[:, 0] + n2(0.002),
        "tp": np.abs(4e-5 * c2[:, 0] * (1 + day[:, 0]) + n2(1e-5)),
        "sst": 273 + 27 * c2[:, 0] + 0.2 * day[:, 0] + n2(0.1),
        "tisr": np.maximum(0.0, 420 * np.cos(lat[:, 0])
                           * (0.5 + 0.5 * day[:, 0])),
    }


def write_era_files(root: Path):
    """One ERA year-file and one forecast-state year-file (hourly
    records, so that every hourly sub-series has its forecasts)."""
    import h5py
    from speedy_ml_tpu_torch.data.model_states import write_model_states
    root.mkdir(parents=True, exist_ok=True)
    with h5py.File(root / f"era_5_y{YEAR}_regridded_mpi_fixed_var_gcc.nc",
                   "w") as f:
        for k, v in era_fields(1, N_HOURS).items():
            f.create_dataset(k, data=v)
    m = era_fields(2, N_HOURS)
    atmo = np.stack([m["Temperature"], m["U-wind"], m["V-wind"],
                     1000.0 * m["Specific-Humidity"]], axis=1)
    write_model_states(str(root / f"restart_6hour_y{YEAR}.nc"), atmo,
                       m["logp"], hours_per_record=1)


def jax_reservoir_patch(mp, seed: int, n_classes: int):
    """Patch the port's generate (hybrid.chunked's) to return the JAX
    package's reservoir of class i for the port's seed of class i."""
    import jax
    import jax.numpy as jnp
    from speedy_ml_tpu.esn import reservoir as jres
    from speedy_ml_tpu_torch.hybrid import chunked
    from speedy_ml_tpu_torch.hybrid.build import derive_seed

    key = jax.random.key(seed)
    keys = {derive_seed(seed, i): jax.random.fold_in(key, i)
            for i in range(n_classes)}

    def generate(s, n_regions, n_inputs, hyper, radius,
                 dtype=torch.float32, topology="shift", device=None, **kw):
        cols, vals, win, shifts = jres.generate(
            keys[s], n_regions, n_inputs,
            jres.ESNHyper(**dataclasses.asdict(hyper)), np.asarray(radius),
            dtype=jnp.float64, topology=topology)
        return (torch.as_tensor(np.array(cols), dtype=torch.int32,
                                device=device),
                torch.as_tensor(np.array(vals), dtype=dtype, device=device),
                torch.as_tensor(np.array(win), dtype=dtype, device=device),
                None if shifts is None else tuple(int(s) for s in shifts))

    mp.setattr(chunked, "generate", generate)


def _configs(tmp: Path, **kw):
    """The same config in each package, saved; returns the two paths."""
    from speedy_ml_tpu.config import RunConfig as JRunConfig
    from speedy_ml_tpu.esn.reservoir import ESNHyper as JESNHyper
    paths = {}
    for side in ("jax", "torch"):
        cfg = JRunConfig(**TINY, **kw, atmo=JESNHyper(**ATMO),
                         checkpoint_path=str(tmp / side / "ckpt"),
                         output_path=str(tmp / side / "out"))
        paths[side] = tmp / f"{side}.json"
        cfg.save(paths[side])
    return paths


# the JAX package's train and predict run in a process of their own with
# one XLA thread and one thread per native pool: as fast alone as with a
# thread per core (its compiles take the time), and it leaves the cores of
# the lane's other workers alone
JAX_SIDE = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from speedy_ml_tpu.main import main
for mode in ("train", "predict"):
    assert main([mode, sys.argv[1]]) == 0
"""
ONE_THREAD_ENV = dict(
    XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1",
    OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")


@pytest.fixture(scope="module")
def era_cli(tmp_path_factory):
    """train + predict in each package on the ERA files; the port also
    predicts from the JAX package's checkpoint."""
    from speedy_ml_tpu_torch.config import RunConfig
    from speedy_ml_tpu_torch.main import main

    tmp = tmp_path_factory.mktemp("cli")
    write_era_files(tmp / "era")
    paths = _configs(tmp, era_path=str(tmp / "era"), **ERA_RUN)
    out = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(paths["jax"])], cwd=REPO,
        env=dict(os.environ, **ONE_THREAD_ENV), capture_output=True,
        text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    cfg = RunConfig.load(paths["torch"])
    with pytest.MonkeyPatch.context() as mp:
        jax_reservoir_patch(mp, cfg.seed,
                            len(cfg.build_layout().classes))
        assert main(["train", str(paths["torch"])], device="cpu") == 0
    assert main(["predict", str(paths["torch"])], device="cpu") == 0
    # the port's predict from the JAX package's checkpoint
    cross = dataclasses.replace(cfg, checkpoint_path=str(tmp / "jax" /
                                                         "ckpt"),
                                output_path=str(tmp / "cross" / "out"))
    cross.save(tmp / "cross.json")
    assert main(["predict", str(tmp / "cross.json")], device="cpu") == 0
    return tmp


def _load(path):
    z = np.load(path)
    return {k: z[k] for k in z.files}


def test_train_wout_matches_jax(era_cli):
    """Each class's Wout and standardizer: 1e-8 of its scale."""
    jd, td = era_cli / "jax" / "ckpt", era_cli / "torch" / "ckpt"
    meta = json.loads((jd / "meta.json").read_text())
    assert json.loads((td / "meta.json").read_text())["n_classes"] == \
        meta["n_classes"] == 3
    for i in range(meta["n_classes"]):
        a, b = _load(td / f"class_{i}.npz"), _load(jd / f"class_{i}.npz")
        assert sorted(a) == sorted(b)
        assert float(np.abs(b["res_wout"]).max()) > 0
        for k in b:
            assert _rel(a[k], b[k]) <= 1e-8, (i, k)


@pytest.mark.parametrize("side", ["torch", "cross"])
@pytest.mark.parametrize("name", ["prediction.npz", "time_means.npz"])
def test_predict_streams_match_jax(era_cli, side, name):
    """The prediction and time-mean streams of the port's train + predict
    ("torch") and of the port's predict from the JAX checkpoint
    ("cross") against the JAX package's: 1e-9 of each array's scale."""
    a = _load(era_cli / side / "out" / name)
    b = _load(era_cli / "jax" / "out" / name)
    assert sorted(a) == sorted(b)
    if name == "prediction.npz":
        assert b["atmo"].shape == (2, 4, NZ, NLAT, NLON)
    for k in b:
        assert np.isfinite(b[k]).all(), k
        assert _close(a[k], b[k], 1e-9), k


def test_config_round_trips_between_packages(tmp_path):
    """JAX saves, the port loads and saves, the JAX package loads again:
    the same dict, geometry and layout classes."""
    from speedy_ml_tpu.config import RunConfig as JRunConfig
    from speedy_ml_tpu.esn.reservoir import ESNHyper as JESNHyper
    from speedy_ml_tpu_torch.config import RunConfig
    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper

    j = JRunConfig(trunc=10, nlon=32, nlat=16, n_regions=128,
                   sea_domains=("natlan", "tropic"), era_path="/data/era",
                   atmo=JESNHyper(m=700, beta_res=1e-2), seed=5)
    j.save(tmp_path / "a.json")
    t = RunConfig.load(tmp_path / "a.json")
    assert isinstance(t.atmo, ESNHyper) and isinstance(t.ocean, ESNHyper)
    assert t.atmo.m == 700 and t.ocean == ESNHyper(
        m=4000, sigma=0.6, beta_res=1e-4, noise_mag=0.10, using_prior=False)
    assert t.sea_domains == ("natlan", "tropic")
    t.save(tmp_path / "b.json")
    j2 = JRunConfig.load(tmp_path / "b.json")
    assert dataclasses.asdict(j2) == dataclasses.asdict(JRunConfig.load(
        tmp_path / "a.json"))
    assert json.loads((tmp_path / "a.json").read_text()) == \
        json.loads((tmp_path / "b.json").read_text())
    # the defaults and their JSON are the JAX package's
    assert json.dumps(dataclasses.asdict(RunConfig())) == \
        json.dumps(dataclasses.asdict(JRunConfig()))
    jg, tg = j.geometry(), t.geometry()
    for k in ("trunc", "nlon", "nlat", "nlev"):
        assert getattr(jg, k) == getattr(tg, k)
    np.testing.assert_array_equal(tg.lat_radians, np.asarray(jg.lat_radians))
    jl, tl = j.build_layout(), t.build_layout()
    assert [(c.name, c.count, c.core_shape) for c in jl.classes] == \
        [(c.name, c.count, c.core_shape) for c in tl.classes]
    for c, d in zip(jl.classes, tl.classes):
        np.testing.assert_array_equal(np.asarray(c.region_ids),
                                      np.asarray(d.region_ids))


def test_build_gcm_boundaries_and_flags(tmp_path, monkeypatch):
    """build_gcm: the dtype, the coupling flags and the optional physics
    reach the port's GCM; off the 96 x 48 grid the aquaplanet; at 96 x 48
    without fort.2x files the aquaplanet too; an explicit bc_path that
    holds no files raises."""
    from speedy_ml_tpu_torch.config import RunConfig
    from speedy_ml_tpu_torch.physics.boundaries import \
        synthetic_boundary_data

    cfg = RunConfig(trunc=10, nlon=32, nlat=16, dtype="float64", icsea=2,
                    sea_domains=("natlan",), sppt_on=True, cgrate_on=True,
                    nsteps_day=8)
    gcm = cfg.build_gcm(device="cpu")
    assert gcm.dtype == torch.float64 and gcm.nsteps_day == 8
    assert gcm.cpl.icsea == 2 and gcm.cpl.sea_domains == ("natlan",)
    assert gcm.sppt is not None and gcm.dyn.cgrate_on
    ref = synthetic_boundary_data(cfg.geometry(), dtype=torch.float64)
    assert torch.equal(gcm.bd.sst12, ref.sst12)
    with pytest.raises(FileNotFoundError):
        dataclasses.replace(cfg, bc_path=str(tmp_path / "none")) \
            .build_gcm(device="cpu")
    with pytest.raises(ValueError, match="names no torch dtype"):
        dataclasses.replace(cfg, dtype="float7").torch_dtype()
    monkeypatch.setenv("SPEEDY_ML_BC_PATH", str(tmp_path / "none"))
    t30 = RunConfig()
    assert torch.equal(t30.build_gcm(device="cpu").bd.sst12,
                       synthetic_boundary_data(t30.geometry()).sst12)


def test_run_with_slab_ocean_and_persistent_surface(tmp_path, monkeypatch):
    """`main run` in the port with the defaults' slab ocean and persistent
    surface, self-contained, a slab step every 3 cycles: a finite stream;
    `main predict` from its checkpoint repeats it bit for bit.  Four GCM
    steps a window: the aquaplanet nature run at two goes NaN."""
    from speedy_ml_tpu_torch.config import RunConfig
    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
    from speedy_ml_tpu_torch.main import main

    cfg = RunConfig(**dict(TINY, nsteps_day=16), atmo=ESNHyper(**ATMO),
                    ocean=ESNHyper(m=300, sigma=0.6, beta_res=1e-2,
                                   noise_mag=0.0, using_prior=False),
                    training_hours=96, discard_hours=24, sync_hours=12,
                    prediction_hours=24, n_batches=4,
                    timestep_slab_hours=18,
                    checkpoint_path=str(tmp_path / "ckpt"),
                    output_path=str(tmp_path / "run"))
    assert cfg.slab_ocean and cfg.persist_surface
    cfg.save(tmp_path / "run.json")
    # the forms of K22 and K21 the run calls (their CPU routes count
    # nothing)
    from speedy_ml_tpu_torch import gcm as gcm_mod
    from speedy_ml_tpu_torch.hybrid import model
    forms = []
    slab_ocean, slab_couple = model.slab_ocean, gcm_mod.slab_couple

    def count_ocean(form, **kw):
        forms.append(form)
        return slab_ocean(form, **kw)

    def count_couple(*a, **kw):
        forms.append("couple")
        return slab_couple(*a, **kw)

    monkeypatch.setattr(model, "slab_ocean", count_ocean)
    monkeypatch.setattr(gcm_mod, "slab_couple", count_couple)
    assert main(["run", str(tmp_path / "run.json")], device="cpu") == 0
    # four cycles: a push every cycle, the slab step at cycle 2, and the
    # persistent coupled surface's daily couplings
    assert {f: forms.count(f) for f in ("push", "push_mean", "sst")} == \
        {"push": 3, "push_mean": 1, "sst": 1}
    assert forms.count("couple") > 0
    again = dataclasses.replace(cfg, output_path=str(tmp_path / "again"))
    again.save(tmp_path / "again.json")
    assert main(["predict", str(tmp_path / "again.json")],
                device="cpu") == 0
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["has_ocean"]
    for name in ("prediction.npz", "time_means.npz"):
        a = _load(tmp_path / "run" / name)
        b = _load(tmp_path / "again" / name)
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.isfinite(a[k]).all(), (name, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert _load(tmp_path / "run" / "prediction.npz")["sst"].shape[0] == 4


def test_plot_mode(tmp_path):
    """`main plot` from a seeded stream: the five figures of
    tests/test_plot_mode.py, with no GCM built."""
    from speedy_ml_tpu_torch.config import RunConfig
    from speedy_ml_tpu_torch.main import main

    T = 12
    cfg = RunConfig(trunc=10, nlon=NLON, nlat=NLAT, n_regions=128,
                    ml_only=True, output_path=str(tmp_path))
    cfg.save(tmp_path / "cfg.json")
    rng = np.random.default_rng(0)
    np.savez_compressed(
        tmp_path / "prediction.npz",
        atmo=280 + rng.normal(0, 5, (T, 4, NZ, NLAT, NLON)),
        logp=rng.normal(0, 0.01, (T, NLAT, NLON)),
        precip=rng.gamma(0.5, 2.0, (T, NLAT, NLON)),
        sst=300 + rng.normal(0, 1, (T, NLAT, NLON)))
    assert main(["plot", str(tmp_path / "cfg.json")]) == 0
    figs = sorted(p.name for p in (tmp_path / "figures").glob("*.png"))
    assert figs == ["global_mean_t.png", "precip_extremes.png",
                    "qbo_section.png", "sst_anomaly.png",
                    "zonal_mean_u.png"]   # < 2 years: no ENSO figures
    for p in (tmp_path / "figures").glob("*.png"):
        assert p.stat().st_size > 5000, p


def _analysis_cases(rng):
    lat = np.linspace(-75, 75, NLAT)
    lon = np.arange(NLON) * 360.0 / NLON
    sst = 300 + rng.normal(0, 1, (40, NLAT, NLON))
    u = rng.normal(0, 10, (40, NZ, NLAT, NLON))
    logp = rng.normal(0, 0.01, (40, NLAT, NLON))
    precip = rng.gamma(0.5, 2e-5, (40, NLAT, NLON))
    t = 250 + rng.normal(0, 10, (40, NZ, NLAT, NLON))
    atmo = np.stack([t, u, u * 0.5, np.abs(u) * 0.1], axis=1)
    series = rng.normal(0, 1, 64)
    return {
        "region_mean": (sst, lat, lon, (-5.0, 5.0), (300.0, 40.0)),
        "nino34_index": (sst, lat, lon, 8),
        "power_spectrum": (series, 0.25),
        "precip_extremes": (precip,),
        "total_precip_timeseries": (precip, lat),
        "total_atmosphere_mass": (logp, lat),
        "mass_drift": (logp, lat),
        "morlet_cwt": (series, 0.25),
        "wavelet_power_spectrum": (series, 0.25),
        "zonal_mean": (u,),
        "ssw_reversal_fraction": (u, lat, 1 + np.arange(40) % 12),
        "qbo_section": (u, lat),
        "sigma_to_pressure": (t, logp),
        "doy_climatology": (sst, 8),
        "season_indices": (4,),
        "climo_bias_suite": (dict(atmo=atmo, logp=logp),
                             dict(atmo=atmo[::-1], logp=logp[::-1]), 8,
                             lat),
        "annual_precip_totals": (precip, 8, 21600.0),
    }


def _same(a, b, path="out"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), path
        for k in b:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


@pytest.mark.parametrize("name", sorted(_analysis_cases(
    np.random.default_rng(0))))
def test_analysis_equals_jax(name):
    """Every analysis function on seeded arrays: the JAX package's copy's
    result exactly."""
    from speedy_ml_tpu import analysis as janalysis
    from speedy_ml_tpu_torch import analysis

    args = _analysis_cases(np.random.default_rng(3))[name]
    _same(getattr(analysis, name)(*args), getattr(janalysis, name)(*args))
    for k in ("SPEEDY_SIGMA", "TARGET_PRESSURES"):
        np.testing.assert_array_equal(getattr(analysis, k),
                                      getattr(janalysis, k))


def test_analysis_streaming_parts_equal_jax(tmp_path):
    """The part readers and the streaming climatology over a stream
    left as .partN.npz files."""
    from speedy_ml_tpu import analysis as janalysis
    from speedy_ml_tpu_torch import analysis

    rng = np.random.default_rng(4)
    for i in range(3):
        np.savez(tmp_path / f"pred.part{i}.npz",
                 atmo=250 + rng.normal(0, 10, (6, 4, NZ, NLAT, NLON)),
                 logp=rng.normal(0, 0.01, (6, NLAT, NLON)))
    stem = str(tmp_path / "pred")
    assert analysis.prediction_part_paths(stem) == \
        janalysis.prediction_part_paths(stem)
    _same(analysis.load_prediction_series(stem, "logp"),
          janalysis.load_prediction_series(stem, "logp"))
    cp = analysis.streaming_doy_climatology(stem, 8)
    _same(cp, janalysis.streaming_doy_climatology(stem, 8))
    ct = {k: v[::-1] if k != "n_years" else v for k, v in cp.items()}
    _same(analysis.climo_bias_from_climatology(cp, ct),
          janalysis.climo_bias_from_climatology(cp, ct))


def test_netcdf_export_equals_jax(tmp_path):
    """The port's export: the JAX package's variables, attributes and
    values."""
    from scipy.io import netcdf_file
    from speedy_ml_tpu.data.netcdf_export import \
        export_prediction_netcdf as jexport
    from speedy_ml_tpu_torch.data.netcdf_export import \
        export_prediction_netcdf

    rng = np.random.default_rng(5)
    T = 3
    np.savez(tmp_path / "pred.npz",
             atmo=280 + rng.normal(0, 5, (T, 4, NZ, NLAT, NLON)),
             logp=rng.normal(0, 0.01, (T, NLAT, NLON)),
             precip=rng.gamma(0.5, 2e-5, (T, NLAT, NLON)),
             sst=300 + rng.normal(0, 1, (T, NLAT, NLON)))
    export_prediction_netcdf(str(tmp_path / "pred.npz"),
                             str(tmp_path / "port.nc"))
    jexport(str(tmp_path / "pred.npz"), str(tmp_path / "jax.nc"))
    with netcdf_file(tmp_path / "port.nc", "r", mmap=False) as a, \
            netcdf_file(tmp_path / "jax.nc", "r", mmap=False) as b:
        assert a.dimensions == b.dimensions
        assert sorted(a.variables) == sorted(b.variables) == sorted(
            ["Lon", "Lat", "Sigma_Level", "Temperature", "U-wind",
             "V-wind", "Specific-Humidity", "logp", "p6hr", "SST"])
        for k in b.variables:
            va, vb = a.variables[k], b.variables[k]
            assert va.dimensions == vb.dimensions, k
            assert va._attributes == vb._attributes, k
            np.testing.assert_array_equal(va[:], vb[:], err_msg=k)
        assert a.variables["Temperature"].shape == (T, NZ, NLAT, NLON)
    assert (tmp_path / "port.nc").read_bytes() == \
        (tmp_path / "jax.nc").read_bytes()


def test_native_equals_plain_and_jax(tmp_path):
    """The port's g++ build against its numpy versions and the JAX
    package's reader, exactly."""
    from speedy_ml_tpu.runtime import native as jnative
    from speedy_ml_tpu_torch.runtime import native

    so = native.build()
    assert so.parent.parent == native.BUILD_ROOT and so.exists()
    rng = np.random.default_rng(6)
    data = rng.standard_normal((3, NLAT, NLON)).astype("<f4")
    data[1, 2, 3] = -1000.0
    path = tmp_path / "fort.99"
    data.tofile(path)
    for group in range(3):
        got = native.read_boundary_field(str(path), group, NLON, NLAT)
        np.testing.assert_array_equal(
            got, native.read_boundary_field_plain(str(path), group, NLON,
                                                  NLAT))
        np.testing.assert_array_equal(
            got, jnative.read_boundary_field(path, group, NLON, NLAT))
    # the missing value (group 1, stored row 2) is 0 after the flip
    assert native.read_boundary_field(str(path), 1, NLON,
                                      NLAT)[NLAT - 3, 3] == 0.0
    with pytest.raises(OSError):
        native.read_boundary_field(str(tmp_path / "none"), 0, NLON, NLAT)
    fields = rng.standard_normal((4, NLAT, NLON)).astype(np.float32)
    iy = rng.integers(0, NLAT, size=(10, 3)).astype(np.int32)
    ix = rng.integers(0, NLON, size=(10, 4)).astype(np.int32)
    got = native.gather_series(fields, iy, ix, n_threads=4)
    np.testing.assert_array_equal(got,
                                  native.gather_series_plain(fields, iy, ix))
    np.testing.assert_array_equal(
        got, jnative.gather_series(fields, iy, ix, n_threads=4))
    with pytest.raises(IndexError, match="iy outside"):
        native.gather_series(fields, iy + NLAT, ix)
    with pytest.raises(IndexError, match="ix outside"):
        native.gather_series(fields, iy, ix - NLON)


def test_module_entry_without_cuda_exits_and_writes_nothing(tmp_path):
    """`python -m speedy_ml_tpu_torch.main run cfg.json` with no CUDA
    device: non-zero exit, resolve_device's message, no output."""
    from speedy_ml_tpu_torch.config import RunConfig

    cfg = RunConfig(**TINY, checkpoint_path=str(tmp_path / "ckpt"),
                    output_path=str(tmp_path / "out"))
    cfg.save(tmp_path / "cfg.json")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "speedy_ml_tpu_torch.main", "run",
         str(tmp_path / "cfg.json")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert not torch.cuda.is_available()
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cfg.json"]

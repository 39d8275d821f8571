"""Port parity of the data readers: data/era.py, data/model_states.py and
hybrid/chunked.ERASource, on small files the tests write in tmp_path.

The ERA files hold seeded random float32 fields: a leap year of 8,784
hours (so that the Feb-29 splice runs) and 96 hours of the next year, on
a 4 x 8 grid with 2 levels.  The port's ERASource must return exactly
the JAX ERASource's arrays (as CPU tensors) around the splice, for a
chunk across the year boundary, with a sample stride and with SST
anomalies.  The forecast-state files round-trip between the packages,
and a trainer run from an ERASource equals the run from an ArraySource
over the same arrays, bit for bit.  Every comparison here is exact.
"""

import types

import numpy as np
import pytest
import torch

from speedy_ml_tpu.data.era import ERA5Reader as JERA5Reader
from speedy_ml_tpu.data.model_states import \
    ModelStateReader as JModelStateReader
from speedy_ml_tpu.data.model_states import \
    write_model_states as jwrite_model_states
from speedy_ml_tpu.hybrid.chunked import ERASource as JERASource
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data import era, model_states
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid import chunked
from speedy_ml_tpu_torch.hybrid.training import (generate_nature_run,
                                                 make_imperfect_forecasts)
from speedy_ml_tpu_torch.physics.boundaries import synthetic_boundary_data
from torch_lane import one_thread_per_pool  # noqa: F401

LEAP0 = 1992
NAMES_3D = ("Temperature", "U-wind", "V-wind", "Specific-Humidity")
NAMES_2D = ("logp", "tp", "sst", "tisr")


def write_era_year(path, n_hours, nlat, nlon, nz, seed):
    import h5py
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        for name in NAMES_3D:
            f.create_dataset(name, data=rng.normal(
                0, 1, (n_hours, nz, nlat, nlon)).astype(np.float32))
        for name in NAMES_2D:
            f.create_dataset(name, data=rng.normal(
                0, 1, (n_hours, nlat, nlon)).astype(np.float32))


def _era_file(root, year):
    return root / f"era_5_y{year}_regridded_mpi_fixed_var_gcc.nc"


@pytest.fixture(scope="module")
def era_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("era")
    write_era_year(_era_file(root, LEAP0), 8784, 4, 8, 2, seed=1)
    write_era_year(_era_file(root, LEAP0 + 1), 96, 4, 8, 2, seed=2)
    return root


def _same(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.is_tensor(got[k]) and got[k].device.type == "cpu", k
        np.testing.assert_array_equal(got[k].numpy(), ref[k], k)
        assert got[k].numpy().dtype == ref[k].dtype, k


@pytest.mark.parametrize("stride,idx", [
    (1, np.arange(59 * 24 - 3, 59 * 24 + 4)),   # across the Feb-29 splice
    (1, np.arange(8755, 8767)),                  # across the year boundary
    (6, np.arange(1455, 1465)),                  # strided, across it too
    (1, np.array([8780, 3, 8759, 1500]))])       # unordered, two years
def test_erasource_equals_jax(era_root, stride, idx):
    src = chunked.ERASource(era.ERA5Reader(era_root), LEAP0, 2 * 8760,
                            sample_stride_hours=stride)
    ref = JERASource(JERA5Reader(era_root), LEAP0, 2 * 8760,
                     sample_stride_hours=stride)
    _same(src.truth_at(idx), ref.truth_at(idx))
    assert src.model_at(idx) is None


def test_erasource_sst_anomalies_and_model_reader(era_root, tmp_path):
    climo = np.random.default_rng(4).normal(0, 1, (365, 4, 8))
    rpy = 8760 // 6
    rng = np.random.default_rng(5)
    for y in (LEAP0, LEAP0 + 1):
        jwrite_model_states(tmp_path / f"restart_6hour_y{y}.nc",
                            rng.normal(0, 1, (rpy, 4, 2, 4, 8)),
                            rng.normal(0, 1, (rpy, 4, 8)))
    src = chunked.ERASource(
        era.ERA5Reader(era_root), LEAP0, 2 * 8760, sample_stride_hours=6,
        sst_climo=climo,
        model_reader=model_states.ModelStateReader(tmp_path, LEAP0).model_at)
    ref = JERASource(
        JERA5Reader(era_root), LEAP0, 2 * 8760, sample_stride_hours=6,
        sst_climo=climo,
        model_reader=JModelStateReader(tmp_path, LEAP0).model_at)
    idx = np.arange(1450, 1466)
    _same(src.truth_at(idx), ref.truth_at(idx))
    _same(src.model_at(idx), ref.model_at(idx))
    raw = chunked.ERASource(era.ERA5Reader(era_root), LEAP0, 2 * 8760,
                            sample_stride_hours=6).truth_at(idx)
    assert not torch.equal(raw["sst"], src.truth_at(idx)["sst"])


def test_era_reader_and_climatology_equal_jax(era_root):
    a, b = era.ERA5Reader(era_root), JERA5Reader(era_root)
    assert a.available_years(1990, 1995) == b.available_years(1990, 1995) \
        == [LEAP0, LEAP0 + 1]
    for y in (LEAP0, LEAP0 + 1):
        np.testing.assert_array_equal(a.valid_hour_index(y),
                                      b.valid_hour_index(y))
    assert len(a.valid_hour_index(LEAP0)) == 8760
    chunks = list(a.stream_samples(LEAP0, 8770, chunk_hours=4000))
    ref = list(b.stream_samples(LEAP0, 8770, chunk_hours=4000))
    assert len(chunks) == len(ref) == 4
    for c, r in zip(chunks, ref):
        for k in r:
            np.testing.assert_array_equal(c[k], r[k])
    from speedy_ml_tpu.data.era import daily_sst_climatology as jclimo
    np.testing.assert_array_equal(era.daily_sst_climatology(a, [LEAP0]),
                                  jclimo(b, [LEAP0]))


def test_model_state_files_interchange(tmp_path):
    rng = np.random.default_rng(6)
    rpy = 8760 // 6
    atmo = rng.normal(0, 1, (rpy, 4, 2, 3, 5)).astype(np.float32)
    logp = rng.normal(0, 1, (rpy, 3, 5)).astype(np.float32)
    # the port writes tensors, JAX numpy
    model_states.write_model_states(tmp_path / "restart_6hour_y2000.nc",
                                    torch.from_numpy(atmo),
                                    torch.from_numpy(logp))
    jwrite_model_states(tmp_path / "restart_6hour_y2001.nc", atmo + 1,
                        logp + 1)
    hours = np.array([0, 6, 8754, 8760, 8766])
    for reader in (model_states.ModelStateReader(tmp_path, 2000),
                   JModelStateReader(tmp_path, 2000)):
        out = reader.model_at(hours)
        rec = np.array([0, 1, 1459, 0, 1])
        add = np.array([0, 0, 0, 1, 1], dtype=np.float32)
        np.testing.assert_array_equal(
            out["atmo"], atmo[rec] + add[:, None, None, None, None])
        np.testing.assert_array_equal(out["logp"],
                                      logp[rec] + add[:, None, None])
        with pytest.raises(ValueError, match="cadence"):
            reader.model_at(np.array([7]))


def test_generate_model_state_files(tmp_path):
    """The forecast-state files of a truth source are the port's
    make_imperfect_forecasts of its samples, read back by both readers."""
    g = Geometry(trunc=10, nlon=32, nlat=16, nlev=8)
    gcm = GCM(g, dtype=torch.float64, nsteps_day=8, device="cpu",
              bd=synthetic_boundary_data(g, dtype=torch.float64))
    date0 = ModelDate(1990, 1, 1)
    truth, _, dates = generate_nature_run(gcm, date0, 3, spinup_days=0)
    # an hourly source whose hours 0, 6, 12 are the nature run's samples
    hourly = {k: torch.zeros((13,) + v.shape[1:], dtype=v.dtype)
              for k, v in truth.items()}
    for k, v in truth.items():
        hourly[k][::6] = v
    model_states.generate_model_state_files(
        gcm, str(tmp_path), 1990, 1, chunked.ArraySource(hourly))
    want = make_imperfect_forecasts(gcm, truth, dates)
    for reader in (model_states.ModelStateReader(tmp_path, 1990),
                   JModelStateReader(tmp_path, 1990)):
        got = reader.model_at(np.array([0, 6, 12]))
        for k in ("atmo", "logp"):
            np.testing.assert_array_equal(got[k], want[k].numpy(), k)
    assert float((want["atmo"][2] - truth["atmo"][2]).abs().max()) > 0


def _same_packs(a, b):
    for p, q in zip(a, b):
        for k in ("vals", "win_vals", "wout", "mean", "std"):
            assert torch.equal(getattr(p.res, k), getattr(q.res, k)), k
        for k in ("in_mean", "in_std", "out_mean", "out_std"):
            assert torch.equal(getattr(p.std, k), getattr(q.std, k)), k
        assert float(p.res.wout.abs().max()) > 0


def test_training_from_erasource_equals_arraysource(tmp_path):
    """train_hybrid_production (ML-only) and a hybrid class (with the
    forecast files' model block) from an ERASource and from an ArraySource
    over the same arrays: the packs equal bit for bit."""
    nz, year = 2, 1993
    write_era_year(_era_file(tmp_path, year), 80, 16, 32, nz, seed=7)
    rng = np.random.default_rng(8)
    model_states.write_model_states(
        tmp_path / f"restart_6hour_y{year}.nc",
        rng.normal(0, 1, (14, 4, nz, 16, 32)), rng.normal(0, 1, (14, 16, 32)))
    T = 13
    src = chunked.ERASource(
        era.ERA5Reader(tmp_path), year, T, sample_stride_hours=6,
        model_reader=model_states.ModelStateReader(tmp_path, year).model_at)
    idx = np.arange(T)
    mem = chunked.ArraySource(
        {k: v.numpy() for k, v in src.truth_at(idx).items()},
        {k: v.numpy() for k, v in src.model_at(idx).items()})
    g = Geometry(trunc=10, nlon=32, nlat=16, nlev=nz)
    gcm = types.SimpleNamespace(geom=g, dtype=torch.float64, nsteps_day=96)
    layout = RegionLayout(g, n_regions=32)
    hyper = ESNHyper(m=432, deg=3, noise_mag=0.1)
    kw = dict(n_discard=3, time_chunk=4, region_chunk=8, device="cpu")
    a, b = (chunked.train_hybrid_production(gcm, layout, s, hyper, 9,
                                            hybrid=False, **kw)
            for s in (src, mem))
    assert a.ml_only
    _same_packs(a.packs, b.packs)
    cls = layout.classes[1]
    a, b = (chunked.train_class_production(layout, cls, s, hyper, 9, nz,
                                           hybrid=True,
                                           dtype=torch.float64, **kw)
            for s in (src, mem))
    assert a.res.n_speedy > 0
    _same_packs([a], [b])

"""The twin set-up shared by the climate run and the skill experiment.

TRUTH is the GCM on the true boundary climatology (the reference's
fort.20-26 files, or the synthetic aquaplanet); the IMPERFECT model is
the same GCM with +3 K SSTs and land temperatures and a doubled bare-land
albedo.  The twin data are N + margin 6-h samples of a nature run of the
truth, and the imperfect model's 6-h forecasts launched from each truth
sample (the read_model_states protocol, speedy_res_interface.f90:634-720),
kept in one cache file that both programs read.

The cache's name carries a fingerprint, skill_twin_N{n}_v{2}_{source}.npz:
TWIN_DATA_VERSION changes whenever the GCM or the data protocol changes
the generated data, so a stale cache is never reused.  A cache that is
short or holds a non-finite value (an older tool's, or an interrupted
run's) is deleted and generated again.  With mmap the cache is extracted
once into one .npy file a key (an .npz cannot be memory-mapped), and the
arrays are read from those files instead of living in host memory.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.data.calendar import ModelDate

TWIN_DATA_VERSION = 2
TWIN_DATE0 = ModelDate(1990, 1, 1)


class ExperimentAbort(RuntimeError):
    """A stage met data that the experiment must not go on with (a
    non-finite nature run, forecast, readout or baseline)."""


def rss_pct() -> float:
    """This process's resident memory as a percentage of the host's
    MemTotal (/proc), or -1.0 where /proc does not say."""
    with open("/proc/meminfo") as f:
        total_kb = float(f.readline().split()[1])
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return float(line.split()[1]) / total_kb * 100.0
    return -1.0


def imperfect_boundary(bd):
    """The imperfect model's boundary data: +3 K on the SST and land
    temperature climatologies, the bare-land albedo doubled."""
    return dataclasses.replace(bd, sst12=bd.sst12 + 3.0,
                               stl12=bd.stl12 + 3.0, alb0=bd.alb0 * 2.0)


def twin_gcms(geom, dtype, boundary_path, device, nsteps_day: int = 96):
    """(truth GCM, imperfect GCM, source) on `device`.  boundary_path
    None: the synthetic aquaplanet (source "synth"); a directory: its
    fort.20-26 files (source "refbin"; a missing or unreadable file
    raises)."""
    from speedy_ml_tpu_torch.gcm import GCM
    from speedy_ml_tpu_torch.physics.boundaries import (
        load_boundary_data, synthetic_boundary_data)

    if boundary_path is None:
        bd, source = synthetic_boundary_data(geom, dtype=dtype,
                                             device=device), "synth"
    else:
        bd, source = load_boundary_data(geom, path=boundary_path,
                                        dtype=dtype,
                                        device=device), "refbin"
    mk = lambda b: GCM(geom, dtype=dtype, bd=b, nsteps_day=nsteps_day,
                       device=device)
    return mk(bd), mk(imperfect_boundary(bd)), source


class Twin(NamedTuple):
    """The two GCMs of the twin experiment, the region layout the hybrid
    is trained on, and the boundary data's source ("refbin", "synth")."""
    gcm_true: object
    gcm_imp: object
    layout: object
    source: str


def twin_setup(geom=None, *, dtype=torch.float32, boundary_path=None,
               n_regions: int = 1152, nsteps_day: int = 96,
               device=None) -> Twin:
    """The programs' set-up: T30L8 (the default Geometry), 1,152 regions
    with an overlap of 1, on `device` (default CUDA; raises without
    one)."""
    from speedy_ml_tpu_torch.core.geometry import Geometry
    from speedy_ml_tpu_torch.esn.domain import RegionLayout

    geom = geom or Geometry()
    gcm_true, gcm_imp, source = twin_gcms(geom, dtype, boundary_path,
                                          resolve_device(device),
                                          nsteps_day)
    return Twin(gcm_true, gcm_imp,
                RegionLayout(geom, n_regions=n_regions, overlap=1), source)


class TwinData(NamedTuple):
    """The twin samples, host numpy by key, their dates, and whether this
    call generated them (False: read from the cache)."""
    truth: dict
    model: dict
    dates: list
    generated: bool


def twin_dates(n: int, spinup_days: int = 30) -> list:
    """The dates of the n twin samples, built one from the last (the
    labels generate_nature_run gives them after its spin-up)."""
    dates = [TWIN_DATE0.advance_hours(spinup_days * 24)]
    for _ in range(n - 1):
        dates.append(dates[-1].advance_hours(6))
    return dates


def twin_cache_path(cache_dir, n: int, source: str) -> Path:
    return Path(cache_dir) / f"skill_twin_N{n}_v{TWIN_DATA_VERSION}_" \
                             f"{source}.npz"


def _split(arrays: dict) -> tuple:
    truth = {k[2:]: v for k, v in arrays.items() if k.startswith("t_")}
    model = {k[2:]: v for k, v in arrays.items() if k.startswith("m_")}
    return truth, model


def _valid(truth: dict, model: dict, n_total: int, probe: bool) -> bool:
    """Finite everywhere (probe: in the first and last sample, the form
    that reads a memory-mapped cache without pulling it into memory), and
    at least n_total samples."""
    def finite(v):
        if probe:
            return bool(np.isfinite(v[0]).all() and np.isfinite(v[-1]).all())
        return bool(np.isfinite(v).all())
    return (bool(truth) and bool(model)
            and all(finite(v) for d in (truth, model) for v in d.values())
            and truth["atmo"].shape[0] >= n_total)


def _mmap_dir(cache: Path) -> Path:
    return cache.with_name(cache.stem + "_mmap")


def _load_mmap(cache: Path) -> tuple:
    """The cache's arrays memory-mapped from one .npy file a key,
    extracted first into a .tmp directory renamed when complete."""
    mdir = _mmap_dir(cache)
    if not mdir.is_dir():
        tmp = mdir.with_name(mdir.name + ".tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        with np.load(cache) as z:
            for k in z.files:
                np.save(tmp / f"{k}.npy", z[k])
        os.rename(tmp, mdir)
    return _split({p.stem: np.load(p, mmap_mode="r")
                   for p in sorted(mdir.glob("*.npy"))})


def _load(cache: Path, n_total: int, mmap: bool, log) -> tuple | None:
    """The cache's (truth, model), or None after deleting a cache that
    fails validation."""
    if mmap:
        truth, model = _load_mmap(cache)
    else:
        with np.load(cache) as z:
            truth, model = _split({k: z[k] for k in z.files})
    if _valid(truth, model, n_total, probe=mmap):
        return truth, model
    log(f"cache {cache} failed validation; regenerating")
    cache.unlink()
    shutil.rmtree(_mmap_dir(cache), ignore_errors=True)
    return None


def _host(d: dict) -> dict:
    return {k: v.detach().to("cpu").numpy() for k, v in d.items()}


def twin_data(gcm_true, gcm_imp, n: int, cache_dir, *, source: str,
              spinup_days: int = 30, margin: int = 160,
              mmap: bool = False, log=print) -> TwinData:
    """The n + margin twin samples, host numpy by key (truth: atmo,
    logp, precip, sst, tisr; model: atmo, logp), from
    the cache in cache_dir or generated there: the nature run of gcm_true
    from TWIN_DATE0 after spinup_days, then gcm_imp's forecasts.
    Generated data that are not finite raise ExperimentAbort."""
    from speedy_ml_tpu_torch.hybrid.training import (
        generate_nature_run, make_imperfect_forecasts)

    n_total = n + margin
    cache = twin_cache_path(cache_dir, n, source)
    got = _load(cache, n_total, mmap, log) if cache.exists() else None
    if got is not None:
        log(f"twin data: cached ({cache})")
        return TwinData(*got, twin_dates(n_total, spinup_days), False)
    log(f"twin data: generating {n_total} samples -> {cache}")
    truth, _, dates = generate_nature_run(gcm_true, TWIN_DATE0, n_total,
                                          spinup_days=spinup_days)
    if not all(bool(torch.isfinite(v).all()) for v in truth.values()):
        raise ExperimentAbort("the nature run is not finite")
    model = make_imperfect_forecasts(gcm_imp, truth, dates)
    if not all(bool(torch.isfinite(v).all()) for v in model.values()):
        raise ExperimentAbort("the imperfect forecasts are not finite")
    truth, model = _host(truth), _host(model)
    cache.parent.mkdir(parents=True, exist_ok=True)
    tmp = cache.with_name(cache.stem + ".tmp.npz")
    np.savez(tmp, **{f"t_{k}": v for k, v in truth.items()},
             **{f"m_{k}": v for k, v in model.items()})
    os.replace(tmp, cache)
    if mmap:
        shutil.rmtree(_mmap_dir(cache), ignore_errors=True)
        truth, model = _load_mmap(cache)
    return TwinData(truth, model, dates, True)

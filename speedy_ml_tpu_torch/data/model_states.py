"""Precomputed SPEEDY forecast-state files (training's "imperfect model").

Reference: read_model_states (speedy_res_interface.f90:634-720) reads
yearly NetCDF files `restart_6hour_yYYYY.nc` of stored SPEEDY 6-hour
forecast states (generated once by running SPEEDY from ERA5 analyses)
and pairs them with the ERA5 truth series during hybrid training, so
training never has to re-run the GCM.

This module defines the framework's on-disk layout (the JAX package's,
so that either package reads the other's files) and a streaming reader
whose `model_at(hours)` plugs directly into
hybrid.chunked.ERASource(model_reader=...):

- one HDF5 file per model year, default name `restart_6hour_y{year}.nc`
  (NetCDF4 is HDF5, so the reference's files are readable too when their
  variable names match);
- datasets: "Temperature", "U-wind", "V-wind", "Specific_Humidity"
  each (T, K, lat, lon) and "logp" (T, lat, lon); root attribute
  `hours_per_record` (default 6);
- records live on the 365-day MODEL calendar: record k of year y is the
  forecast valid at model hour k*hours_per_record of that year (8760/hpr
  records per year; no Feb 29 — the generating run uses SPEEDY's 365-day
  calendar, mod_date vs mod_calendar split per SURVEY 2.2).

Units follow the training convention (get_training_data,
mod_reservoir.f90:363-494): T [K], u/v [m/s], q [g/kg], logp=log(ps/p0).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

STATE_VARS = {
    "t": "Temperature",
    "u": "U-wind",
    "v": "V-wind",
    "q": "Specific_Humidity",
    "logp": "logp",
}

HOURS_PER_YEAR = 8760   # model (365-day) calendar


def write_model_states(path: str, atmo: np.ndarray, logp: np.ndarray,
                       hours_per_record: int = 6):
    """Write one year-file of SPEEDY forecast states.

    atmo: (T, 4, K, lat, lon) ordered [T, u, v, q]; logp: (T, lat, lon);
    numpy arrays or tensors on any device.
    """
    import h5py
    host = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) \
        else np.asarray(a)
    atmo = host(atmo)
    logp = host(logp)
    assert atmo.ndim == 5 and atmo.shape[1] == 4, atmo.shape
    assert logp.shape == (atmo.shape[0],) + atmo.shape[3:], logp.shape
    with h5py.File(path, "w") as f:
        f.attrs["hours_per_record"] = hours_per_record
        for i, k in enumerate(("t", "u", "v", "q")):
            f.create_dataset(STATE_VARS[k], data=atmo[:, i])
        f.create_dataset(STATE_VARS["logp"], data=logp)


class ModelStateReader:
    """Streaming reader over yearly SPEEDY forecast-state files.

    `model_at(hours)` (hours on the 365-day model calendar, measured from
    Jan 1 of `year0`) returns dict(atmo (B, 4, K, lat, lon), logp
    (B, lat, lon)) — the SeriesSource model protocol.  Requested hours
    must align with the file's record cadence.  Chunks may span year
    boundaries; a 1-year LRU matches the reference's year loop."""

    def __init__(self, root: str, year0: int,
                 file_pattern: str = "restart_6hour_y{year}.nc"):
        self.root = Path(root)
        self.year0 = year0
        self.file_pattern = file_pattern
        self._cache_year: Optional[int] = None
        self._cache: Optional[dict] = None
        self._hpr: Optional[int] = None

    def year_path(self, year: int) -> Path:
        return self.root / self.file_pattern.format(year=year)

    def _year_data(self, year: int) -> dict:
        import h5py
        if self._cache_year != year:
            out = {}
            with h5py.File(self.year_path(year), "r") as f:
                self._hpr = int(f.attrs.get("hours_per_record", 6))
                for k, name in STATE_VARS.items():
                    ds = f[name] if name in f else f[name.replace("_", "-")]
                    out[k] = np.asarray(ds)
            self._cache = out
            self._cache_year = year
        return self._cache

    def model_at(self, hours: np.ndarray) -> dict:
        hours = np.asarray(hours)
        years = self.year0 + hours // HOURS_PER_YEAR
        parts = []
        for y in sorted(int(v) for v in np.unique(years)):
            sel = years == y
            off_h = hours[sel] - (y - self.year0) * HOURS_PER_YEAR
            data = self._year_data(y)
            if np.any(off_h % self._hpr):
                bad = off_h[off_h % self._hpr != 0][0]
                raise ValueError(
                    f"hour {bad} of year {y} not on the {self._hpr}-h "
                    "record cadence of the model-state files")
            rec = off_h // self._hpr
            parts.append({k: v[rec] for k, v in data.items()})
        raw = (parts[0] if len(parts) == 1 else
               {k: np.concatenate([p[k] for p in parts])
                for k in STATE_VARS})
        atmo = np.stack([raw["t"], raw["u"], raw["v"], raw["q"]], axis=1)
        return dict(atmo=atmo, logp=raw["logp"])


def generate_model_state_files(gcm, root: str, year0: int, n_years: int,
                               truth_source, timestep_hours: int = 6,
                               file_pattern: str = "restart_6hour_y{year}.nc"):
    """Produce year-files of imperfect SPEEDY forecasts from a truth
    SeriesSource (the offline step the reference ran once to create
    /scratch/.../SPEEDY_STATES; speedy_res_interface.f90:658-704).

    For each record time t the GCM is initialized from the truth at t -
    timestep_hours and advanced one window; the result is the "SPEEDY
    6-h forecast valid at t" used as the hybrid's local_model input.
    The forecasts run on the GCM's device (make_imperfect_forecasts)."""
    from speedy_ml_tpu_torch.data.calendar import ModelDate
    from speedy_ml_tpu_torch.hybrid.training import make_imperfect_forecasts

    rpy = HOURS_PER_YEAR // timestep_hours
    stride = timestep_hours  # truth source is hourly-indexed
    for yi in range(n_years):
        idx = np.arange(rpy) * stride + yi * HOURS_PER_YEAR
        idx = idx[idx < truth_source.n_samples * 1]
        truth = truth_source.truth_at(idx)
        dates = [ModelDate(year0 + yi, 1, 1).advance_hours(int(h))
                 for h in (idx - yi * HOURS_PER_YEAR)]
        model = make_imperfect_forecasts(gcm, truth, dates, timestep_hours)
        write_model_states(Path(root) / file_pattern.format(year=year0 + yi),
                           model["atmo"], model["logp"],
                           hours_per_record=timestep_hours)

"""ERA5 training-data reader.

Reference: speedy_res_interface.f90 read_era (439-632) +
mod_io.f90 read_era_data_parallel (1748-2007): year-by-year NetCDF files
`era_5_y<YYYY>_regridded_mpi_fixed_var_gcc.nc` holding hourly regridded
fields (Temperature, U-wind, V-wind, Specific_Humidity, logp, plus tisr /
sst / precip files), with leap-day splicing against SPEEDY's 365-day
year.

NetCDF4 files are HDF5; this module reads them with h5py using chunked
hyperslab access — the single-process equivalent of the reference's
NF90_MPIIO cooperative reads (each region's window is one hyperslab).
For unit handling it mirrors get_training_data (mod_reservoir.f90:363-
494): temperature [K], winds [m/s], specific humidity -> g/kg, logp =
log(ps/p0), precipitation log-transformed by the caller.

The port's copy of the JAX package's data/era.py (numpy, and h5py inside
the functions that read): the port imports nothing of that package, and
it imports where h5py is absent.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional

import numpy as np

# variable names in the regridded ERA5 files (read_era)
ERA_VARS = {
    "t": "Temperature",
    "u": "U-wind",
    "v": "V-wind",
    "q": "Specific-Humidity",
    "logp": "logp",
    "tisr": "tisr",
    "sst": "sst",
    "precip": "tp",
}


class ERA5Reader:
    """Streaming reader over yearly regridded ERA5 files."""

    def __init__(self, root: str, file_pattern: str =
                 "era_5_y{year}_regridded_mpi_fixed_var_gcc.nc"):
        self.root = Path(root)
        self.file_pattern = file_pattern

    def year_path(self, year: int) -> Path:
        return self.root / self.file_pattern.format(year=year)

    def available_years(self, start: int = 1979, end: int = 2030) -> list:
        return [y for y in range(start, end)
                if self.year_path(y).exists()]

    def read_year(self, year: int, variables: tuple = ("t", "u", "v", "q",
                                                       "logp"),
                  hour_slice: Optional[slice] = None) -> dict:
        """Read one year of hourly fields. Returns numpy arrays keyed by the
        short names; 3-D vars (T, K, lat, lon), 2-D (T, lat, lon)."""
        import h5py
        out = {}
        with h5py.File(self.year_path(year), "r") as f:
            for v in variables:
                name = ERA_VARS[v]
                ds = None
                for cand in (name, name.replace("-", "_"), v):
                    if cand in f:
                        ds = f[cand]
                        break
                if ds is None:
                    raise KeyError(f"variable {name} not in {self.year_path(year)}")
                arr = ds[hour_slice] if hour_slice is not None else ds[:]
                out[v] = np.asarray(arr)
        return out

    def year_hours(self, year: int) -> int:
        """Number of hour records in a year file (from the file itself)."""
        import h5py
        with h5py.File(self.year_path(year), "r") as f:
            for cand in ("Temperature", "Temperature".replace("-", "_"), "t"):
                if cand in f:
                    return f[cand].shape[0]
        raise KeyError(f"no temperature variable in {self.year_path(year)}")

    def valid_hour_index(self, year: int) -> "np.ndarray":
        """Hour indices of a year file with Feb 29 spliced OUT against the
        365-day model calendar (speedy_res_interface.f90:588-596): leap
        years drop hours [59*24, 60*24)."""
        from speedy_ml_tpu_torch.data.calendar import leap_year
        n = self.year_hours(year)
        if leap_year(year) and n >= 8784:
            feb29 = 59 * 24
            return np.concatenate([np.arange(feb29),
                                   np.arange(feb29 + 24, n)])
        return np.arange(min(n, 8760))

    def stream_samples(self, year0: int, n_hours: int, stride: int = 1,
                       variables: tuple = ("t", "u", "v", "q", "logp"),
                       chunk_hours: int = 24 * 30) -> Iterator[dict]:
        """Yield chunks of samples across year files (read_era's year
        loop).  Feb 29 is spliced out of leap-year files so every model
        year is exactly 8,760 hours (speedy_res_interface.f90:588-596);
        `stride` subsamples the spliced series."""
        year = year0
        remaining = n_hours
        offset = 0          # position within the SPLICED year
        while remaining > 0:
            path = self.year_path(year)
            if not path.exists():
                raise FileNotFoundError(path)
            valid = self.valid_hour_index(year)[::stride]
            if offset >= len(valid):
                year += 1
                offset = 0
                continue
            take = min(remaining, chunk_hours, len(valid) - offset)
            idx = valid[offset:offset + take]
            yield self.read_hours(year, idx, variables)
            remaining -= take
            offset += take

    def read_hours(self, year: int, idx: np.ndarray,
                   variables: tuple = ("t", "u", "v", "q", "logp")) -> dict:
        """Read specific hour records of a year file.

        Contiguous runs become single hyperslab reads (the Feb-29 splice
        splits a chunk into at most two); general increasing index lists
        use h5py fancy indexing."""
        runs = []
        start = prev = int(idx[0])
        contiguous = True
        for i in idx[1:]:
            i = int(i)
            if i == prev + 1:
                prev = i
                continue
            runs.append((start, prev + 1))
            start = prev = i
        runs.append((start, prev + 1))
        if len(runs) <= 4:
            parts = [self.read_year(year, variables, hour_slice=slice(lo, hi))
                     for lo, hi in runs]
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        data = self.read_year(year, variables,
                              hour_slice=np.asarray(idx, dtype=np.int64))
        return data


def daily_sst_climatology(reader: ERA5Reader, years: list) -> np.ndarray:
    """(365, lat, lon) daily-mean SST climatology over `years`, on the
    Feb-29-spliced model calendar (the full_sst_climo input of
    train_on_sst_anomalies, speedy_res_interface.f90:439-632)."""
    acc = None
    cnt = 0
    for y in years:
        valid = reader.valid_hour_index(y)
        sst = reader.read_year(y, variables=("sst",))["sst"][valid]
        days = sst[:365 * 24].reshape(365, 24, *sst.shape[1:]).mean(axis=1)
        acc = days if acc is None else acc + days
        cnt += 1
    if cnt == 0:
        raise ValueError("no ERA years available for the SST climatology")
    return acc / cnt


def era_to_truth(era: dict, q_to_gkg: bool = True,
                 sst_climo: Optional[np.ndarray] = None,
                 hour_of_year: Optional[np.ndarray] = None) -> dict:
    """Map raw ERA fields to the hybrid training `truth` dict convention.

    Unit fixes as in get_training_data: q kg/kg -> g/kg.  With sst_climo
    (365, lat, lon) and per-sample hour_of_year given, SSTs become
    anomalies against the daily climatology (train_on_sst_anomalies,
    speedy_res_interface.f90:439-632)."""
    truth = {}
    q = era["q"] * (1000.0 if q_to_gkg else 1.0)
    truth["atmo"] = np.stack([era["t"], era["u"], era["v"], q], axis=1)
    truth["logp"] = era["logp"]
    for k in ("precip", "sst", "tisr"):
        if k in era:
            truth[k] = era[k]
    if sst_climo is not None and "sst" in truth:
        if hour_of_year is None:
            raise ValueError("sst anomalies need per-sample hour_of_year")
        day = (np.asarray(hour_of_year) // 24) % sst_climo.shape[0]
        truth["sst"] = truth["sst"] - sst_climo[day]
    return truth

"""Time-mean output products on pressure levels (sigma -> p).

Reference: ppo_tminc.f90 (tminc: per-step sigma->pressure interpolation
and time-mean accumulation, MSL pressure at :60-70) + ppo_tmout.f90
(tmout: divide by the sample count and write per month; monthly cadence
driven from agcm_main).  These are the files the reference's climatology
verification (scripts/hybrid_climo.py) consumes.

One numpy-side accumulator fed from the prediction
stream (PredictionWriter diag dicts) — the hybrid never runs the GCM's
own post-processing, matching the reference hybrid runs where tminc is
effectively disabled (SURVEY 2.2 row 28) and verification happens on
the prediction output.  Pressure levels follow the reference's prlev
selection (nearest standard level per full sigma level,
ini_iniatm.f90:111-128).

A copy of the JAX package's timemean.py (host numpy, as there): the
port's run_prediction(time_mean_path=) hands the accumulator each cycle's
fields copied to the host.
"""

from __future__ import annotations

import numpy as np

from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.diagnostics import sigma_to_pressure

# standard post-processing levels [p/p0] (ini_iniatm.f90:118-119)
STANDARD_PLEV = np.array([0.925, 0.850, 0.775, 0.700, 0.600, 0.500, 0.400,
                          0.300, 0.250, 0.200, 0.150, 0.100, 0.050, 0.030])

# MSL reduction constants (tminc, ppo_tminc.f90:50-70)
GG, RD = 9.81, 287.0
GAM0 = 0.006 / GG          # 6 K/km standard lapse / g
RGAM = RD * GAM0


def output_pressure_levels(full_sigma: np.ndarray) -> np.ndarray:
    """Nearest standard pressure level per full sigma level, in hPa
    (prlev, ini_iniatm.f90:111-128): T30L8 -> [30,100,200,300,500,700,
    850,925]."""
    out = [STANDARD_PLEV[np.argmin(np.abs(STANDARD_PLEV - s))]
           for s in np.asarray(full_sigma)]
    return np.asarray(out) * 1000.0


def mean_sea_level_pressure(ps_hpa: np.ndarray, t_low: np.ndarray,
                            phis: np.ndarray) -> np.ndarray:
    """MSL pressure from surface pressure, lowest-level T and surface
    geopotential (tminc, ppo_tminc.f90:60-70): tsg = 0.5*(t0 +
    clip(t0, 255, 295)); pmsl = ps*(1 + gam0*phis/tsg)**(1/rgam)."""
    tsg = 0.5 * (t_low + np.clip(t_low, 255.0, 295.0))
    return ps_hpa * (1.0 + GAM0 * phis / tsg) ** (1.0 / RGAM)


class TimeMeanAccumulator:
    """Monthly sigma->p time means from prediction-cycle diagnostics.

    add() once per 6-h cycle with the cycle's PHYSICAL grids; when the
    model month changes, the finished month's means are appended to
    .months.  Matches tminc/tmout semantics: 3-D fields interpolate to
    pressure FIRST, then average; 2-D means include ps [hPa], MSL
    pressure, precip and SST."""

    VARS3 = ("t", "u", "v", "q")

    def __init__(self, geom, phis: np.ndarray | None = None):
        self.geom = geom
        self.full_sigma = np.asarray(geom.full_sigma)
        self.p_levels = output_pressure_levels(self.full_sigma)
        self.phis = (np.zeros((geom.nlat, geom.nlon)) if phis is None
                     else np.asarray(phis))
        self.months: list[dict] = []
        self._cur = None
        self._n = 0
        self._key = None

    def _zero(self):
        P, nlat, nlon = len(self.p_levels), self.geom.nlat, self.geom.nlon
        acc = {f"{v}_p": np.zeros((P, nlat, nlon)) for v in self.VARS3}
        for k in ("ps", "pmsl", "precip", "sst"):
            acc[k] = np.zeros((nlat, nlon))
        return acc

    def add(self, date: ModelDate, atmo: np.ndarray, logp: np.ndarray,
            precip: np.ndarray, sst: np.ndarray):
        """atmo (4, K, lat, lon) [T, u, v, q]; logp = log(ps/p0)."""
        key = (date.year, date.month)
        if self._key is not None and key != self._key:
            self._emit()
        if self._cur is None:
            self._cur = self._zero()
            self._n = 0
            self._key = key
        atmo = np.asarray(atmo)
        ps_norm = np.exp(np.asarray(logp))          # p/p0
        for i, v in enumerate(self.VARS3):
            self._cur[f"{v}_p"] += sigma_to_pressure(
                atmo[i], ps_norm, self.full_sigma, self.p_levels)
        ps_hpa = ps_norm * 1000.0
        self._cur["ps"] += ps_hpa
        self._cur["pmsl"] += mean_sea_level_pressure(ps_hpa, atmo[0, -1],
                                                     self.phis)
        self._cur["precip"] += np.asarray(precip)
        self._cur["sst"] += np.asarray(sst)
        self._n += 1

    def _emit(self):
        if self._cur is None or self._n == 0:
            return
        month = {k: v / self._n for k, v in self._cur.items()}
        month["year"], month["month"] = self._key
        month["n_samples"] = self._n
        month["p_levels_hpa"] = self.p_levels
        self.months.append(month)
        self._cur = None
        self._n = 0

    def finalize(self) -> list[dict]:
        """Flush the in-progress month and return all monthly means."""
        self._emit()
        return self.months

    def save(self, path: str):
        """One npz: stacked monthly means + (year, month, n) tables."""
        months = self.finalize()
        if not months:
            return
        out = {k: np.stack([m[k] for m in months])
               for k in months[0] if k not in ("year", "month", "n_samples",
                                               "p_levels_hpa")}
        out["year"] = np.asarray([m["year"] for m in months])
        out["month"] = np.asarray([m["month"] for m in months])
        out["n_samples"] = np.asarray([m["n_samples"] for m in months])
        out["p_levels_hpa"] = self.p_levels
        np.savez_compressed(path, **out)


def monthly_means_from_stream(pred: dict | str, start_date: ModelDate,
                              geom, phis: np.ndarray | None = None,
                              timestep_hours: int = 6):
    """Post-hoc monthly sigma->p means from a PredictionWriter stream
    (dict or .npz path with atmo/logp/precip/sst)."""
    if isinstance(pred, str):
        pred = dict(np.load(pred))
    acc = TimeMeanAccumulator(geom, phis=phis)
    date = start_date
    T = pred["atmo"].shape[0]
    for i in range(T):
        acc.add(date, pred["atmo"][i], pred["logp"][i],
                pred.get("precip", np.zeros_like(pred["logp"]))[i],
                pred.get("sst", np.zeros_like(pred["logp"]))[i])
        date = date.advance_hours(timestep_hours)
    return acc.finalize()

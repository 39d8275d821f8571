"""Post-hoc analysis parity with the reference's scripts/ suite.

Operates on PredictionWriter output (.npz with atmo/logp/precip/sst
series).  Covers the reference's verification workflow beyond
diagnostics.py's RMS/bias/ACC:

- ENSO: Nino-3.4 SST anomaly index + power spectrum
  (scripts/enso_hybrid.py);
- precipitation extremes: per-gridpoint high quantiles and global
  wet-day statistics (scripts/extreme_values.py, total_precip.py);
- total atmospheric mass conservation: area-weighted surface pressure
  timeseries (scripts/total_atmosphere_weight.py).

Pure numpy — analysis runs on host over files, like the reference.
"""

from __future__ import annotations

import numpy as np


def load_prediction(path: str) -> dict:
    """Load a PredictionWriter .npz into a dict of numpy arrays."""
    z = np.load(path)
    return {k: z[k] for k in z.files}


# ----------------------------------------------------------------------
# ENSO (scripts/enso_hybrid.py)
# ----------------------------------------------------------------------

def region_mean(field: np.ndarray, lat: np.ndarray, lon: np.ndarray,
                lat_range: tuple, lon_range: tuple) -> np.ndarray:
    """Area-weighted mean of (..., lat, lon) over a lat/lon box.

    lon_range in [0, 360); supports ranges crossing the dateline."""
    lat_m = (lat >= lat_range[0]) & (lat <= lat_range[1])
    lo, hi = lon_range
    lon_m = ((lon >= lo) & (lon <= hi) if lo <= hi
             else (lon >= lo) | (lon <= hi))
    w = np.cos(np.deg2rad(lat))[lat_m]
    sub = field[..., lat_m, :][..., lon_m]
    return (sub * w[:, None]).sum(axis=(-2, -1)) / (w.sum() * lon_m.sum())


def nino34_index(sst: np.ndarray, lat: np.ndarray, lon: np.ndarray,
                 samples_per_year: int) -> np.ndarray:
    """Nino-3.4 SST anomaly: box mean (5S-5N, 170W-120W) minus the
    repeating seasonal climatology (enso_hybrid.py's index)."""
    series = region_mean(sst, lat, lon, (-5.0, 5.0), (190.0, 240.0))
    T = len(series)
    ny = T // samples_per_year
    if ny >= 1:
        trimmed = series[:ny * samples_per_year].reshape(
            ny, samples_per_year)
        climo = np.tile(trimmed.mean(axis=0), ny + 1)[:T]
    else:
        climo = series.mean()
    return series - climo


def power_spectrum(series: np.ndarray, dt_days: float
                   ) -> tuple[np.ndarray, np.ndarray]:
    """One-sided periodogram; returns (period_days, power).

    The reference's ENSO analysis reads peak power in the 2-7 year
    band."""
    x = np.asarray(series, dtype=np.float64)
    x = x - x.mean()
    n = len(x)
    f = np.fft.rfftfreq(n, d=dt_days)
    p = np.abs(np.fft.rfft(x)) ** 2 / n
    with np.errstate(divide="ignore"):
        period = np.where(f > 0, 1.0 / np.maximum(f, 1e-30), np.inf)
    return period, p


# ----------------------------------------------------------------------
# precipitation (scripts/total_precip.py, extreme_values.py)
# ----------------------------------------------------------------------

def precip_extremes(precip: np.ndarray, quantiles=(0.95, 0.99, 0.999)
                    ) -> dict:
    """Per-gridpoint high quantiles + global wet statistics.

    precip: (T, lat, lon) rates.  Returns dict with 'q<NN>' maps, the
    all-point quantiles, and the wet fraction (rate > 1 mm/day equiv is
    left to the caller's units; here > 0)."""
    out = {}
    for q in quantiles:
        out[f"q{q}"] = np.quantile(precip, q, axis=0)
        out[f"q{q}_global"] = float(np.quantile(precip, q))
    out["mean_map"] = precip.mean(axis=0)
    out["wet_fraction"] = float((precip > 0).mean())
    out["max"] = float(precip.max())
    return out


def total_precip_timeseries(precip: np.ndarray, lat: np.ndarray
                            ) -> np.ndarray:
    """Area-weighted global-mean precip per sample (total_precip.py)."""
    w = np.cos(np.deg2rad(lat))
    return (precip * w[:, None]).sum(axis=(-2, -1)) / (
        w.sum() * precip.shape[-1])


# ----------------------------------------------------------------------
# mass conservation (scripts/total_atmosphere_weight.py)
# ----------------------------------------------------------------------

def total_atmosphere_mass(logp: np.ndarray, lat: np.ndarray,
                          p0: float = 1.0e5, grav: float = 9.81,
                          rearth: float = 6.371e6) -> np.ndarray:
    """Total atmospheric mass [kg] per sample from log-surface-pressure.

    M = (1/g) * integral ps dA over the sphere (the reference's
    total_atmosphere_weight.py check: drift indicates a conservation
    bug)."""
    w = np.cos(np.deg2rad(lat))
    ps = p0 * np.exp(logp)
    ps_bar = (ps * w[:, None]).sum(axis=(-2, -1)) / (w.sum()
                                                     * logp.shape[-1])
    area = 4.0 * np.pi * rearth ** 2
    return ps_bar * area / grav


def mass_drift(logp: np.ndarray, lat: np.ndarray) -> float:
    """Relative total-mass drift over the series (should be ~0)."""
    m = total_atmosphere_mass(logp, lat)
    return float((m[-1] - m[0]) / m[0])


# ----------------------------------------------------------------------
# wavelet ENSO spectrum (scripts/enso_hybrid.py get_wavelet_fft_power,
# :1319-1400 — pycwt's Torrence & Compo 1998 Morlet CWT, re-implemented
# in plain numpy since this image carries no pycwt)
# ----------------------------------------------------------------------

def morlet_cwt(series: np.ndarray, dt: float, dj: float = 1.0 / 12,
               s0: float | None = None, n_octaves: float = 7.0,
               omega0: float = 6.0):
    """Continuous wavelet transform with a Morlet(omega0) mother.

    FFT-based (Torrence & Compo 1998 eq. 4): W_n(s) = ifft(fft(x) *
    conj(Psi_hat(s * w))).  Returns (wave (J+1, N) complex, scales,
    periods).  Defaults mirror the reference call: s0 = 6*dt, twelve
    sub-octaves per octave, seven octaves."""
    x = np.asarray(series, dtype=np.float64)
    N = x.size
    s0 = 6.0 * dt if s0 is None else s0
    J = int(round(n_octaves / dj))
    scales = s0 * 2.0 ** (dj * np.arange(J + 1))
    # angular frequencies of the DFT
    w = 2.0 * np.pi * np.fft.fftfreq(N, d=dt)
    xh = np.fft.fft(x)
    # normalized Morlet in frequency space (TC98 table 1):
    # Psi_hat(s w) = pi^-1/4 H(w) exp(-(s w - omega0)^2 / 2)
    norm = (np.pi ** -0.25) * np.sqrt(2.0 * np.pi * scales / dt)
    arg = scales[:, None] * w[None, :] - omega0
    psi = norm[:, None] * np.exp(-0.5 * arg ** 2) * (w[None, :] > 0)
    wave = np.fft.ifft(xh[None, :] * np.conj(psi), axis=1)
    # Fourier-equivalent period for Morlet (TC98 eq. 6.8)
    fourier_factor = 4.0 * np.pi / (omega0 + np.sqrt(2.0 + omega0 ** 2))
    periods = scales * fourier_factor
    return wave, scales, periods


def wavelet_power_spectrum(series: np.ndarray, dt: float, **kw) -> dict:
    """Global wavelet power + 2-8 period-unit scale-averaged power of a
    detrended, std-normalized series (the quantities the reference plots
    for the Nino-3.4 index; enso_hybrid.py:1329-1392)."""
    x = np.asarray(series, dtype=np.float64)
    N = x.size
    t = np.arange(N) * dt
    p = np.polyfit(t, x, 1)
    xd = x - np.polyval(p, t)
    std = xd.std()
    if std == 0:
        std = 1.0
    wave, scales, periods = morlet_cwt(xd / std, dt, **kw)
    power = np.abs(wave) ** 2
    glbl = power.mean(axis=1)
    sel = (periods >= 2.0) & (periods < 8.0)
    # scale-averaged power (TC98 eq. 24, up to the Cdelta constant)
    dj = np.log2(scales[1] / scales[0])
    scale_avg = (power[sel] / scales[sel, None]).sum(axis=0) * dj * dt
    return dict(periods=periods, global_power=glbl,
                scale_avg_2_8=scale_avg, power=power, std=float(std))


# ----------------------------------------------------------------------
# stratosphere climatology (scripts/stratosphere_climo.py): zonal-mean
# stratospheric wind, SSW-style reversal counts, QBO section
# ----------------------------------------------------------------------

def zonal_mean(field: np.ndarray) -> np.ndarray:
    """(..., lat, lon) -> (..., lat) zonal mean."""
    return np.asarray(field).mean(axis=-1)


def ssw_reversal_fraction(u: np.ndarray, lat: np.ndarray,
                          months: np.ndarray, level: int = 0,
                          lat0: float = 60.0,
                          winter=(11, 12, 1, 2, 3)) -> float:
    """Fraction of extended-winter (NDJFM) samples with REVERSED
    (easterly) zonal-mean stratospheric wind at ~lat0 N — the
    sudden-stratospheric-warming proxy the reference counts
    (stratosphere_climo.py:117-145: ds_zmean NDJFM where U < 0).

    u: (T, K, lat, lon) zonal wind on sigma levels (level 0 = top);
    months: (T,) calendar month per sample."""
    j = int(np.argmin(np.abs(np.asarray(lat) - lat0)))
    uz = zonal_mean(u[:, level])[:, j]
    sel = np.isin(np.asarray(months), winter)
    if not sel.any():
        return 0.0
    return float((uz[sel] < 0.0).mean())


def qbo_section(u: np.ndarray, lat: np.ndarray,
                lat_band: float = 5.0) -> np.ndarray:
    """Equatorial zonal-mean zonal wind (T, K): the time-height section
    whose downward-propagating reversals are the QBO
    (stratosphere_climo.py qbo_plot:385-421)."""
    la = np.asarray(lat)
    m = np.abs(la) <= lat_band
    if not m.any():        # coarse grids: fall back to the two rows
        m = np.abs(la) <= np.sort(np.abs(la))[1]  # straddling the equator
    w = np.cos(np.deg2rad(la[m]))
    uz = zonal_mean(u)[..., m]                      # (T, K, lat_band)
    return (uz * w).sum(axis=-1) / w.sum()


# ----------------------------------------------------------------------
# sigma -> pressure climatology suite (scripts/hybrid_climo.py)
# ----------------------------------------------------------------------

SPEEDY_SIGMA = np.array([0.025, 0.095, 0.20, 0.34, 0.51, 0.685, 0.835,
                         0.95])
TARGET_PRESSURES = np.array([25.0, 95.0, 200.0, 350.0, 500.0, 680.0,
                             850.0, 950.0])   # hPa (hybrid_climo.py:74)


def sigma_to_pressure(var: np.ndarray, logp: np.ndarray,
                      sigma: np.ndarray = SPEEDY_SIGMA,
                      target: np.ndarray = TARGET_PRESSURES) -> np.ndarray:
    """Linear interpolation from sigma levels to fixed pressure levels
    (lin_interp, hybrid_climo.py:33-59), vectorized.

    var: (T, K, lat, lon); logp: (T, lat, lon) with ps = exp(logp)*1000
    hPa.  Values outside the column's pressure range clamp to the end
    levels (np.interp semantics, matching the reference)."""
    var = np.asarray(var)
    ps = np.exp(np.asarray(logp)) * 1000.0          # hPa
    p = sigma[None, :, None, None] * ps[:, None]    # (T, K, lat, lon)
    T_, K, ny, nx = var.shape
    out = np.empty((T_, len(target), ny, nx), dtype=var.dtype)
    # per target level: bracketing sigma interval via searchsorted over
    # the (sorted, increasing) per-column pressures
    for li, pt in enumerate(np.asarray(target)):
        idx = (p < pt).sum(axis=1)                  # first level with p>=pt
        hi = np.clip(idx, 1, K - 1)
        lo = hi - 1
        tix = np.arange(T_)[:, None, None]
        yix = np.arange(ny)[None, :, None]
        xix = np.arange(nx)[None, None, :]
        plo, phi = p[tix, lo, yix, xix], p[tix, hi, yix, xix]
        vlo, vhi = var[tix, lo, yix, xix], var[tix, hi, yix, xix]
        w = np.clip((pt - plo) / np.maximum(phi - plo, 1e-12), 0.0, 1.0)
        out[:, li] = vlo + w * (vhi - vlo)
    return out


def doy_climatology(series: np.ndarray, samples_per_year: int) -> np.ndarray:
    """Multi-year position-in-year climatology: mean over whole years of
    the (samples_per_year, ...) stack (the year-accumulation loop of
    hybrid_climo.py:95-125, 365-day model years)."""
    s = np.asarray(series)
    ny = s.shape[0] // samples_per_year
    if ny < 1:
        raise ValueError("series shorter than one year")
    return s[:ny * samples_per_year].reshape(
        (ny, samples_per_year) + s.shape[1:]).mean(axis=0)


def season_indices(samples_per_day: int = 4) -> dict:
    """Sample-index lists for DJF/MAM/JJA/SON on the 365-day calendar
    (the month index blocks of hybrid_climo.py:224-243)."""
    ndays = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]
    edges = np.cumsum([0] + ndays) * samples_per_day
    month = [np.arange(edges[m], edges[m + 1]) for m in range(12)]
    return dict(
        djf=np.concatenate([month[11], month[0], month[1]]),
        mam=np.concatenate(month[2:5]),
        jja=np.concatenate(month[5:8]),
        son=np.concatenate(month[8:11]),
        annual=np.arange(edges[12]))


def climo_bias_suite(pred: dict, truth: dict, samples_per_year: int,
                     lat: np.ndarray,
                     sigma: np.ndarray = SPEEDY_SIGMA) -> dict:
    """Seasonal sigma->pressure climatology biases of a model run vs a
    truth run (the hybrid_climo.py verification core).

    pred/truth: dicts with atmo (T, 4, K, lat, lon) [T,u,v,q] and logp
    (T, lat, lon).  Returns per-season zonal-mean bias sections for
    T/u/q (n_plev, nlat), surface-pressure bias maps (lat, lon), and the
    scalar RMS summary the reference prints (levels 2:-1, matching
    hybrid_climo.py:289-301)."""
    def prep(d):
        plev = {}
        for vi, name in enumerate(("t", "u", "q")):
            v = d["atmo"][:, (0, 1, 3)[vi]]
            plev[name] = sigma_to_pressure(v, d["logp"], sigma)
        plev["ps"] = np.exp(np.asarray(d["logp"])) * 1000.0
        return {k: doy_climatology(v, samples_per_year)
                for k, v in plev.items()}

    return climo_bias_from_climatology(prep(pred), prep(truth))


def annual_precip_totals(precip: np.ndarray, samples_per_year: int,
                         seconds_per_sample: float) -> np.ndarray:
    """Per-gridpoint annual precipitation totals [mm/year] over whole
    years (combined_precip_paper_fig.py histograms; precip in mm/s)."""
    p = np.asarray(precip)
    ny = p.shape[0] // samples_per_year
    tot = p[:ny * samples_per_year].reshape(
        (ny, samples_per_year) + p.shape[1:]).sum(axis=1)
    return tot * seconds_per_sample


# ----------------------------------------------------------------------
# streaming access to multi-year prediction parts
# ----------------------------------------------------------------------

def prediction_part_paths(stem: str) -> list:
    """Sorted .partN.npz chunk files of an unconsolidated prediction
    stream (PredictionWriter with consolidate=False)."""
    from pathlib import Path
    p = Path(stem)
    parts = sorted(p.parent.glob(p.stem + ".part*.npz"),
                   key=lambda q: int(q.suffixes[-2][5:]))
    if not parts and p.with_suffix(".npz").exists():
        parts = [p.with_suffix(".npz")]
    return parts


def iter_prediction_parts(stem: str, keys=None):
    """Yield dicts of numpy arrays per chunk file, in time order."""
    for p in prediction_part_paths(stem):
        z = np.load(p)
        yield {k: z[k] for k in (keys or z.files)}


def load_prediction_series(stem: str, key: str) -> np.ndarray:
    """Concatenate ONE stream key across parts (use only for 2-D
    fields; a 20-year atmo concat would exceed host RAM)."""
    return np.concatenate([d[key] for d in
                           iter_prediction_parts(stem, keys=[key])])


def streaming_doy_climatology(stem: str, samples_per_year: int,
                              sigma: np.ndarray = SPEEDY_SIGMA) -> dict:
    """Day-of-year sigma->pressure climatology of a prediction stream,
    accumulated part-by-part (the hybrid_climo.py accumulation without
    materializing the multi-year series).

    Returns dict with t/u/q (spy, n_plev, lat, lon), ps (spy, lat, lon)
    and n_years."""
    sums = None
    counts = None
    pos = 0
    for d in iter_prediction_parts(stem, keys=["atmo", "logp"]):
        atmo, logp = d["atmo"], d["logp"]
        B = atmo.shape[0]
        if sums is None:
            ny, nx = logp.shape[1:]
            P_ = len(TARGET_PRESSURES)
            sums = {k: np.zeros((samples_per_year, P_, ny, nx))
                    for k in ("t", "u", "q")}
            sums["ps"] = np.zeros((samples_per_year, ny, nx))
            counts = np.zeros(samples_per_year, dtype=np.int64)
        plev = {name: sigma_to_pressure(atmo[:, vi], logp, sigma)
                for vi, name in ((0, "t"), (1, "u"), (3, "q"))}
        ps = np.exp(logp) * 1000.0
        idx = (pos + np.arange(B)) % samples_per_year
        for k in ("t", "u", "q"):
            np.add.at(sums[k], idx, plev[k])
        np.add.at(sums["ps"], idx, ps)
        np.add.at(counts, idx, 1)
        pos += B
    if sums is None:
        raise FileNotFoundError(f"no prediction parts at {stem}")
    c = np.maximum(counts, 1)
    out = {k: v / (c[:, None, None, None] if v.ndim == 4
                   else c[:, None, None]) for k, v in sums.items()}
    out["n_years"] = pos / samples_per_year
    return out


def climo_bias_from_climatology(cp: dict, ct: dict) -> dict:
    """climo_bias_suite from precomputed doy climatologies (the
    streaming twin; cp/ct from streaming_doy_climatology or
    doy_climatology applied per variable)."""
    spy = cp["ps"].shape[0]
    seasons = season_indices(max(1, spy // 365))
    # toy "years" shorter than 365 d (tests): keep in-range samples only
    seasons = {k: v[v < spy] for k, v in seasons.items()}
    out = {"target_pressures": TARGET_PRESSURES, "seasons": {}}
    rms_all = {}
    for sname, idx in seasons.items():
        if len(idx) == 0:        # toy years: season entirely out of range
            continue
        sdict = {}
        for name in ("t", "u", "q"):
            bias = cp[name][idx].mean(axis=0) - ct[name][idx].mean(axis=0)
            sdict[f"{name}_bias_zonal"] = bias.mean(axis=-1)
        sdict["ps_bias_map"] = (cp["ps"][idx].mean(axis=0)
                                - ct["ps"][idx].mean(axis=0))
        out["seasons"][sname] = sdict
        if sname == "annual":
            for name in ("t", "u", "q"):
                a = cp[name][idx, 2:-1].mean(axis=(0, 3))
                b = ct[name][idx, 2:-1].mean(axis=(0, 3))
                rms_all[name] = float(np.sqrt(np.nanmean((a - b) ** 2)))
    out["rms"] = rms_all
    return out

"""Figure layer for the analysis products — the plotting half of the
reference's scripts/ suite (VERDICT r2 #32 remainder).

Each function renders one of the reference's verification figures from
the numpy products produced by `analysis.py` / `diagnostics.py` /
`timemean.py`, mirroring the reference's layouts:

- climatology bias maps       (scripts/hybrid_climo.py:61-220)
- Nino-3.4 index + spectrum   (scripts/enso_hybrid.py:423-520)
- wavelet power section       (scripts/enso_hybrid.py pycwt panels)
- SST anomaly snapshot maps   (scripts/sst_maps.py:128-210)
- zonal-mean cross-sections   (scripts/stratosphere_climo.py:117-180)
- QBO time-height section     (scripts/stratosphere_climo.py:385-421)
- Wout weight structure       (scripts/visualize_wout.py:12-27)
- precip extreme-quantile map (scripts/extreme_values.py)
- non-stationary trend series (scripts/non_stationary_trends.py:70-84)

All functions take/return matplotlib Figures and never call plt.show():
pass `path=` to save.  matplotlib is imported inside the functions, with
the Agg backend forced before pyplot loads, so figures render in batch
jobs and tests and importing this module (or the CLI) needs no
matplotlib.
"""

from __future__ import annotations

import numpy as np

from . import analysis


def _plt():
    """matplotlib.pyplot on the Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(fig, path):
    if path:
        fig.savefig(path, dpi=110, bbox_inches="tight")
        _plt().close(fig)
    return fig


def _latlon_panel(ax, field, lat, lon, cmap, vmin=None, vmax=None):
    pm = ax.pcolormesh(lon, lat, field, cmap=cmap, vmin=vmin, vmax=vmax,
                       shading="nearest")
    ax.set_xlabel("lon")
    ax.set_ylabel("lat")
    return pm


def bias_maps(truth_mean: np.ndarray, hybrid_mean: np.ndarray,
              speedy_mean: np.ndarray, lat, lon, *, var: str = "T [K]",
              path: str | None = None):
    """Three-panel climatology comparison: truth mean, hybrid bias,
    pure-model bias — hybrid_climo.py's per-variable map rows."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.2))
    amax = float(max(np.abs(hybrid_mean - truth_mean).max(),
                     np.abs(speedy_mean - truth_mean).max(), 1e-12))
    pm = _latlon_panel(axes[0], truth_mean, lat, lon, "viridis")
    fig.colorbar(pm, ax=axes[0])
    axes[0].set_title(f"truth {var}")
    for ax, f, name in ((axes[1], hybrid_mean, "hybrid"),
                        (axes[2], speedy_mean, "speedy")):
        pm = _latlon_panel(ax, f - truth_mean, lat, lon, "RdBu_r",
                           vmin=-amax, vmax=amax)
        fig.colorbar(pm, ax=ax)
        ax.set_title(f"{name} bias {var}")
    return _save(fig, path)


def nino34_figure(sst: np.ndarray, lat, lon, samples_per_year: int,
                  *, path: str | None = None):
    """Nino-3.4 anomaly timeseries + Fourier power spectrum
    (enso_hybrid.py's index/spectrum pair)."""
    plt = _plt()
    idx = analysis.nino34_index(sst, np.asarray(lat), np.asarray(lon),
                                samples_per_year)
    dt_days = 365.0 / samples_per_year
    per, power = analysis.power_spectrum(idx, dt_days)
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(11, 3.2))
    t = np.arange(len(idx)) * dt_days / 365.0
    ax0.plot(t, idx, lw=0.8)
    ax0.axhline(0.0, color="k", lw=0.5)
    ax0.set_xlabel("years")
    ax0.set_ylabel("Nino-3.4 anomaly [K]")
    sel = per > 0
    ax1.semilogx(per[sel] / 365.0, power[sel], lw=1.0)
    ax1.axvspan(2, 8, color="0.9")
    ax1.set_xlabel("period [years]")
    ax1.set_ylabel("power")
    ax1.set_title("2-8 y ENSO band shaded")
    return _save(fig, path)


def wavelet_figure(series: np.ndarray, dt_days: float,
                   *, path: str | None = None):
    """Morlet wavelet power section + 2-8 y scale-averaged series
    (enso_hybrid.py's pycwt panels, from analysis.morlet_cwt)."""
    plt = _plt()
    dt_y = dt_days / 365.0          # periods in years -> 2-8 y band
    wv = analysis.wavelet_power_spectrum(np.asarray(series), dt_y)
    power, periods = wv["power"], wv["periods"]
    t = np.arange(power.shape[1]) * dt_y
    fig, (ax0, ax1) = plt.subplots(
        2, 1, figsize=(9, 5), sharex=True,
        gridspec_kw={"height_ratios": [2, 1]})
    pm = ax0.pcolormesh(t, periods, power, cmap="magma", shading="nearest")
    ax0.set_yscale("log")
    ax0.invert_yaxis()
    ax0.set_ylabel("period [years]")
    fig.colorbar(pm, ax=ax0, label="wavelet power")
    ax1.plot(t, wv["scale_avg_2_8"], lw=0.9)
    ax1.set_xlabel("years")
    ax1.set_ylabel("2-8 y avg power")
    return _save(fig, path)


def sst_anomaly_map(sst: np.ndarray, sst_clim: np.ndarray, lat, lon,
                    *, title: str = "", path: str | None = None):
    """Single-date SST anomaly map (sst_maps.py's panels)."""
    plt = _plt()
    anom = np.asarray(sst) - np.asarray(sst_clim)
    amax = float(max(np.abs(anom).max(), 1e-12))
    fig, ax = plt.subplots(figsize=(6.5, 3.2))
    pm = _latlon_panel(ax, anom, lat, lon, "RdBu_r", vmin=-amax, vmax=amax)
    fig.colorbar(pm, ax=ax, label="SST anomaly [K]")
    if title:
        ax.set_title(title)
    return _save(fig, path)


def zonal_mean_section(field: np.ndarray, lat, sigma,
                       *, var: str = "U [m/s]", cmap: str = "RdBu_r",
                       path: str | None = None):
    """Zonal-mean latitude-height cross-section
    (stratosphere_climo.py's zonal_wind_mean_plot)."""
    plt = _plt()
    zm = analysis.zonal_mean(field)                 # (K, lat)
    amax = float(max(np.abs(zm).max(), 1e-12))
    fig, ax = plt.subplots(figsize=(6.5, 3.6))
    pm = ax.pcolormesh(lat, sigma, zm, cmap=cmap, vmin=-amax, vmax=amax,
                       shading="nearest")
    cs = ax.contour(lat, sigma, zm, colors="k", linewidths=0.4)
    ax.clabel(cs, fontsize=6)
    ax.invert_yaxis()                               # sigma: top of plot = top of atmo
    ax.set_xlabel("lat")
    ax.set_ylabel("sigma")
    ax.set_title(f"zonal-mean {var}")
    fig.colorbar(pm, ax=ax)
    return _save(fig, path)


def qbo_figure(u: np.ndarray, lat, sigma, dt_days: float,
               *, path: str | None = None):
    """Equatorial zonal-wind time-height section
    (stratosphere_climo.py's qbo_plot)."""
    plt = _plt()
    sec = analysis.qbo_section(np.asarray(u), np.asarray(lat))   # (T, K)
    t = np.arange(sec.shape[0]) * dt_days / 365.0
    amax = float(max(np.abs(sec).max(), 1e-12))
    fig, ax = plt.subplots(figsize=(9, 3.2))
    pm = ax.pcolormesh(t, sigma, sec.T, cmap="RdBu_r", vmin=-amax,
                       vmax=amax, shading="nearest")
    ax.invert_yaxis()
    ax.set_xlabel("years")
    ax.set_ylabel("sigma")
    ax.set_title("equatorial zonal-mean U (QBO section)")
    fig.colorbar(pm, ax=ax, label="U [m/s]")
    return _save(fig, path)


def wout_figure(wout: np.ndarray, *, region: int = 0, chunk: int = 128,
                path: str | None = None):
    """Readout-weight structure heatmap for one region
    (visualize_wout.py:12-27: the top-left chunk on a seismic scale)."""
    plt = _plt()
    w = np.asarray(wout)
    if w.ndim == 3:
        w = w[region]
    blk = w[:min(chunk, w.shape[0]), :min(chunk, w.shape[1])]
    v = float(max(np.abs(blk).max(), 1e-12))
    fig, ax = plt.subplots(figsize=(4.6, 4))
    pm = ax.pcolormesh(blk, cmap="seismic", vmin=-v, vmax=v)
    ax.set_xlabel("reservoir/speedy column")
    ax.set_ylabel("output row")
    ax.set_title(f"Wout region {region} ({w.shape[0]}x{w.shape[1]})")
    fig.colorbar(pm, ax=ax)
    return _save(fig, path)


def precip_extreme_map(precip: np.ndarray, lat, lon, *, q: float = 0.99,
                       path: str | None = None):
    """Map of the per-gridpoint precip quantile (extreme_values.py's
    spatial extreme panels)."""
    plt = _plt()
    ext = analysis.precip_extremes(np.asarray(precip), quantiles=(q,))
    field = ext[f"q{q}"]
    fig, ax = plt.subplots(figsize=(6.5, 3.2))
    pm = _latlon_panel(ax, field, lat, lon, "YlGnBu")
    fig.colorbar(pm, ax=ax, label=f"precip p{q * 100:g}")
    return _save(fig, path)


def trend_figure(series: np.ndarray, dt_days: float, *, smooth: int = 0,
                 label: str = "global-mean T [K]",
                 path: str | None = None):
    """Smoothed long-run global-mean timeseries
    (non_stationary_trends.py:70-84: uniform_filter1d over the mean)."""
    plt = _plt()
    s = np.asarray(series, dtype=np.float64)
    if smooth > 1:
        k = np.ones(smooth) / smooth
        s = np.convolve(s, k, mode="valid")
    t = np.arange(len(s)) * dt_days / 365.0
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.plot(t, s, lw=0.9)
    ax.set_xlabel("years")
    ax.set_ylabel(label)
    return _save(fig, path)


def skill_figure(lead_days: np.ndarray, hybrid_rmse: np.ndarray,
                 speedy_rmse: np.ndarray, *, var: str = "T [K]",
                 path: str | None = None):
    """RMSE-vs-lead skill curves, hybrid vs pure model
    (hybrid_climo.py's headline skill panel)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5.5, 3.4))
    ax.plot(lead_days, hybrid_rmse, "o-", ms=3, label="hybrid")
    ax.plot(lead_days, speedy_rmse, "s-", ms=3, label="speedy")
    ax.set_xlabel("lead [days]")
    ax.set_ylabel(f"RMSE {var}")
    ax.legend()
    ax.grid(alpha=0.3)
    return _save(fig, path)


def climo_bias_figure(suite_pred: dict, suite_base: dict, lat, *,
                      labels=("Hybrid", "SPEEDY"),
                      path: str | None = None):
    """The hybrid_climo.py verification panel set: DJF/JJA surface-
    pressure bias maps and annual zonal-mean T / u / q bias sections,
    model vs baseline side by side (hybrid_climo.py:330-612).

    suite_*: outputs of analysis.climo_bias_suite (same truth)."""
    plt = _plt()
    lat = np.asarray(lat)
    pl = np.asarray(suite_pred["target_pressures"])
    fig, axes = plt.subplots(4, 2, figsize=(11, 16))
    nlon = suite_pred["seasons"]["djf"]["ps_bias_map"].shape[1]
    lon = np.arange(nlon) * 360.0 / nlon
    for col, (suite, lab) in enumerate(zip((suite_pred, suite_base),
                                           labels)):
        ps_djf = suite["seasons"]["djf"]["ps_bias_map"]
        v = max(1e-9, np.abs(ps_djf).max())
        pm = _latlon_panel(axes[0, col], ps_djf, lat, lon, "RdBu_r",
                           vmin=-v, vmax=v)
        axes[0, col].set_title(f"{lab} surface pressure bias DJF [hPa]")
        fig.colorbar(pm, ax=axes[0, col], shrink=0.8)
        for row, name, unit in ((1, "t", "K"), (2, "u", "m/s"),
                                (3, "q", "g/kg")):
            sec = suite["seasons"]["annual"][f"{name}_bias_zonal"]
            v = max(1e-9, np.abs(sec).max())
            pm = axes[row, col].pcolormesh(lat, pl, sec, cmap="RdBu_r",
                                           vmin=-v, vmax=v,
                                           shading="nearest")
            axes[row, col].invert_yaxis()
            axes[row, col].set_ylabel("pressure [hPa]")
            axes[row, col].set_xlabel("lat")
            axes[row, col].set_title(
                f"{lab} zonal-mean {name.upper()} bias [{unit}]")
            fig.colorbar(pm, ax=axes[row, col], shrink=0.8)
    fig.tight_layout()
    return _save(fig, path)


def combined_precip_figure(precip_truth: np.ndarray,
                           precip_hybrid: np.ndarray,
                           precip_speedy: np.ndarray,
                           lat, lon, samples_per_year: int,
                           seconds_per_sample: float,
                           path: str | None = None):
    """The combined precipitation paper figure
    (combined_precip_paper_fig.py): mean daily precipitation maps for
    truth / hybrid / SPEEDY, annual-total histograms, and the
    high-percentile extreme curve.

    precip_*: (T, lat, lon) precipitation rate in mm/s."""
    plt = _plt()
    day = 86400.0
    fig = plt.figure(figsize=(14, 10))
    names = ("Truth", "Hybrid", "SPEEDY")
    fields = (precip_truth, precip_hybrid, precip_speedy)
    vmax = max(float(np.asarray(f).mean(axis=0).max()) for f in fields) * day
    for i, (nm, f) in enumerate(zip(names, fields)):
        ax = fig.add_subplot(2, 3, i + 1)
        pm = _latlon_panel(ax, np.asarray(f).mean(axis=0) * day, lat, lon,
                           "YlGnBu", vmin=0.0, vmax=vmax)
        ax.set_title(f"{nm}\nmean daily precipitation [mm/day]")
        fig.colorbar(pm, ax=ax, shrink=0.7)

    # annual-total histogram (histo_precip)
    ax = fig.add_subplot(2, 3, 4)
    for nm, f, color in zip(names, fields, ("k", "C0", "C3")):
        tot = analysis.annual_precip_totals(f, samples_per_year,
                                            seconds_per_sample)
        ax.hist(tot.ravel(), bins=40, density=True, histtype="step",
                color=color, label=nm)
    ax.set_xlabel("annual precipitation [mm]")
    ax.set_ylabel("density")
    ax.legend()
    ax.set_title("Annual totals")

    # extreme percentiles (extreme_value_plot / log_binning)
    ax = fig.add_subplot(2, 3, 5)
    qs = np.array([90.0, 95.0, 99.0, 99.5, 99.9, 99.99])
    for nm, f, color in zip(names, fields, ("k", "C0", "C3")):
        vals = np.percentile(np.asarray(f).ravel() * day, qs)
        ax.plot(qs, vals, marker="o", color=color, label=nm)
    ax.set_xlabel("percentile")
    ax.set_ylabel("precip rate [mm/day]")
    ax.legend()
    ax.set_title("Extreme precipitation percentiles")

    # zonal-mean precip
    ax = fig.add_subplot(2, 3, 6)
    for nm, f, color in zip(names, fields, ("k", "C0", "C3")):
        ax.plot(np.asarray(lat), np.asarray(f).mean(axis=(0, 2)) * day,
                color=color, label=nm)
    ax.set_xlabel("lat")
    ax.set_ylabel("mm/day")
    ax.legend()
    ax.set_title("Zonal-mean precipitation")
    fig.tight_layout()
    return _save(fig, path)

"""The multi-year coupled hybrid climate run, stage by stage.

The reference's product is predictionlength = 8760 * 20 h of 6-h hybrid
cycles with the slab-ocean reservoir giving a prognostic SST
(mod_reservoir.f90:32-37, timestep_slab = 168), verified by ENSO spectra
and climatology maps (scripts/enso_hybrid.py, hybrid_climo.py).  Stages,
each kept on disk (run_climate skips a stage whose output exists):

  A. the twin data (twin.py): N + 160 6-h truth samples and the imperfect
     model's 6-h forecasts;
  B. the hybrid trained at the production layout (1,152 regions, the slab
     ocean on) by the region-chunked streaming trainer;
  C. YEARS years of free-running coupled hybrid cycles on the strict
     365-day calendar, SST bias 0, the prediction stream left as
     .partN.npz files and the monthly sigma->p time means;
  D. the SPEEDY baseline: the same free run of the imperfect GCM alone,
     streamed into a day-of-year climatology and daily 2-D series;
  E. verification: the result dict (wall clock, the gate, T and mass
     drift, Nino-3.4) and the figures.

ClimateConfig's fields are the program's settings, with their defaults.
Every function writes only under the paths its caller gives.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.esn.ocean import OCEAN_HYPER
from speedy_ml_tpu_torch.experiments.twin import (ExperimentAbort, rss_pct,
                                                  twin_data, twin_setup)

SPY = 1460          # 6-h samples in a 365-day year
SYNC = 24           # the synchronization window before a prediction
SECONDS_PER_SAMPLE = 21600.0
NINO34_LAT = 5.0    # the Nino-3.4 box's half-width in latitude
FIGURES = ("fig_climo_bias.png", "fig_nino34.png", "fig_wavelet.png",
           "fig_precip.png")


@dataclasses.dataclass
class ClimateConfig:
    m: int = 3000             # atmosphere reservoir size
    n: int = 8760             # training samples (6 years of 6-h samples)
    years: int = 20           # years of the free run (stages C and D)
    # the slab ocean's ridge: the reference's 1e-4 squares to 1e-8, below
    # the float32 Gram's noise at the shorter slab series
    ocean_beta: float = 0.01
    # the atmosphere's ridge: 0.05 holds a 20-year run at m = 3000; at
    # m = 6000 the interior class's readout needs more for a stable loop
    atmo_beta: float = 0.05
    rchunk: int = 96          # the training's region chunk
    ocean_rchunk: int = 32    # the ocean training's region chunk
    dispatch: int = 32        # stage C's cycles a dispatch
    mmap: bool = False        # read the twin cache memory-mapped
    base: Optional[str] = None   # a SPEEDY baseline (stage D) to reuse


def _write_json(path, obj, **kw):
    Path(path).write_text(json.dumps(obj, allow_nan=False, **kw))


def _wout_checked(packs, what: str, log):
    """Log each class's |Wout| max; raise ExperimentAbort on a non-finite
    readout."""
    for p in packs:
        w = p.res.wout.float()
        wmax, finite = float(w.abs().max()), bool(torch.isfinite(w).all())
        log(f"  {what} {p.cls.name}: |wout|max {wmax:.3e} finite={finite}")
        if not finite:
            raise ExperimentAbort(f"non-finite {what} Wout")


def stage_training(cfg: ClimateConfig, twin, truth: dict, model: dict,
                   ckpt: Path, meta_path: Path, log=print):
    """Stage B: the hybrid with the slab ocean, loaded from ckpt when it
    is there, else trained (the atmosphere's checkpoint at ckpt + ".atmo"
    while the ocean trains), saved to ckpt with train_meta.json beside it.
    The ".atmo" checkpoint is deleted once ckpt holds the whole hybrid.
    Returns (hybrid, whether it was trained)."""
    from speedy_ml_tpu_torch.data.checkpoint import load_hybrid, save_hybrid
    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
    from speedy_ml_tpu_torch.hybrid.chunked import (ArraySource,
                                                    train_hybrid_production)

    gcm = twin.gcm_imp
    atmo_ckpt = Path(str(ckpt) + ".atmo")
    trained = not ckpt.exists()
    if not trained:
        log(f"stage B: loading the trained hybrid ({ckpt})")
        hyb = load_hybrid(gcm, twin.layout, str(ckpt), dtype=gcm.dtype,
                          device=gcm.device)
    else:
        log(f"stage B: training m={cfg.m} on N={cfg.n} (+slab ocean)")
        src = ArraySource({k: v[:cfg.n] for k, v in truth.items()},
                          {k: v[:cfg.n] for k, v in model.items()})
        hyper = ESNHyper(m=cfg.m, deg=6, noise_mag=0.2,
                         beta_res=cfg.atmo_beta)
        t0 = time.time()
        hyb = train_hybrid_production(
            gcm, twin.layout, src, hyper, 0, hybrid=True, ocean=True,
            ocean_hyper=dataclasses.replace(OCEAN_HYPER,
                                            beta_res=cfg.ocean_beta),
            hybrid_ocean=False, region_chunk=cfg.rchunk, time_chunk=256,
            dtype=gcm.dtype, topology="shift", atmo_ckpt=str(atmo_ckpt),
            ocean_region_chunk=cfg.ocean_rchunk, device=gcm.device)
        train_wall = time.time() - t0
        log(f"  trained in {train_wall:.0f}s; rss {rss_pct():.0f}%")
        _wout_checked(hyb.packs, "atmo", log)
        _wout_checked(hyb.ocean_packs, "ocean", log)
        save_hybrid(hyb, str(ckpt))
        _write_json(meta_path, dict(m=cfg.m, n_train=cfg.n,
                                    beta_res=cfg.atmo_beta,
                                    ocean_beta=cfg.ocean_beta,
                                    train_wall_s=train_wall))
    # the whole hybrid is in ckpt: the atmosphere's own checkpoint goes
    shutil.rmtree(atmo_ckpt, ignore_errors=True)
    return hyb, trained


def cal365_start(date: ModelDate) -> ModelDate:
    """The prediction's start on the strict 365-day model calendar."""
    return ModelDate(date.year, date.month, date.day, date.hour,
                     cal365=True)


def stage_free_run(hyb, truth: dict, model: dict, dates: list, n_train: int,
                   n_cycles: int, out: Path, dispatch: int,
                   log=print) -> dict:
    """Stage C: n_cycles coupled hybrid cycles from the sync window that
    ends at ic = n_train + SYNC + 8, on the 365-day calendar: the stream
    left as out/hybrid_climate.partN.npz, the monthly means in
    out/monthly_means.npz.  When every cycle ran safely over whole years,
    the end date must be the start's month and day that many years on.
    Writes and returns out/stage_c_done.json's dict."""
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction

    log(f"stage C: {n_cycles} coupled hybrid cycles ({dispatch}/dispatch, "
        f"cal365)")
    ic = n_train + SYNC + 8
    sync = {k: np.array(v[ic - SYNC:ic]) for k, v in truth.items()}
    model_next = dict(atmo=np.array(model["atmo"][ic]),
                      logp=np.array(model["logp"][ic]))
    hstate = hyb.start_prediction(sync, model_next,
                                  np.array(truth["sst"][ic - 1]))
    t0 = time.time()
    hstate, run_dates = run_prediction(
        hyb, hstate, cal365_start(dates[ic]), n_cycles,
        output_path=str(out / "hybrid_climate.npz"), stop_if_unsafe=True,
        time_mean_path=str(out / "monthly_means.npz"), consolidate=False,
        progress_every=SPY, cycles_per_dispatch=dispatch)
    wall = time.time() - t0
    n_done = len(run_dates)
    safe = bool(hstate.safe)
    log(f"  ran {n_done}/{n_cycles} cycles in {wall:.0f}s "
        f"({n_done / SPY / (wall / 86400.0):.0f} sim-years/day); "
        f"safe={safe}; rss {rss_pct():.0f}%")
    end = run_dates[-1].advance_hours(6)
    if safe and n_done == n_cycles and n_cycles % SPY == 0:
        start = run_dates[0]
        if (end.year - start.year, end.month, end.day) != \
                (n_cycles // SPY, start.month, start.day):
            raise RuntimeError(f"calendar drift: {start} + {n_cycles} "
                               f"cycles -> {end}")
    done = dict(cycles=n_done, wall_s=round(wall, 1), safe=safe,
                start=str(run_dates[0]), end=str(end), dispatch=dispatch,
                sim_years=round(n_done / SPY, 3))
    _write_json(out / "stage_c_done.json", done)
    return done


def speedy_baseline(gcm, date: ModelDate, days: int, path,
                    samples_per_year: int = SPY, log=print):
    """Stage D: `days` days of the imperfect GCM alone from rest at
    `date`: init_state, stepone, then a day of four 6-h windows with the
    flux sums zeroed at its start, each window's sigma->p T, u, q and
    surface pressure summed into day-of-year bins (float32, as the
    program keeps them), the day's SST, mean precipitation and last logp
    kept, and the slab coupler's exchange at the next day's date.  Each
    window runs eagerly on the GCM's kernels.  Writes the climatologies
    and daily series to `path` (savez_compressed); returns the final
    state.  A non-finite logp raises ExperimentAbort."""
    from speedy_ml_tpu_torch.analysis import sigma_to_pressure
    from speedy_ml_tpu_torch.gcm import FluxAccumulator

    g, sht = gcm.geom, gcm.sht
    state, _ = gcm.init_state(date)
    forcing = gcm.forcing_for(state.sfc, date.tyear)
    state = gcm.stepone(state, forcing)
    steps = gcm.nsteps_day * 6 // 24
    sums = {k: np.zeros((samples_per_year, g.nlev, g.nlat, g.nlon),
                        np.float32) for k in ("t", "u", "q")}
    sums["ps"] = np.zeros((samples_per_year, g.nlat, g.nlon), np.float32)
    counts = np.zeros(samples_per_year, np.int64)
    sst_series, precip_series, logp_series = [], [], []
    pos = 0
    t0 = time.time()
    for day in range(days):
        forcing = gcm.forcing_for(state.sfc, date.tyear)
        state = dataclasses.replace(state, fluxes=FluxAccumulator.zeros(
            g.nlat, g.nlon, gcm.dtype, gcm.device))
        windows = []
        for _ in range(4):
            pre = state.fluxes.precip
            state = gcm.run_window(state, forcing, steps)
            sp = state.spectral
            u, v = sht.uv_grid(sp.vor[0], sp.div[0])
            windows.append(torch.cat([
                torch.stack([sht.spec_to_grid(sp.t[0]), u, v,
                             sht.spec_to_grid(sp.tr[0, 0])]).reshape(-1),
                sht.spec_to_grid(sp.ps[0]).reshape(-1),
                ((state.fluxes.precip - pre) / SECONDS_PER_SAMPLE)
                .reshape(-1)]))
        host = torch.stack(windows).to("cpu").numpy()
        n_a = 4 * g.nlev * g.nlat * g.nlon
        n_p = g.nlat * g.nlon
        a = host[:, :n_a].reshape(4, 4, g.nlev, g.nlat, g.nlon)
        lp = host[:, n_a:n_a + n_p].reshape(4, g.nlat, g.nlon)
        pr = host[:, n_a + n_p:].reshape(4, g.nlat, g.nlon)
        if not np.isfinite(lp).all():
            raise ExperimentAbort(f"baseline diverged at day {day}")
        idx = (pos + np.arange(4)) % samples_per_year
        for vi, k in ((0, "t"), (1, "u"), (3, "q")):
            np.add.at(sums[k], idx, sigma_to_pressure(a[:, vi], lp))
        np.add.at(sums["ps"], idx, np.exp(lp) * 1000.0)
        np.add.at(counts, idx, 1)
        sst_series.append(state.sfc.sst_am.to("cpu").numpy())
        precip_series.append(pr.mean(axis=0))
        logp_series.append(lp[-1])
        pos += 4
        # the day's coupler exchange at the new date
        date = date.advance_day()
        sfc, _ = gcm.couple(state.sfc, state.fluxes, date.month - 1,
                            date.tmonth)
        state = dataclasses.replace(state, sfc=sfc)
        if (day + 1) % 365 == 0:
            log(f"  baseline year {(day + 1) // 365} "
                f"({time.time() - t0:.0f}s)")
    c = np.maximum(counts, 1)
    np.savez_compressed(
        path,
        **{f"climo_{k}": (v / (c[:, None, None, None] if v.ndim == 4
                               else c[:, None, None])).astype(np.float32)
           for k, v in sums.items()},
        sst_daily=np.stack(sst_series).astype(np.float32),
        precip_daily=np.stack(precip_series).astype(np.float32),
        logp_daily=np.stack(logp_series).astype(np.float32))
    log(f"  baseline done in {time.time() - t0:.0f}s")
    return state


def climate_products(stream: str, baseline_path, truth: dict, geom,
                     n_train: int, samples_per_year: int = SPY) -> dict:
    """What stage E reads and derives, host numpy: the stream's SST,
    logp and precipitation series, the hybrid's, the truth's (its first
    whole years of the n_train training samples) and the baseline's
    day-of-year climatologies and their bias suites, the Nino-3.4 index.
    stream: the prediction stream's path (its .partN.npz files).  On a
    grid with no latitude in the Nino-3.4 box (5S-5N; T10's 16 Gaussian
    latitudes start at 5.45 degrees) the index is None."""
    from speedy_ml_tpu_torch.analysis import (climo_bias_from_climatology,
                                              doy_climatology,
                                              load_prediction_series,
                                              nino34_index,
                                              sigma_to_pressure,
                                              streaming_doy_climatology)

    spy = samples_per_year
    lat = np.rad2deg(geom.lat_radians)
    lon = np.arange(geom.nlon) * 360.0 / geom.nlon
    sst = load_prediction_series(stream, "sst")
    clim_h = streaming_doy_climatology(stream, spy)
    n_tr = min(n_train, (n_train // spy) * spy)
    tr = {k: v[:n_tr] for k, v in truth.items()}
    clim_t = {}
    for vi, k in ((0, "t"), (1, "u"), (3, "q")):
        clim_t[k] = doy_climatology(
            sigma_to_pressure(tr["atmo"][:, vi], tr["logp"]), spy)
    clim_t["ps"] = doy_climatology(np.exp(tr["logp"]) * 1000.0, spy)
    with np.load(baseline_path) as zb:
        clim_s = {k: zb[f"climo_{k}"] for k in ("t", "u", "q", "ps")}
        precip_speedy = zb["precip_daily"]
    return dict(
        stream=stream, geom=geom, lat=lat, lon=lon, spy=spy, sst=sst,
        logp=load_prediction_series(stream, "logp"),
        precip=load_prediction_series(stream, "precip"),
        precip_truth=tr["precip"], precip_speedy=precip_speedy,
        suite_h=climo_bias_from_climatology(clim_h, clim_t),
        suite_s=climo_bias_from_climatology(clim_s, clim_t),
        nino=(nino34_index(sst, lat, lon, spy)
              if (np.abs(lat) <= NINO34_LAT).any() else None))


def climate_figures(products: dict, out_dir, log=print) -> list:
    """The four figures of the run into out_dir (needs matplotlib): the
    climatology biases, the Nino-3.4 index and spectrum, the wavelet
    (best effort: a failure is logged and the figure left out) and the
    combined precipitation; the Nino-3.4 figures only where the grid has
    the index.  Returns the names of the files drawn."""
    from speedy_ml_tpu_torch import plots

    p, out = products, Path(out_dir)
    n_cycles = p["sst"].shape[0]
    plots.climo_bias_figure(p["suite_h"], p["suite_s"], p["lat"],
                            path=str(out / FIGURES[0]))
    drawn = [FIGURES[0]]
    if p["nino"] is not None:
        plots.nino34_figure(p["sst"], p["lat"], p["lon"], p["spy"],
                            path=str(out / FIGURES[1]))
        drawn.append(FIGURES[1])
        try:
            plots.wavelet_figure(p["nino"][::28], 7.0,
                                 path=str(out / FIGURES[2]))
            drawn.append(FIGURES[2])
        except Exception as e:     # the wavelet is best effort
            log(f"  wavelet figure skipped: {e!r}")
    plots.combined_precip_figure(
        p["precip_truth"], p["precip"],
        np.repeat(p["precip_speedy"], 4, axis=0)[:n_cycles], p["lat"],
        p["lon"], p["spy"], SECONDS_PER_SAMPLE, path=str(out / FIGURES[3]))
    drawn.append(FIGURES[3])
    return drawn


def verify_climate(products: dict, stage_c_path, result_path, *, m: int,
                   n_train: int, years: int, ocean_beta: float,
                   boundary: str, figures=()) -> dict:
    """Stage E's result: wall clock and simulated years a day from stage
    C, the gate, the global-mean lowest-level T of the first and last
    year and its drift a decade, the relative mass drift, the Nino-3.4
    standard deviation and its 2-7-year spectral peak, the climatology
    RMS of the hybrid and the baseline, the peak host memory share (the
    Nino-3.4 numbers None where the grid has no index).
    figures: the names of the figures drawn.  Written to result_path
    (JSON, no NaN allowed) and returned."""
    from speedy_ml_tpu_torch.analysis import (iter_prediction_parts,
                                              mass_drift, power_spectrum,
                                              total_atmosphere_mass)

    p = products
    spy, lat, nlon = p["spy"], p["lat"], p["geom"].nlon
    n_cycles = p["sst"].shape[0]
    sim_years = n_cycles / spy
    nino, nino_std, peak_period_years = p["nino"], None, None
    if nino is not None:
        nino_std = round(float(nino.std()), 4)
        per, pw = power_spectrum(nino, 0.25)
        band = (per > 2 * 365) & (per < 7 * 365)
        peak_period_years = float(per[band][np.argmax(pw[band])] / 365.0) \
            if band.any() else None
    # drift: the global-mean lowest-level T, first year against last
    w = np.cos(np.deg2rad(lat))[:, None]
    gm = lambda f: float((f * w).sum() / (w.sum() * nlon))
    acc_first, n_first, acc_last, n_last = 0.0, 0, 0.0, 0
    pos = 0
    for d in iter_prediction_parts(p["stream"], keys=["atmo"]):
        B = d["atmo"].shape[0]
        for b in range(B):
            if pos + b < spy:
                acc_first += gm(d["atmo"][b, 0, -1])
                n_first += 1
            if pos + b >= n_cycles - spy:
                acc_last += gm(d["atmo"][b, 0, -1])
                n_last += 1
        pos += B
    t_first = acc_first / max(n_first, 1)
    t_last = acc_last / max(n_last, 1)
    t_drift_per_decade = (t_last - t_first) / max(sim_years - 1, 1) * 10.0
    md = mass_drift(p["logp"][::4], lat)
    mass = total_atmosphere_mass(p["logp"][::40], lat)
    stage_c = json.loads(Path(stage_c_path).read_text())
    suite_h, suite_s = p["suite_h"], p["suite_s"]
    result = dict(
        m=m, n_train=n_train, years_requested=years,
        sim_years=round(sim_years, 2),
        cycles=n_cycles,
        wall_s=stage_c["wall_s"],
        sim_years_per_day=round(sim_years / (stage_c["wall_s"] / 86400.0),
                                1),
        safe_never_tripped=bool(stage_c["safe"]),
        slab_ocean=True, ocean_beta=ocean_beta, sst_bias=0.0,
        t_sfc_global_first_year=round(t_first, 3),
        t_sfc_global_last_year=round(t_last, 3),
        t_drift_K_per_decade=round(t_drift_per_decade, 4),
        mass_drift_rel=round(md, 6),
        mass_mean_kg=float(mass.mean()),
        nino34_std=nino_std,
        nino34_peak_period_years=peak_period_years,
        climo_rms_hybrid=suite_h["rms"], climo_rms_speedy=suite_s["rms"],
        hybrid_beats_speedy_climo={
            k: bool(suite_h["rms"][k] < suite_s["rms"][k])
            for k in suite_h["rms"]},
        figures=list(figures),
        calendar="365-day" if "end" in stage_c else "leap-aware (r4 run)",
        prediction_start=stage_c.get("start"),
        prediction_end=stage_c.get("end"),
        peak_rss_pct=round(rss_pct(), 1),
        boundary=boundary)
    _write_json(result_path, result, indent=1)
    return result


def run_climate(cfg: ClimateConfig, out_dir, result_path, *, twin=None,
                cache_dir=None, cycles: Optional[int] = None,
                baseline_days: Optional[int] = None,
                samples_per_year: int = SPY, spinup_days: int = 30,
                margin: int = 160, figures: bool = True, device=None,
                log=print) -> tuple:
    """Stages A-E in order into out_dir (the twin cache in cache_dir,
    default out_dir; the result at result_path), each skipped when its
    output exists: A the cache, B the checkpoint, C stage_c_done.json, D
    the baseline (cfg.base, or out_dir/speedy_baseline.npz), E the
    result.  twin: the set-up (twin.twin_setup; default the T30 one on
    `device`).  cycles and baseline_days: stage C's cycles and stage D's
    days (default cfg.years years of each).  samples_per_year: the
    climatologies' year (stages D and E), SPY by default.  figures: draw
    the figures (needs matplotlib).  Returns (the result, the letters of
    the stages that ran)."""
    t_all = time.time()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    twin = twin or twin_setup(device=device)
    ran = []
    data = twin_data(twin.gcm_true, twin.gcm_imp, cfg.n,
                     cache_dir or out, source=twin.source,
                     spinup_days=spinup_days, margin=margin, mmap=cfg.mmap,
                     log=log)
    if data.generated:
        ran.append("A")
    truth, model, dates = data.truth, data.model, data.dates
    done_c = out / "stage_c_done.json"
    stream = str(out / "hybrid_climate.npz")
    if not done_c.exists():
        hyb, trained = stage_training(
            cfg, twin, truth, model, out / f"hybrid_m{cfg.m}_N{cfg.n}.ckpt",
            out / "train_meta.json", log)
        ran += ["B"] * trained + ["C"]
        stage_free_run(hyb, truth, model, dates, cfg.n,
                       cycles if cycles is not None else cfg.years * SPY,
                       out, cfg.dispatch, log)
        del hyb
    else:
        log("stage C: done previously")
    base = Path(cfg.base or out / "speedy_baseline.npz")
    if not base.exists():
        days = baseline_days if baseline_days is not None \
            else cfg.years * 365
        log(f"stage D: {days} days of the pure-SPEEDY baseline")
        speedy_baseline(twin.gcm_imp, dates[cfg.n + SYNC + 8], days, base,
                        samples_per_year, log)
        ran.append("D")
    else:
        log("stage D: cached")
    if Path(result_path).exists():
        log(f"stage E: done previously ({result_path})")
        return json.loads(Path(result_path).read_text()), ran
    log("stage E: verification products")
    products = climate_products(stream, base, truth, twin.gcm_imp.geom,
                                cfg.n, samples_per_year)
    drawn = climate_figures(products, out, log) if figures else []
    result = verify_climate(products, done_c, result_path, m=cfg.m,
                            n_train=cfg.n, years=cfg.years,
                            ocean_beta=cfg.ocean_beta,
                            boundary=twin.source, figures=drawn)
    ran.append("E")
    log(f"{result_path} written in {time.time() - t_all:.0f}s; "
        f"rss {rss_pct():.0f}%")
    return result, ran

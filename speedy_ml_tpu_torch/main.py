"""Config-driven entry point: one typed RunConfig drives train + predict.

The reference's single binary dispatches on trained_model
(parallelmain.f90:71-272); configuration there is compile-time constants
+ sed rewriting.  Here, as in the JAX package:

    python -m speedy_ml_tpu_torch.main train   config.json
    python -m speedy_ml_tpu_torch.main predict config.json
    python -m speedy_ml_tpu_torch.main run     config.json   # train then predict
    python -m speedy_ml_tpu_torch.main plot    config.json   # figures from output

Data comes from cfg.era_path (yearly ERA5 files) or, when absent, from a
self-generated nature run (self-contained operation for development).
Weights go to cfg.checkpoint_path; predictions stream to
cfg.output_path.  train, predict and run go on CUDA; with no CUDA device
the command exits non-zero before it writes anything.  From Python,
main([...], device="cpu") runs them on the CPU (the kernels' plain
versions).  plot runs on the host alone.
"""

from __future__ import annotations

import sys

import numpy as np

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.config import RunConfig
from speedy_ml_tpu_torch.data.calendar import ModelDate


def train_stride(cfg: RunConfig) -> int:
    """Sub-series stride for training (mod_reservoir.f90:287-299).

    ERA5 files hold HOURLY samples trained on a timestep_hours cycle, so
    the series splits into timestep_hours interleaved sub-series; a
    self-generated nature run already samples at timestep_hours, so its
    stride is 1 (setting n_subseries there would train on
    n_subseries*timestep_hours spacing — wrong)."""
    if cfg.era_path:
        return cfg.n_subseries or cfg.timestep_hours
    return 1


def build_source(cfg: RunConfig, gcm, n_samples: int, date0: ModelDate):
    """SeriesSource for training: ERA5 files (+ precomputed SPEEDY
    forecast-state files for the hybrid's local_model input) if
    configured, else a nature run + imperfect 6-h forecasts on the GCM's
    device (self-contained mode)."""
    from speedy_ml_tpu_torch.hybrid.chunked import ArraySource, ERASource

    if cfg.era_path:
        from speedy_ml_tpu_torch.data.era import ERA5Reader
        reader = ERA5Reader(cfg.era_path)
        model_reader = None
        if not cfg.ml_only:
            from speedy_ml_tpu_torch.data.model_states import \
                ModelStateReader
            msr = ModelStateReader(cfg.model_states_path or cfg.era_path,
                                   date0.year)
            if not msr.year_path(date0.year).exists():
                raise FileNotFoundError(
                    f"hybrid training needs SPEEDY forecast-state files "
                    f"({msr.year_path(date0.year)} missing; generate them "
                    "with data.model_states.generate_model_state_files, "
                    "or set ml_only)")
            model_reader = msr.model_at
        sst_climo = None
        if cfg.train_on_sst_anomalies:
            from speedy_ml_tpu_torch.data.era import daily_sst_climatology
            years = reader.available_years(date0.year, date0.year + 40)
            sst_climo = daily_sst_climatology(reader, years)
        return ERASource(reader, date0.year, n_samples,
                         sample_stride_hours=1, model_reader=model_reader,
                         sst_climo=sst_climo)
    from speedy_ml_tpu_torch.hybrid.training import (
        generate_nature_run, make_imperfect_forecasts)
    truth, snaps, dates = generate_nature_run(
        gcm, date0, n_samples, timestep_hours=cfg.timestep_hours)
    model = None
    if not cfg.ml_only:
        model = make_imperfect_forecasts(gcm, truth, dates,
                                         cfg.timestep_hours)
    return ArraySource(truth, model)


def train(cfg: RunConfig, source=None, *, device=None):
    """Train all reservoirs per the config on `device` (default CUDA;
    raises without one); save a native checkpoint."""
    from speedy_ml_tpu_torch.data.checkpoint import save_hybrid
    from speedy_ml_tpu_torch.hybrid.chunked import train_hybrid_production

    device = resolve_device(device)
    gcm = cfg.build_gcm(device=device)
    layout = cfg.build_layout()
    dtype = cfg.torch_dtype()
    date0 = ModelDate(cfg.start_year, 1, 1)
    stride = train_stride(cfg)
    n_samples = cfg.training_hours // cfg.timestep_hours * stride
    if source is None:
        source = build_source(cfg, gcm, n_samples, date0)
    if cfg.num_vert_levels > 1:
        # vertical localization trains through the in-memory path
        from speedy_ml_tpu_torch.hybrid.training import train_hybrid
        idx = np.arange(source.n_samples)
        truth = source.truth_at(idx)
        model = source.model_at(idx)
        hyb = train_hybrid(gcm, layout, truth, model, cfg.atmo, cfg.seed,
                           num_vert_levels=cfg.num_vert_levels,
                           vert_overlap=cfg.vert_overlap, dtype=dtype,
                           topology=cfg.topology,
                           precip_eps=cfg.precip_epsilon, device=device)
    else:
        # n_batches normal-equation accumulation chunks per sub-series
        # (initialize_chunk_training's 20 batches,
        # mod_reservoir.f90:1559-1590)
        sub_len = n_samples // stride
        time_chunk = max(16, -(-sub_len // cfg.n_batches))
        hyb = train_hybrid_production(
            gcm, layout, source, cfg.atmo, cfg.seed,
            ocean=cfg.slab_ocean, ocean_hyper=cfg.ocean,
            hybrid_ocean=cfg.hybrid_ocean,
            slab_stride=max(1, cfg.timestep_slab_hours // cfg.timestep_hours),
            hybrid=not cfg.ml_only, stride=stride, time_chunk=time_chunk,
            n_discard=max(1, cfg.discard_hours // cfg.timestep_hours),
            precip_eps=cfg.precip_epsilon, dtype=dtype,
            topology=cfg.topology, device=device)
    save_hybrid(hyb, cfg.checkpoint_path)
    print(f"trained {len(hyb.packs)} class packs -> {cfg.checkpoint_path}")
    return hyb


def load_weights(cfg: RunConfig, gcm, layout, device):
    """The trained hybrid from cfg.checkpoint_path: reference-format
    worker files (worker_*_level_*.nc) if there are any, else a native
    checkpoint (either package's)."""
    import glob
    import os

    dtype = cfg.torch_dtype()
    workers = glob.glob(os.path.join(cfg.checkpoint_path,
                                     "worker_*_level_*.nc"))
    if workers:
        # reference-format trained weights (the Zenodo artifact layout;
        # parallelmain.f90:142-199 load path)
        from speedy_ml_tpu_torch.data.reference_import import (
            import_reference_weights, read_reference_worker, worker_path)
        trial = "_".join(os.path.basename(workers[0]).split("_")[4:])[:-3]
        reader = lambda r: read_reference_worker(
            worker_path(cfg.checkpoint_path, r, trial))
        return import_reference_weights(gcm, layout, gcm.geom.nlev, reader,
                                        hyper=cfg.atmo, dtype=dtype,
                                        ml_only=cfg.ml_only, device=device)
    from speedy_ml_tpu_torch.data.checkpoint import load_hybrid
    return load_hybrid(gcm, layout, cfg.checkpoint_path, dtype=dtype,
                       device=device)


def predict(cfg: RunConfig, hyb=None, sync_truth=None, model_next=None,
            start_date: ModelDate | None = None, *, device=None):
    """Load weights (if needed), synchronize, run the prediction loop on
    `device` (default: the hybrid's, else CUDA; raises without one)."""
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction

    if hyb is not None:
        gcm, layout = hyb.gcm, hyb.layout
    else:
        device = resolve_device(device)
        gcm = cfg.build_gcm(device=device)
        layout = cfg.build_layout()
        hyb = load_weights(cfg, gcm, layout, device)
    start_date = start_date or ModelDate(cfg.start_year, 1, 1)
    if sync_truth is None and cfg.era_path:
        # synchronize on the ERA window following the training period
        # (start_prediction/synchronize on era data,
        # mod_reservoir.f90:938-959)
        step = cfg.timestep_hours
        n_sync = max(2, cfg.sync_hours // step)
        end_h = cfg.training_hours + n_sync * step
        source = build_source(cfg, gcm, end_h + step,
                              ModelDate(cfg.start_year, 1, 1))
        idx = cfg.training_hours + np.arange(n_sync) * step
        sync_truth = source.truth_at(idx)
        start_date = ModelDate(cfg.start_year, 1, 1).advance_hours(
            int(idx[-1]) + step)
        if not cfg.ml_only:
            nxt = source.model_at(np.asarray([int(idx[-1]) + step]))
            model_next = {k: v[0] for k, v in nxt.items()}
    elif sync_truth is None:
        # self-contained: synchronize on a fresh nature-run window
        from speedy_ml_tpu_torch.hybrid.training import generate_nature_run
        n_sync = max(2, cfg.sync_hours // cfg.timestep_hours)
        sync_truth, _, dates = generate_nature_run(
            gcm, start_date, n_sync, timestep_hours=cfg.timestep_hours)
        start_date = dates[-1]
        if not cfg.ml_only:
            model_next = dict(atmo=sync_truth["atmo"][-1],
                              logp=sync_truth["logp"][-1])
    hyb.persist_surface = cfg.persist_surface
    hyb.emit_components = cfg.emit_components
    # ocean step cadence (timestep_slab, mod_reservoir.f90:37): instance
    # override of the class default; set before start_prediction, which
    # sizes the ocean rings by it
    hyb.SLAB_STRIDE = max(1, cfg.timestep_slab_hours // cfg.timestep_hours)
    hstate = hyb.start_prediction(
        {k: v[:-1] for k, v in sync_truth.items()}, model_next,
        sync_truth["sst"][-1])
    n_cycles = cfg.prediction_hours // cfg.timestep_hours
    out = f"{cfg.output_path}/prediction"
    hstate, dates = run_prediction(
        hyb, hstate, start_date, n_cycles, output_path=out,
        timestep_hours=cfg.timestep_hours,
        sst_bias_per_year=cfg.sst_bias,
        time_mean_path=f"{cfg.output_path}/time_means.npz")
    print(f"{len(dates)} cycles -> {out}.npz (safe={bool(hstate.safe)})")
    return hstate, dates


def plot(cfg: RunConfig) -> list:
    """Render the standard verification figure set from a finished
    prediction stream ({output_path}/prediction.npz) into
    {output_path}/figures/ — the CLI face of the reference's scripts/
    plotting suite (hybrid_climo.py, enso_hybrid.py, sst_maps.py,
    stratosphere_climo.py, extreme_values.py).  Host only: the
    latitudes come from cfg.geometry(), no GCM is built."""
    import os

    from speedy_ml_tpu_torch import analysis, plots

    pred = analysis.load_prediction(f"{cfg.output_path}/prediction.npz")
    geom = cfg.geometry()
    lat = np.rad2deg(np.asarray(geom.lat_radians))
    lon = np.arange(geom.nlon) * 360.0 / geom.nlon
    sigma = np.linspace(0.05, 0.95, geom.nlev)
    fig_dir = f"{cfg.output_path}/figures"
    os.makedirs(fig_dir, exist_ok=True)
    spy = max(1, 8760 // cfg.timestep_hours)
    dt_days = cfg.timestep_hours / 24.0
    atmo, sst, precip = pred["atmo"], pred["sst"], pred["precip"]
    t_sfc, u = atmo[:, 0, -1], atmo[:, 1]
    w = np.cos(np.deg2rad(lat))[:, None]
    tmean = (t_sfc * w).sum(axis=(-2, -1)) / (w.sum() * geom.nlon)
    done = [
        plots.trend_figure(tmean, dt_days, smooth=min(len(tmean), 28),
                           path=f"{fig_dir}/global_mean_t.png"),
        plots.zonal_mean_section(u.mean(axis=0), lat, sigma,
                                 path=f"{fig_dir}/zonal_mean_u.png"),
        plots.qbo_figure(u, lat, sigma, dt_days,
                         path=f"{fig_dir}/qbo_section.png"),
        plots.precip_extreme_map(precip, lat, lon,
                                 path=f"{fig_dir}/precip_extremes.png"),
        plots.sst_anomaly_map(sst[-1], sst.mean(axis=0), lat, lon,
                              path=f"{fig_dir}/sst_anomaly.png"),
    ]
    if len(sst) >= 2 * spy:      # seasonal climatology needs >= 2 years
        nino = analysis.nino34_index(sst, lat, lon, spy)
        done.append(plots.nino34_figure(
            sst, lat, lon, spy, path=f"{fig_dir}/nino34.png"))
        done.append(plots.wavelet_figure(
            nino, dt_days, path=f"{fig_dir}/nino34_wavelet.png"))
    print(f"{len(done)} figures -> {fig_dir}/")
    return done


def main(argv=None, *, device=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2 or argv[0] not in ("train", "predict", "run",
                                         "plot"):
        print(__doc__)
        return 2
    mode, cfg_path = argv
    cfg = RunConfig.load(cfg_path)
    if mode == "plot":
        plot(cfg)
        return 0
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        print(f"speedy_ml_tpu_torch.main {mode}: {e}", file=sys.stderr)
        return 1
    hyb = None
    if mode in ("train", "run"):
        hyb = train(cfg, device=device)
    if mode in ("predict", "run"):
        predict(cfg, hyb=hyb if mode == "run" else None, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

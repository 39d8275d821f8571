"""The twin skill experiment: does the reservoir correction beat the pure
imperfect SPEEDY forecast?

The protocol, at the production geometry by default (T30 96 x 48 x 8,
1,152 regions, m >= 3000, four held-out initial conditions) and for
each reservoir topology (the shift/ring ensemble and the reference's
random permutation graphs, mod_linalg.f90:180-218):

- TRUTH and the IMPERFECT MODEL as in twin.py;
- training pairs: the truth samples against the imperfect 6-h forecasts
  launched from the truth (the read_model_states protocol,
  speedy_res_interface.f90:634-720);
- evaluation: 14-day free-running forecasts from held-out initial
  conditions, the hybrid against the imperfect SPEEDY alone; the metric
  is the cos-latitude-weighted T RMSE against the truth (the rms of the
  reference's hybrid_climo.py:28-40, with Gaussian-latitude weights).

On scale: n_train must well exceed the readout dimension A = S + n
(m = 3000 gives A = 3012).  An underdetermined ridge readout at the
reference's beta_res^2 = 1e-6 interpolates the training set with |Wout|
~ 1e4-1e5 and the hybrid diverges at its first cycle.  The reference
trains 227,760 pairs against A ~ 5,892; the default here is 2,000
pairs, and the ridge 0.05 (the reference's 0.001 squared sits below a
float32 Gram's noise at that ratio).

SkillConfig's fields are the program's settings, with their defaults.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from speedy_ml_tpu_torch.experiments.twin import (ExperimentAbort,
                                                  twin_data, twin_setup)

N_IC = 4          # held-out initial conditions
NCYC = 56         # 14 days of 6-h cycles
SYNC = 24
PROTOCOL = "hybrid_climo.py rms, cos-lat weighted"


@dataclasses.dataclass
class SkillConfig:
    n_train: int = 2000       # training samples (500 days of 6-h samples)
    m: int = 3000             # reservoir size
    topos: tuple = ("shift", "random")    # the arms, run in this order


def t_rmse(geom, a: np.ndarray, b: np.ndarray) -> float:
    """cos(latitude)-weighted RMSE of two (K, lat, lon) T fields, summed
    over the levels as the program does."""
    w = np.cos(geom.lat_radians)[:, None]
    return float(np.sqrt((w * (a - b) ** 2).sum() / (w.sum() * geom.nlon)))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def skill_forecasts(hyb, gcm_imp, truth: dict, model: dict, dates: list,
                    ics, ncyc: int = NCYC, sync: int = SYNC,
                    tag: str = "", log=print) -> list:
    """The evaluation of a trained hybrid: for each initial condition ic,
    the hybrid synchronized on truth[ic - sync:ic] (start_prediction) and
    the imperfect SPEEDY started from the truth at ic - 1 through the
    hybrid's injection (init_state, stepone), then ncyc times a hybrid
    cycle and a 6-h SPEEDY window (no flux reset, no coupling), each held
    against the truth.  Returns [dict(ic, hybrid, speedy)] with the two
    RMSE lists; a non-finite RMSE raises ExperimentAbort."""
    geom = gcm_imp.geom
    dev, dt = gcm_imp.device, gcm_imp.dtype
    steps = gcm_imp.nsteps_day * 6 // 24
    per_ic = []
    for ic in ics:
        st = hyb.start_prediction({k: v[ic - sync:ic]
                                   for k, v in truth.items()},
                                  dict(atmo=model["atmo"][ic],
                                       logp=model["logp"][ic]),
                                  truth["sst"][ic - 1])
        d = dates[ic]
        spec, _ = hyb.inject_to_speedy(
            torch.as_tensor(np.asarray(truth["atmo"][ic - 1]), device=dev,
                            dtype=dt),
            torch.as_tensor(np.asarray(truth["logp"][ic - 1]), device=dev,
                            dtype=dt))
        state_imp, forcing = gcm_imp.init_state(dates[ic - 1],
                                                spectral=spec)
        state_imp = gcm_imp.stepone(state_imp, forcing)
        dd = dates[ic - 1]
        errs_h, errs_s = [], []
        for c in range(ncyc):
            st, diag = hyb.cycle(st, d.month - 1, d.tmonth, d.tyear)
            forcing = gcm_imp.forcing_for(state_imp.sfc, dd.tyear)
            state_imp = gcm_imp.run_window(state_imp, forcing, steps)
            dd = dd.advance_hours(6)
            d = d.advance_hours(6)
            k = ic + c
            if k >= truth["atmo"].shape[0]:
                break
            tr = np.asarray(truth["atmo"][k][0])
            errs_h.append(t_rmse(geom, _host(diag["atmo"][0]), tr))
            errs_s.append(t_rmse(geom, _host(gcm_imp.sht.spec_to_grid(
                state_imp.spectral.t[0])), tr))
        eh, es = np.array(errs_h), np.array(errs_s)
        if not (np.isfinite(eh).all() and np.isfinite(es).all()):
            raise ExperimentAbort(f"non-finite eval RMSE at IC {ic} ({tag})")
        per_ic.append(dict(ic=ic, hybrid=eh.tolist(), speedy=es.tolist()))
        leads = [(f"day{(i + 1) // 4}", i) for i in (3, 11, 27)
                 if i < len(eh)] + [(f"day{len(eh) / 4:g}", len(eh) - 1)]
        log(f"[{tag}] IC {ic}: " + " ".join(
            f"{nm} {eh[i]:.3f}/{es[i]:.3f}" for nm, i in leads)
            + " (hyb/spd T-RMSE K)")
    return per_ic


def skill_arm(gcm_imp, layout, truth: dict, model: dict, dates: list, *,
              n_train: int, m: int, topology: str, n_ic: int = N_IC,
              ncyc: int = NCYC, sync: int = SYNC, beta_res: float = 0.05,
              log=print) -> dict:
    """One arm of the experiment: the hybrid trained on the first n_train
    samples (train_hybrid_production, region chunk 96, time chunk 256,
    `topology`, ESNHyper(m, deg=6, noise_mag=0.2, beta_res), seed 0) on
    gcm_imp's device, evaluated from the held-out initial conditions
    n_train + 8 + 24 i (skill_forecasts).  Returns the arm's entry of
    the result: the RMSE by lead averaged over the ICs, their means,
    whether the hybrid beats SPEEDY at every lead, and each IC's lists."""
    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
    from speedy_ml_tpu_torch.hybrid.chunked import (ArraySource,
                                                    train_hybrid_production)

    src = ArraySource({k: v[:n_train] for k, v in truth.items()},
                      {k: v[:n_train] for k, v in model.items()})
    hyper = ESNHyper(m=m, deg=6, noise_mag=0.2, beta_res=beta_res)
    t0 = time.time()
    hyb = train_hybrid_production(gcm_imp, layout, src, hyper, 0,
                                  hybrid=True, region_chunk=96,
                                  time_chunk=256, dtype=gcm_imp.dtype,
                                  topology=topology, device=gcm_imp.device)
    t_train = time.time() - t0
    log(f"[{topology}] trained m={m} in {t_train:.0f}s")
    for p in hyb.packs:
        w = p.res.wout.float().abs()
        log(f"[{topology}]   class {p.cls.name}: |wout|max "
            f"{float(w.max()):.3e} mean {float(w.mean()):.3e} "
            f"finite={bool(torch.isfinite(w).all())}")
    ics = [n_train + 8 + i * 24 for i in range(n_ic)]
    per_ic = skill_forecasts(hyb, gcm_imp, truth, model, dates, ics, ncyc,
                             sync, topology, log)
    eh = np.mean([np.array(p["hybrid"]) for p in per_ic], axis=0)
    es = np.mean([np.array(p["speedy"]) for p in per_ic], axis=0)
    log(f"[{topology}] mean T-RMSE hybrid {eh.mean():.3f} vs speedy "
        f"{es.mean():.3f}; beats at all leads: {(eh < es).all()}")
    return dict(
        n_train=n_train, m=m, n_ic=n_ic, train_wall_s=round(t_train, 1),
        lead_days=[(i + 1) / 4 for i in range(len(eh))],
        hybrid_rmse=eh.tolist(), speedy_rmse=es.tolist(),
        hybrid_mean=float(eh.mean()), speedy_mean=float(es.mean()),
        beats_speedy_all_leads=bool((eh < es).all()),
        per_ic=per_ic)


def _write(path: Path, results: dict):
    path.write_text(json.dumps(results, indent=1, allow_nan=False))


def run_skill(cfg: SkillConfig, result_path, *, twin=None, cache_dir=None,
              spinup_days: int = 30, margin: int = 160, device=None,
              log=print) -> dict:
    """Every arm of cfg.topos on the twin data of cfg.n_train samples
    (the cache in cache_dir, default result_path's directory, shared with
    the climate run), merged into the results already at result_path
    (arms may run in separate calls) and written after each arm; then the
    run's meta.  twin: the set-up (default the T30 one on `device`).
    Returns the results."""
    t_all = time.time()
    result_path = Path(result_path)
    result_path.parent.mkdir(parents=True, exist_ok=True)
    twin = twin or twin_setup(device=device)
    data = twin_data(twin.gcm_true, twin.gcm_imp, cfg.n_train,
                     cache_dir or result_path.parent, source=twin.source,
                     spinup_days=spinup_days, margin=margin, log=log)
    results = (json.loads(result_path.read_text())
               if result_path.exists() else {})
    for topology in cfg.topos:
        results[topology] = skill_arm(
            twin.gcm_imp, twin.layout, data.truth, data.model, data.dates,
            n_train=cfg.n_train, m=cfg.m, topology=topology, log=log)
        _write(result_path, results)
    g = twin.layout.geom
    results["meta"] = dict(geometry=f"T{g.trunc} {g.nlon}x{g.nlat}x{g.nlev}",
                           n_regions=twin.layout.n_regions,
                           protocol=PROTOCOL,
                           wall_s=round(time.time() - t_all, 1))
    _write(result_path, results)
    return results


def skill_figure(result_path, fig_path, topology: str = "shift") -> str:
    """The RMSE-by-lead figure of one arm of a result file (needs
    matplotlib)."""
    from speedy_ml_tpu_torch import plots

    r = json.loads(Path(result_path).read_text())[topology]
    plots.skill_figure(np.array(r["lead_days"]), np.array(r["hybrid_rmse"]),
                       np.array(r["speedy_rmse"]), path=str(fig_path))
    return str(fig_path)

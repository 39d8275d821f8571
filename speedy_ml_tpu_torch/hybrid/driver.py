"""Prediction driver: the outer loop of a hybrid forecast run.

Reference: parallelmain.f90:142-272 (prediction initialization, the
timestep loop with sendrecievegrid) — a thin Python loop around the
cycle, with a streaming output writer replacing the root-rank NetCDF
appends (mpires.f90:499-543).  The run happens on the device the hybrid
lives on (HybridAtmosphere(device=...)).
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np
import torch

from speedy_ml_tpu_torch.data.calendar import ModelDate, hour_of_year_365


def _host_f32(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, dtype=np.float32)


def _host_fields(diag: dict, sst_grid) -> list:
    """(atmo, logp, precip, sst) of a cycle as host numpy arrays in the
    model's dtype: one device-to-host copy of the four fields joined."""
    fields = (diag["atmo"], diag["logp"], diag["precip"], sst_grid)
    flat = torch.cat([f.reshape(-1) for f in fields]).to("cpu").numpy()
    out, start = [], 0
    for f in fields:
        out.append(flat[start:start + f.numel()].reshape(tuple(f.shape)))
        start += f.numel()
    return out


class PredictionWriter:
    """Streaming 6-hourly output to an .npz series.

    Buffers in host memory and flushes in chunks; one file per run like
    the reference's hybrid_prediction_era...nc.  Base streams are
    atmo/logp/precip/sst; any further diag keys with the vp_/vml_/truth_
    prefixes are written too.  The keys and shapes match the JAX
    package's writer."""

    BASE = ("atmo", "logp", "precip", "sst")

    def __init__(self, path: str, flush_every: int = 64):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.buf: dict = {}
        self.flush_every = flush_every
        self.chunks = 0
        self._keys = None
        self._worker = None     # in-flight compression thread

    def append(self, diag: dict, sst_grid):
        rec = {k: diag[k] for k in diag
               if k in self.BASE or k.startswith(("vp_", "vml_", "truth_"))}
        rec["sst"] = sst_grid
        if self._keys is None:
            self._keys = sorted(rec)
            self.buf = {k: [] for k in self._keys}
        for k in self._keys:
            self.buf[k].append(_host_f32(rec[k]))
        if len(self.buf[self._keys[0]]) >= self.flush_every:
            self.flush()

    def flush(self, wait: bool = False):
        """Write the buffered chunk asynchronously: compression (zlib,
        releases the GIL) runs in a worker thread so the prediction loop
        does not block on it.  At most one flush is in flight."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._keys is not None and self.buf[self._keys[0]]:
            out = {k: np.stack(v) for k, v in self.buf.items()}
            path = self.path.with_suffix(f".part{self.chunks}.npz")
            self._worker = threading.Thread(
                target=np.savez_compressed, args=(path,), kwargs=out)
            self._worker.start()
            self.chunks += 1
            self.buf = {k: [] for k in self._keys}
        if wait and self._worker is not None:
            self._worker.join()
            self._worker = None

    def consolidate(self):
        """Merge all parts into one file."""
        self.flush(wait=True)
        parts = sorted(self.path.parent.glob(self.path.stem + ".part*.npz"),
                       key=lambda p: int(p.suffixes[-2][5:]))
        if not parts:
            return
        merged = {}
        for k in np.load(parts[0]).files:
            merged[k] = np.concatenate([np.load(p)[k] for p in parts])
        np.savez_compressed(self.path.with_suffix(".npz"), **merged)
        for p in parts:
            p.unlink()


def run_prediction(hyb, hstate, start_date: ModelDate, n_cycles: int,
                   output_path: str | None = None,
                   stop_if_unsafe: bool = True,
                   timestep_hours: int = 6,
                   sst_bias_per_year: float = 0.0,
                   truth_provider=None,
                   time_mean_path: str | None = None,
                   consolidate: bool = True,
                   progress_every: int = 0,
                   cycles_per_dispatch: int = 1):
    """Run `n_cycles` hybrid 6-h cycles from `hstate`.

    Returns (final state, list of dates).  Stops early if the SPEEDY
    safety gate trips (parallelmain.f90:268-270).  sst_bias_per_year:
    non-stationary-climate SST ramp (K/year) applied to the SST table's
    climatology over open water (mod_utilities.f90:1806-1823 ramp +
    current_sst_bias of get_sst_by_date).  truth_provider: optional
    callable cycle_index -> dict of truth grids, written beside the
    prediction as truth_* streams (write_truth_data, mpires.f90:918-1112).
    time_mean_path: where the monthly sigma->p time means of the cycles'
    physical fields are saved (timemean.py; the fields come to the host
    once a cycle).  consolidate=False leaves the stream as .partN.npz
    chunk files.

    cycles_per_dispatch = K > 1 runs the cycles in dispatches of K (the
    JAX package's lax.scan path, _run_prediction_batched), unless a
    truth_provider is given (truth joins per cycle on the host): on the
    card each dispatch replays a captured CUDA graph of the cycle
    (hybrid/graph.py) and never waits for the card, the records stay on
    the device and come to the host with one copy a dispatch, and the
    previous dispatch's records go to the writer and the time means while
    the next one runs.  The gate is read once a dispatch: the dates after
    the first unsafe cycle are dropped (its record is kept), and the final
    state is the one at the end of that dispatch.  On a meshed hybrid
    (set_mesh) the dispatches run the meshed cycle (graph.CycleDispatch:
    captured where the shards share one card, eager on several cards);
    the records and the writer's fields stay global on mesh.devices[0],
    and the final state is Sharded, as the per-cycle loop returns it."""
    if int(cycles_per_dispatch) < 1:
        raise ValueError(f"cycles_per_dispatch {cycles_per_dispatch} < 1")
    writer = PredictionWriter(output_path) if output_path else None
    tmean = None
    if time_mean_path:
        # monthly sigma->p time-mean products beside the stream
        # (ppo_tminc/ppo_tmout; timemean.py)
        from speedy_ml_tpu_torch.timemean import TimeMeanAccumulator
        bd = getattr(hyb.gcm, "bd", None)
        if bd is None:
            raise ValueError("time_mean_path needs the hybrid's GCM and its "
                             "boundary data (the orography of the MSL "
                             "pressure)")
        tmean = TimeMeanAccumulator(
            hyb.gcm.geom, phis=bd.phis0.detach().to("cpu").numpy())
    if cycles_per_dispatch > 1 and truth_provider is None:
        hstate, dates = _run_batched(
            hyb, hstate, start_date, n_cycles, writer, tmean,
            stop_if_unsafe, timestep_hours, sst_bias_per_year,
            progress_every, int(cycles_per_dispatch))
        _finish(writer, tmean, consolidate, time_mean_path)
        return hstate, dates
    date = start_date
    dates = []
    params = hyb.params
    # the gate is checked EVERY cycle with a one-step lag: on a device flag
    # bool(prev_safe) only waits for the already-queued previous cycle, so
    # the host keeps one cycle in flight; the ML-only cycle's flag is a
    # host bool and costs no sync at all
    prev_safe = None
    for i in range(n_cycles):
        if stop_if_unsafe and prev_safe is not None and not bool(prev_safe):
            print(f"prediction stopped: SPEEDY safety gate at cycle {i - 1}")
            break
        bias = sst_bias_per_year * (i * timestep_hours) / 8760.0
        hstate, diag = hyb.cycle_with_params(
            params, hstate, date.month - 1, date.tmonth, date.tyear,
            hour_of_year_365(date), bias)
        prev_safe = hstate.safe
        dates.append(date)
        date = date.advance_hours(timestep_hours)
        if writer:
            if truth_provider is not None:
                tr = truth_provider(i)
                diag = dict(diag, **{f"truth_{k}": v for k, v in tr.items()})
            writer.append(diag, hstate.sst_grid)
        if tmean is not None:
            tmean.add(dates[-1], *_host_fields(diag, hstate.sst_grid))
        if progress_every and (i + 1) % progress_every == 0:
            print(f"cycle {i + 1}/{n_cycles} ({date.year}-{date.month:02d}"
                  f"-{date.day:02d}) safe={bool(prev_safe)} "
                  f"t={time.strftime('%H:%M:%S')}", flush=True)
    _finish(writer, tmean, consolidate, time_mean_path)
    return hstate, dates


def _finish(writer, tmean, consolidate, time_mean_path):
    if writer:
        if consolidate:
            writer.consolidate()
        else:
            writer.flush(wait=True)
    if tmean is not None:
        tmean.save(time_mean_path)


def _run_batched(hyb, hstate, start_date, n_cycles, writer, tmean,
                 stop_if_unsafe, timestep_hours, sst_bias_per_year,
                 progress_every, K):
    """run_prediction's loop in dispatches of K cycles (JAX
    hybrid/driver.py:195-309): the per-cycle host numbers of the whole run
    up front, a dispatch (graph.CycleDispatch) into a K-slot record buffer
    on the device, its copy to the host started, the previous dispatch's
    records drained into the writer and the time means meanwhile, then
    this dispatch's gate flags read."""
    from speedy_ml_tpu_torch.hybrid.graph import dispatcher
    disp = dispatcher(hyb)
    all_dates = [start_date]
    for _ in range(n_cycles - 1):
        all_dates.append(all_dates[-1].advance_hours(timestep_hours))
    per = [(d.month - 1, d.tmonth, d.tyear, hour_of_year_365(d),
            sst_bias_per_year * (i * timestep_hours) / 8760.0)
           for i, d in enumerate(all_dates)]
    records = disp.records(min(K, max(n_cycles, 1)))

    def drain(rec, chunk_dates):
        for b, d in enumerate(chunk_dates):
            if writer:
                writer.append({k: v[b] for k, v in rec.items()
                               if k != "safe"}, rec["sst"][b])
            if tmean is not None:
                tmean.add(d, rec["atmo"][b], rec["logp"][b],
                          rec["precip"][b], rec["sst"][b])

    dates, done, pending = [], 0, None
    next_progress = progress_every or None
    while done < n_cycles:
        k = min(K, n_cycles - done)
        hstate = disp.dispatch(hstate, per[done:done + k], records)
        fetched = disp.fetch(records, k)
        # the previous dispatch's records while this one runs
        if pending is not None:
            drain(*pending)
            pending = None
        rec = disp.wait(fetched)
        chunk = all_dates[done:done + k]
        safe = rec["safe"] != 0
        n_ok = k
        if stop_if_unsafe and not safe.all():
            n_ok = int(np.argmin(safe)) + 1     # the first unsafe cycle
            rec = {nm: v[:n_ok] for nm, v in rec.items()}
            chunk = chunk[:n_ok]
        pending = (rec, chunk)
        dates.extend(chunk)
        done += k
        if n_ok < k:
            print(f"prediction stopped: SPEEDY safety gate at cycle "
                  f"{len(dates) - 1}")
            break
        if next_progress is not None and done >= next_progress:
            d = all_dates[done - 1]
            print(f"cycle {done}/{n_cycles} ({d.year}-{d.month:02d}"
                  f"-{d.day:02d}) safe={bool(safe[-1])} "
                  f"t={time.strftime('%H:%M:%S')}", flush=True)
            next_progress += progress_every
    if pending is not None:
        drain(*pending)
    return disp.result(hstate), dates

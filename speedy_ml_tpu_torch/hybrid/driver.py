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

LATER_SLICE = "a later slice of the port (prediction-loop options)"


def _host_f32(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, dtype=np.float32)


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
    non-stationary-climate SST ramp (K/year) handed to the cycle.
    consolidate=False leaves the stream as .partN.npz chunk files."""
    if truth_provider is not None:
        raise NotImplementedError(f"truth_provider comes with {LATER_SLICE}")
    if time_mean_path:
        raise NotImplementedError(f"time-mean products come with "
                                  f"{LATER_SLICE}")
    if cycles_per_dispatch != 1:
        raise NotImplementedError(f"cycles_per_dispatch > 1 comes with "
                                  f"{LATER_SLICE}")

    writer = PredictionWriter(output_path) if output_path else None
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
            writer.append(diag, hstate.sst_grid)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"cycle {i + 1}/{n_cycles} ({date.year}-{date.month:02d}"
                  f"-{date.day:02d}) safe={bool(prev_safe)} "
                  f"t={time.strftime('%H:%M:%S')}", flush=True)
    if writer:
        if consolidate:
            writer.consolidate()
        else:
            writer.flush(wait=True)
    return hstate, dates

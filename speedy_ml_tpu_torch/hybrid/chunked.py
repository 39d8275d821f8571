"""Production-scale reservoir training: region-chunked, time-streamed.

The reference trains 1,152 regions over ~26 years of hourly data
(mod_reservoir.f90:1559-1699 batched normal equations; the strided
sub-series loop at mod_reservoir.f90:287-299 splits the hourly series
into `timestep` interleaves and SUMS their normal equations).  At that
scale neither the packed input series (T, R, I) ~ 100 GB nor the Gram
matrices (R, S+n, S+n) ~ 161 GB fit on one card, so, as in the JAX
package's hybrid/chunked.py, the problem is tiled two ways:

- **region chunks**: the normal equations and the ridge solve run over
  `region_chunk` regions at a time (one (Rch, A, A) Gram on the card,
  updated in place by K14);
- **time chunks**: a `SeriesSource` yields global grids for requested
  sample indices; each chunk is packed, standardized and noised on the
  card for the current region chunk only, and the reservoir state x is
  all that carries from one chunk to the next.

`stride` > 1 splits the samples into interleaved sub-series (sub-series
s takes samples s, s+stride, ...); each restarts the reservoir transient
and all accumulate into the SAME normal equations.

Chunking is exact: noise is drawn per (sub-series, sample) for the whole
class and sliced to the region chunk (hybrid.training.class_noise).

The JAX package's TPU workarounds have no counterpart here: the CPU
staging device (packing runs on the card), the one-hot spmv matrices,
and the host readback that kept one chunk in flight.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.data.era import era_to_truth
from speedy_ml_tpu_torch.esn.domain import RegionLayout, build_layout
from speedy_ml_tpu_torch.esn.ocean import (OCEAN_HYPER, ocean_index_map,
                                           ocean_target_slice, rolling_mean,
                                           sst_core_from_input)
from speedy_ml_tpu_torch.esn.reservoir import (BatchedReservoir, ESNHyper,
                                               generate, radius_by_lat)
from speedy_ml_tpu_torch.esn.standardize import (Standardizer,
                                                 component_expansion,
                                                 component_sums,
                                                 n_components,
                                                 stats_to_standardizer)
from speedy_ml_tpu_torch.esn.train import (NormalEq, accumulate_chunk,
                                           advance, apply_noise_keys,
                                           solve_wout, zero_equations)
from speedy_ml_tpu_torch.hybrid.build import derive_seed
from speedy_ml_tpu_torch.hybrid.model import ClassPack, HybridAtmosphere
from speedy_ml_tpu_torch.hybrid.training import (NVAR, as_tensors,
                                                 class_noise,
                                                 fit_ocean_class,
                                                 precip_noise_info, timed)


class ArraySource:
    """In-memory SeriesSource over the hybrid.training truth/model dicts.

    Protocol (any object with these members works):
      n_samples: int
      truth_at(idx) -> dict of tensors indexed at sample indices
                       (atmo (B,4,K,lat,lon), logp/precip/sst/tisr (B,lat,lon))
      model_at(idx) -> dict(atmo, logp) or None
    Tensors stay where they are (the nature run's live on the card);
    numpy arrays are taken too."""

    def __init__(self, truth: dict, model: Optional[dict] = None):
        self.truth = truth
        self.model = model

    @property
    def n_samples(self) -> int:
        return self.truth["atmo"].shape[0]

    @staticmethod
    def _take(d: dict, idx: np.ndarray) -> dict:
        out = {}
        for k, v in d.items():
            if torch.is_tensor(v):
                out[k] = v[torch.as_tensor(idx, device=v.device)]
            else:
                out[k] = torch.from_numpy(np.asarray(v)[idx])
        return out

    def truth_at(self, idx: np.ndarray) -> dict:
        return self._take(self.truth, idx)

    def model_at(self, idx: np.ndarray) -> Optional[dict]:
        return None if self.model is None else self._take(self.model, idx)


class ERASource:
    """SeriesSource over yearly ERA5 files (data.era.ERA5Reader) plus an
    optional model-forecast reader (e.g. data.model_states.ModelStateReader's
    model_at); loads whole years lazily with an LRU of one year, which
    matches the reference's year-loop streaming reads
    (speedy_res_interface.f90:439-632).

    Sample hours live on the 365-day MODEL calendar (8,760 h/year): leap
    years' Feb-29 records are spliced OUT of the file via
    ERA5Reader.valid_hour_index (the reference's splice at
    speedy_res_interface.f90:588-596), and a requested chunk may span a
    year boundary: the read splits per year-file and concatenates.

    sst_climo: optional (365, lat, lon) daily SST climatology; when given
    SSTs become anomalies against it (train_on_sst_anomalies).  truth_at
    and model_at return what ArraySource's do, the same keys as tensors
    on the CPU; the trainer moves them to its device."""

    VARS = ("t", "u", "v", "q", "logp", "precip", "sst", "tisr")

    def __init__(self, reader, year0: int, n_samples: int,
                 sample_stride_hours: int = 1, model_reader=None,
                 sst_climo=None):
        self.reader = reader
        self.year0 = year0
        self._n = n_samples
        self.stride_h = sample_stride_hours
        self.model_reader = model_reader
        self.sst_climo = None if sst_climo is None else np.asarray(sst_climo)
        self._cache_year = None
        self._cache = None
        self._cache_valid = None

    @property
    def n_samples(self) -> int:
        return self._n

    def _hours(self, idx: np.ndarray) -> np.ndarray:
        return np.asarray(idx) * self.stride_h

    def _year_data(self, year: int):
        """(raw year arrays, Feb-29-spliced hour index) with a 1-year LRU."""
        if self._cache_year != year:
            self._cache = self.reader.read_year(year, variables=self.VARS)
            self._cache_valid = self.reader.valid_hour_index(year)
            self._cache_year = year
        return self._cache, self._cache_valid

    def truth_at(self, idx: np.ndarray) -> dict:
        hours = self._hours(idx)
        years = self.year0 + hours // 8760
        parts = []
        # ascending year order keeps sample order AND leaves the latest
        # year cached for the caller's next (time-ordered) chunk
        for y in sorted(int(v) for v in np.unique(years)):
            off = hours[years == y] - (y - self.year0) * 8760
            data, valid = self._year_data(y)
            parts.append({k: data[k][valid[off]] for k in self.VARS})
        raw = (parts[0] if len(parts) == 1 else
               {k: np.concatenate([p[k] for p in parts]) for k in self.VARS})
        truth = era_to_truth(raw, sst_climo=self.sst_climo,
                             hour_of_year=(hours % 8760
                                           if self.sst_climo is not None
                                           else None))
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in truth.items()}

    def model_at(self, idx: np.ndarray) -> Optional[dict]:
        if self.model_reader is None:
            return None
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in self.model_reader(self._hours(idx)).items()}


# ----------------------------------------------------------------------
# gather-based packing
# ----------------------------------------------------------------------

def gather_pack_inputs(chunk_truth: dict, iy, ix, precip_eps: float,
                       dtype) -> torch.Tensor:
    """Pack input vectors (C, R, I) for regions given window index
    tables iy (R, yi) / ix (R, xi), in the reference packing order
    (atmo z,y,x,v-flattened; then logp/precip/sst/tisr)."""
    ap = RegionLayout.gather_patches(chunk_truth["atmo"], iy, ix)
    # (R, C, V, K, yi, xi) -> (C, R, K, yi, xi, V) -> flatten
    ap = ap.permute(1, 0, 3, 4, 5, 2)
    C, R = ap.shape[0], ap.shape[1]
    parts = [ap.reshape(C, R, -1)]
    for name in ("logp", "precip", "sst", "tisr"):
        f = chunk_truth[name]
        if name == "precip":
            f = torch.log(1.0 + torch.clamp(f, min=0.0) / precip_eps)
        p = RegionLayout.gather_patches(f, iy, ix)      # (R, C, yi, xi)
        parts.append(torch.movedim(p, 0, 1).reshape(C, R, -1))
    return torch.cat(parts, dim=2).to(dtype)


def gather_pack_model(chunk_model: dict, iy, ix, dtype) -> torch.Tensor:
    """Pack the model's core vectors (C, R, S): atmo + logp of the core
    windows iy (R, yc) / ix (R, xc)."""
    ap = RegionLayout.gather_patches(chunk_model["atmo"], iy, ix)
    ap = ap.permute(1, 0, 3, 4, 5, 2)
    C, R = ap.shape[0], ap.shape[1]
    lp = RegionLayout.gather_patches(chunk_model["logp"], iy, ix)
    return torch.cat([ap.reshape(C, R, -1),
                      torch.movedim(lp, 0, 1).reshape(C, R, -1)],
                     dim=2).to(dtype)


# ----------------------------------------------------------------------
# streaming standardizer
# ----------------------------------------------------------------------

def streaming_standardizer(layout: RegionLayout, cls, source, nz: int, *,
                           time_chunk: int = 512, precip_eps: float = 0.001,
                           dtype=torch.float32, std_floor: float = 0.01,
                           device=None) -> Standardizer:
    """Per-component mean/std over the full series without materializing
    it (the streaming twin of esn.standardize.compute_standardizer), on
    `device` (default CUDA; raises without one)."""
    device = resolve_device(device)
    xi, yi = cls.input_shape
    xc, yc = cls.core_shape
    comp_in = component_expansion(xi, yi, NVAR, nz, logp=True, precip=True,
                                  sst=True, tisr=True)
    comp_out = component_expansion(xc, yc, NVAR, nz, logp=True, precip=True,
                                   sst=False, tisr=False)
    nc = n_components(NVAR, nz, logp=True, precip=True, sst=True, tisr=True)
    s1 = s2 = cnt = 0.0
    T = source.n_samples
    for t0 in range(0, T, time_chunk):
        chunk = as_tensors(source.truth_at(np.arange(t0, min(t0 + time_chunk,
                                                           T))), device)
        series = gather_pack_inputs(chunk, cls.iy_in, cls.ix_in, precip_eps,
                                    dtype)
        a1, a2, c = component_sums(series, comp_in, nc)
        s1, s2, cnt = s1 + a1, s2 + a2, cnt + c
    return stats_to_standardizer(s1, s2, torch.clamp(cnt, min=1.0), comp_in,
                                 comp_out, (NVAR, nz), std_floor)


# ----------------------------------------------------------------------
# chunked accumulation
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ClassTrainer:
    """One class's production training, piece by piece: the reservoir,
    the standardizer and the settings that every region chunk shares.
    normal_equations(r0, r1) accumulates the equations of regions
    [r0, r1); pack(wout) makes the trained ClassPack."""
    layout: RegionLayout
    cls: object
    source: object
    hyper: ESNHyper
    seed: int
    nz: int
    res: BatchedReservoir       # wout (Rc, O, 0): not trained yet
    std: Standardizer
    S: int                      # model block (0 without it)
    O: int
    time_chunk: int
    stride: int
    n_discard: int
    n_pairs: Optional[int]
    precip_eps: float
    dtype: torch.dtype
    device: torch.device

    def _region_res(self, r0: int, r1: int) -> BatchedReservoir:
        r = self.res
        return dataclasses.replace(
            r, vals=r.vals[:, r0:r1].contiguous(),
            win_vals=r.win_vals[r0:r1].contiguous(),
            cols=r.cols if r.cols.dim() == 2 else r.cols[r0:r1].contiguous(),
            wout=r.wout[r0:r1], mean=r.mean[r0:r1], std=r.std[r0:r1])

    def _prep(self, idx, c0: int, r0: int, r1: int, noise, precip_info):
        """Standardized inputs z (with noise), clean targets and the
        standardized model block of sub-series positions c0.. (sample
        indices idx) for regions [r0, r1)."""
        cls, std = self.cls, self.std
        chunk = as_tensors(self.source.truth_at(idx), self.device)
        series = gather_pack_inputs(chunk, cls.iy_in[r0:r1], cls.ix_in[r0:r1],
                                    self.precip_eps, self.dtype)
        C, Rch = series.shape[0], series.shape[1]
        z = (series - std.in_mean[r0:r1]) / std.in_std[r0:r1]
        target = self.layout.input_to_target(
            cls, z.reshape(C * Rch, -1), NVAR, self.nz, self.nz, 0,
            logp=True, precip=True, sst=True, tisr=True).reshape(C, Rch, -1)
        if noise is not None:
            g = torch.stack([noise(c0 + c) for c in range(C)])
            z = apply_noise_keys(g, z, self.hyper.noise_mag,
                                 precip_slice=precip_info["slice"],
                                 precip_mean=precip_info["mean"],
                                 precip_std=precip_info["std"],
                                 precip_eps=precip_info["eps"])
        if self.S == 0:
            return z, target, None
        model = self.source.model_at(idx)
        if model is None:
            raise ValueError("hybrid training needs the source's model "
                             "forecasts (model_at returned None)")
        S = self.S
        mser = gather_pack_model(as_tensors(model, self.device),
                                 cls.iy_core[r0:r1], cls.ix_core[r0:r1],
                                 self.dtype)
        zm = ((mser - std.out_mean[None, r0:r1, :S])
              / std.out_std[None, r0:r1, :S])
        return z, target, zm

    def normal_equations(self, r0: int, r1: int) -> NormalEq:
        """The summed normal equations of regions [r0, r1) over every
        sub-series: each discards n_discard samples from a zero state,
        then pairs its states with targets, time_chunk samples per K14
        launch."""
        res = self._region_res(r0, r1)
        hyper, n_discard = self.hyper, self.n_discard
        Rc, I = self.res.win_vals.shape[0], self.res.n_in
        eq = zero_equations(r1 - r0, self.S + res.n, self.O, self.dtype,
                            self.device)
        noisy = hyper.noise_mag > 0
        precip_info = None if not noisy else precip_noise_info(
            self.std, build_layout(*self.cls.input_shape, NVAR, self.nz,
                                   logp=True, precip=True, sst=True,
                                   tisr=True),
            self.nz, self.precip_eps, rows=slice(r0, r1))
        T = self.source.n_samples
        for s in range(self.stride):
            sub_idx = np.arange(s, T, self.stride)
            pairs = len(sub_idx) - n_discard
            if self.n_pairs is not None:
                pairs = min(self.n_pairs, pairs)
            noise = None if not noisy else class_noise(
                self.seed, s, (Rc, I), self.dtype, self.device,
                rows=slice(r0, r1))
            x = torch.zeros((r1 - r0, res.n), dtype=self.dtype,
                            device=self.device)
            end = n_discard + pairs
            for c0 in range(0, end, self.time_chunk):
                c1 = min(c0 + self.time_chunk, end)
                z, target, zm = self._prep(sub_idx[c0:c1], c0, r0, r1, noise,
                                           precip_info)
                # the chunk that straddles n_discard advances its first d
                # samples and pairs the rest
                d = min(max(n_discard - c0, 0), c1 - c0)
                if d:
                    x = advance(res, hyper, x, z[:d])
                if d < c1 - c0:
                    x = accumulate_chunk(res, hyper, x, eq, z[d:], target[d:],
                                         None if zm is None else zm[d:])
        return eq

    def pack(self, wout: torch.Tensor) -> ClassPack:
        return ClassPack(cls=self.cls,
                         res=dataclasses.replace(self.res, wout=wout),
                         hyper=self.hyper, std=self.std)


def hyper_inputs(layout: RegionLayout, cls, nz: int) -> int:
    """Input vector length for a class (atmo + logp/precip/sst/tisr)."""
    xi, yi = cls.input_shape
    return build_layout(xi, yi, NVAR, nz, logp=True, precip=True,
                        sst=True, tisr=True).total


def class_trainer(layout: RegionLayout, cls, source, hyper: ESNHyper,
                  seed: int, nz: int, *, time_chunk: int = 128,
                  stride: int = 1, n_discard: int = 10,
                  n_pairs: Optional[int] = None, precip_eps: float = 0.001,
                  dtype=torch.float32, topology: str = "shift",
                  std: Optional[Standardizer] = None, hybrid: bool = True,
                  timings: Optional[dict] = None,
                  device=None) -> ClassTrainer:
    """The ClassTrainer of one class: the streaming standardizer (unless
    `std` is given) and the reservoirs, drawn from `seed`."""
    device = resolve_device(device)
    if std is None:
        std = timed(timings, "standardizer", device,
                    lambda: streaming_standardizer(
                        layout, cls, source, nz,
                        time_chunk=max(time_chunk, 128),
                        precip_eps=precip_eps, dtype=dtype, device=device))
    Rc = cls.count
    radius = radius_by_lat(layout.lat_start[cls.region_ids],
                           layout.lat_end[cls.region_ids])
    I = hyper_inputs(layout, cls, nz)
    cols, vals, win, shifts = timed(
        timings, "generate", device,
        lambda: generate(seed, Rc, I, hyper, radius, dtype=dtype,
                         topology=topology, device=device))
    xc, yc = cls.core_shape
    O = NVAR * nz * xc * yc + 2 * xc * yc        # atmo + logp + precip
    res = BatchedReservoir(cols=cols, vals=vals, win_vals=win, n_in=I,
                           wout=torch.zeros((Rc, O, 0), dtype=dtype,
                                            device=device),
                           mean=std.in_mean, std=std.in_std, shifts=shifts)
    return ClassTrainer(
        layout=layout, cls=cls, source=source, hyper=hyper, seed=seed, nz=nz,
        res=res, std=std, S=(O - xc * yc) if hybrid else 0, O=O,
        time_chunk=time_chunk, stride=stride, n_discard=n_discard,
        n_pairs=n_pairs, precip_eps=precip_eps, dtype=dtype, device=device)


def train_class_production(layout: RegionLayout, cls, source, hyper: ESNHyper,
                           seed: int, nz: int, *, region_chunk: int = 32,
                           solve_dtype=None, timings: Optional[dict] = None,
                           device=None, **kw) -> ClassPack:
    """Region-chunked + time-streamed train_class (production scale).

    source: SeriesSource of T samples; with `stride` > 1 the samples are
    split into `stride` interleaved sub-series, each restarting the
    reservoir transient, all summing into one NormalEq.  n_pairs: per
    sub-series cap on (state, target) pairs (tests use it to match the
    in-memory trainer's complete batches); default all.  Further keywords
    (time_chunk, stride, n_discard, n_pairs, precip_eps, dtype, topology,
    std, hybrid) go to class_trainer.  timings: a dict that collects wall
    seconds per stage (standardizer, generate, accumulate, solve), the
    device synchronized around each."""
    device = resolve_device(device)
    tr = class_trainer(layout, cls, source, hyper, seed, nz, timings=timings,
                       device=device, **kw)
    parts = []
    for r0 in range(0, cls.count, region_chunk):
        r1 = min(r0 + region_chunk, cls.count)
        eq = timed(timings, "accumulate", device,
                   lambda: tr.normal_equations(r0, r1))
        parts.append(timed(timings, "solve", device,
                           lambda: solve_wout(eq, hyper, tr.S, solve_dtype)))
        del eq
    return tr.pack(torch.cat(parts))


def ocean_series_production(layout: RegionLayout, cls, atmo_std, source,
                            nz: int, *, slab_stride: int = 28,
                            stride: int = 1, time_chunk: int = 512,
                            precip_eps: float = 0.001, dtype=torch.float32,
                            device=None):
    """Stream the slab-ocean training series from a SeriesSource, on
    `device` (default CUDA; raises without one).

    The slab inputs are trailing `slab_stride`-sample rolling means of
    the atmo-standardized ocean-input sub-vector, sampled at the slab
    cadence; targets are the SST core at the same cadence
    (get_training_data_from_atmo's rolling average + stride,
    mod_slab_ocean_reservoir.f90:272-376).  The 6-h base series is
    sub-series 0 of `stride` (hourly sources).  Time chunks stream
    through, the rolling window's last slab_stride - 1 samples carried
    across chunk edges: the full truth is never held.  The mean SST grid
    (base_sst, the land fill of mpires.f90:458-472) is summed as the
    chunks go.

    Returns (o_series (T_slab, Rc, I_o), target (T_slab, Rc, O), the mean
    SST grid (lat, lon))."""
    device = resolve_device(device)
    idx_map = torch.as_tensor(ocean_index_map(cls, nz), dtype=torch.long,
                              device=device)
    sl = ocean_target_slice(cls, nz)
    W = slab_stride
    sub_idx = np.arange(0, source.n_samples, stride)
    T = len(sub_idx)
    o_parts, t_parts = [], []
    sst_sum, n_sst = None, 0
    carry = torch.zeros((0, cls.count, len(idx_map)), dtype=dtype,
                        device=device)
    for pos in range(0, T, time_chunk):
        idx = sub_idx[pos:pos + time_chunk]
        truth = as_tensors(source.truth_at(idx), device)
        series = gather_pack_inputs(truth, cls.iy_in, cls.ix_in, precip_eps,
                                    dtype)
        z = (series - atmo_std.in_mean) / atmo_std.in_std
        full = torch.cat([carry, z[:, :, idx_map]])
        rm = rolling_mean(full, W)[carry.shape[0]:]
        C, Rc = z.shape[:2]
        tgt = sst_core_from_input(
            cls, z[:, :, sl[0]:sl[1]].reshape(C * Rc, -1)).reshape(C, Rc, -1)
        carry = full[-(W - 1):] if W > 1 else full[:0]
        # the slab-cadence positions of this chunk (global phase W - 1)
        keep = torch.as_tensor((pos + np.arange(len(idx))) % W == W - 1,
                               device=device)
        o_parts.append(rm[keep])
        t_parts.append(tgt[keep])
        s = truth["sst"].sum(dim=0)
        sst_sum = s if sst_sum is None else sst_sum + s
        n_sst += truth["sst"].shape[0]
    return (torch.cat(o_parts), torch.cat(t_parts),
            sst_sum / max(n_sst, 1))


def _ckpt_mismatch(meta: dict, layout: RegionLayout, hyper: ESNHyper,
                   hybrid: bool) -> list:
    """What differs between a checkpoint's meta.json and this call."""
    diff = []
    if meta["n_classes"] != len(layout.classes):
        diff.append(f"n_classes {meta['n_classes']} (the call: "
                    f"{len(layout.classes)})")
    if meta["ml_only"] != (not hybrid):
        diff.append(f"ml_only {meta['ml_only']} (the call: {not hybrid})")
    want = dataclasses.asdict(hyper)
    for i in range(min(meta["n_classes"], len(layout.classes))):
        got = meta[f"hyper_{i}"]
        diff += [f"class {i} {k} {got.get(k)!r} (the call: {v!r})"
                 for k, v in want.items() if got.get(k) != v]
    return diff


def train_hybrid_production(gcm, layout: RegionLayout, source,
                            hyper: ESNHyper, seed: int, *,
                            ocean: bool = False, ocean_hyper=None,
                            hybrid: bool = True, hybrid_ocean: bool = False,
                            slab_stride: int = 28,
                            atmo_ckpt: str | None = None,
                            ocean_region_chunk: int = 32, device=None,
                            **kw) -> HybridAtmosphere:
    """Train every region class at production scale and assemble the
    hybrid atmosphere on `device` (default CUDA; raises without one).
    Class i draws from derive_seed(seed, i); keywords go to
    train_class_production (dtype defaults to the GCM's, the dtype the
    cycle runs in).

    atmo_ckpt: a directory for the trained atmosphere: saved there
    (data.checkpoint.save_hybrid, meta.json written last) once the
    classes are trained, and loaded instead of training when a complete
    checkpoint (one with meta.json) is there.  One whose n_classes,
    ml_only or hyperparameters differ from this call's raises ValueError
    naming what differs; a directory without meta.json is trained again
    and replaced.

    ocean: after the atmosphere (trained or loaded), each class's slab
    ocean from ocean_series_production and fit_ocean_class (ocean_hyper,
    default OCEAN_HYPER; class i from derive_seed(seed, 500 + i);
    slab_stride samples a slab step; ocean_region_chunk regions a Gram;
    the solve in the keywords' solve_dtype; hybrid_ocean: the hybrid slab
    readout), base_sst the mean SST of the series and sea_mask fmask_l >
    0.  The JAX package moved the atmosphere's packs to the host for the
    ocean stage (a 16 GB card); on the port's card they stay.  A dict
    under the keyword `timings` also collects the ocean stages' seconds
    (ocean_series, ocean_generate, ocean_accumulate, ocean_solve)."""
    from speedy_ml_tpu_torch.data.checkpoint import (load_hybrid, read_meta,
                                                     save_hybrid)
    device = resolve_device(device)
    kw.setdefault("dtype", gcm.dtype)
    if atmo_ckpt is not None and (Path(atmo_ckpt) / "meta.json").exists():
        diff = _ckpt_mismatch(read_meta(atmo_ckpt), layout, hyper, hybrid)
        if diff:
            raise ValueError(f"the checkpoint at {atmo_ckpt} was trained "
                             f"otherwise: " + "; ".join(diff))
        hyb = load_hybrid(gcm, layout, atmo_ckpt, dtype=kw["dtype"],
                          device=device)
    else:
        packs = [train_class_production(layout, cls, source, hyper,
                                        derive_seed(seed, i), gcm.geom.nlev,
                                        hybrid=hybrid, device=device, **kw)
                 for i, cls in enumerate(layout.classes)]
        hyb = HybridAtmosphere(gcm, layout, packs, ml_only=not hybrid,
                               device=device)
        if atmo_ckpt is not None:
            save_hybrid(hyb, atmo_ckpt)
    if not ocean:
        return hyb
    nz, dtype, timings = gcm.geom.nlev, kw["dtype"], kw.get("timings")
    ocean_hyper = ocean_hyper or OCEAN_HYPER
    ocean_packs, base_sst = [], None
    for i, (cls, p) in enumerate(zip(layout.classes, hyb.packs)):
        o_series, target, mean_sst = timed(
            timings, "ocean_series", device,
            lambda: ocean_series_production(
                layout, cls, p.std, source, nz, slab_stride=slab_stride,
                stride=kw.get("stride", 1),
                time_chunk=max(kw.get("time_chunk", 128), 128),
                precip_eps=kw.get("precip_eps", 0.001), dtype=dtype,
                device=device))
        ocean_packs.append(fit_ocean_class(
            cls, o_series, target, p, ocean_hyper,
            derive_seed(seed, 500 + i), nz, dtype=dtype,
            topology=kw.get("topology", "shift"), hybrid_ocean=hybrid_ocean,
            region_chunk=ocean_region_chunk,
            solve_dtype=kw.get("solve_dtype"), timings=timings,
            device=device))
        if i == 0:
            base_sst = mean_sst.to(dtype)
    return HybridAtmosphere(gcm, layout, hyb.packs, ml_only=not hybrid,
                            ocean_packs=ocean_packs, base_sst=base_sst,
                            sea_mask=gcm.bd.fmask_l.to(device) > 0.0,
                            device=device)

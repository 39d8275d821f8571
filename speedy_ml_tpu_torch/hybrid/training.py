"""Hybrid training: from gridded truth + imperfect-model series to
trained per-region reservoirs (the in-memory trainer), and the
self-contained training data (a nature run of the GCM plus 6-h forecasts
of the imperfect model).

Reference flow: train_reservoir/get_training_data (mod_reservoir.f90:
212-601), as the JAX package's hybrid/training.py ports it.  Data are
dicts of tensors (numpy arrays are taken too):

  truth: atmo   (T, 4, K, lat, lon)   T,u,v,q truth every `timestep` h
         logp, precip (physical, log-transformed here), sst, tisr
                (T, lat, lon)
  model: atmo/logp — the imperfect model's forecast VALID at sample t
         (launched from t-1), like the reference's restart_6hour files.

Noise: sample t of sub-series s draws one (Rc, I) standard-normal block
for the whole class from a torch.Generator on the device seeded from
(class seed, 99, s, t) (class_noise); the production trainer slices it
to its region chunk, so the draws do not depend on the chunking.  Targets
stay clean.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.esn.domain import (RegionLayout, band,
                                            build_layout, is_bottom,
                                            vert_specs)
from speedy_ml_tpu_torch.esn.reservoir import (BatchedReservoir, ESNHyper,
                                               generate, radius_by_lat)
from speedy_ml_tpu_torch.esn.standardize import (Standardizer,
                                                 component_expansion,
                                                 compute_standardizer,
                                                 core_component_map,
                                                 n_components)
from speedy_ml_tpu_torch.esn.ocean import (OCEAN_HYPER, ocean_index_map,
                                           ocean_target_slice, rolling_mean,
                                           sst_core_from_input)
from speedy_ml_tpu_torch.esn.train import (accumulate_batches,
                                           discard_transient,
                                           find_closest_divisor, solve_wout,
                                           train_subseries)
from speedy_ml_tpu_torch.hybrid.build import derive_seed
from speedy_ml_tpu_torch.hybrid.model import (ClassPack, HybridAtmosphere,
                                              OceanPack)
from speedy_ml_tpu_torch.physics.constants import SOLC
from speedy_ml_tpu_torch.physics.radiation import solar_flux_traced

NVAR = 4


def class_noise(seed: int, s: int, shape: tuple, dtype, device,
                rows: slice = slice(None)):
    """noise(t): the standard-normal block `shape` (Rc, I) of sample t of
    sub-series s, drawn for the whole class from a device generator
    seeded from (seed, 99, s, t), then cut to `rows`."""
    def draw(t: int) -> torch.Tensor:
        gen = torch.Generator(device=device)
        gen.manual_seed(derive_seed(seed, 99, s, t))
        return torch.randn(shape, generator=gen, dtype=dtype,
                           device=device)[rows]
    return draw


def precip_noise_info(std: Standardizer, lay_in, nz: int, precip_eps: float,
                      rows: slice = slice(None)) -> Optional[dict]:
    """The precip block's slice and component scalars for apply_noise, or
    None when the input vector has no precip block."""
    if lay_in.precip is None:
        return None
    pm = NVAR * nz + 1          # component index of precip
    return dict(slice=lay_in.precip, mean=std.comp_mean[rows, pm:pm + 1],
                std=std.comp_std[rows, pm:pm + 1], eps=precip_eps)


def as_tensors(d: dict, device=None, dtype=None) -> dict:
    """A dict of arrays as tensors (numpy arrays copied), optionally moved."""
    return {k: torch.as_tensor(v).to(device=device, dtype=dtype)
            for k, v in d.items()}


def log_precip_transform(precip: torch.Tensor, eps: float = 0.001
                         ) -> torch.Tensor:
    """log(1 + P/eps) (get_training_data, mod_reservoir.f90:363-494)."""
    return torch.log(1.0 + torch.clamp(precip, min=0.0) / eps)


def pack_class_series(layout: RegionLayout, cls, truth: dict,
                      precip_eps: float = 0.001, zspec=None) -> torch.Tensor:
    """Packed input series (T, Rc, I) for one region class.

    zspec (VertSpec): vertical-localization group; the atmo levels of its
    input window, and among the 2-D blocks only TISR unless it is a
    bottom group (res_domain.f90:206-256, mod_reservoir.f90:1790-1811).
    None: the full column (bottom)."""
    truth = as_tensors(truth)
    b = is_bottom(zspec)
    lo, hi = band(zspec, truth["atmo"].shape[2], core=False)
    return torch.stack([layout.pack_vector(
        cls, truth["atmo"][t][:, lo:hi],
        logp=truth["logp"][t] if b else None,
        precip=(log_precip_transform(truth["precip"][t], precip_eps)
                if b else None),
        sst=truth["sst"][t] if b else None, tisr=truth["tisr"][t])
        for t in range(truth["atmo"].shape[0])])


def pack_class_model_series(layout: RegionLayout, cls, model: dict,
                            zspec=None) -> torch.Tensor:
    """Packed imperfect-model core series (T, Rc, S): atmo + logp (logp
    only for a bottom vertical group; the atmo of the group's core)."""
    model = as_tensors(model)
    b = is_bottom(zspec)
    lo, hi = band(zspec, model["atmo"].shape[2], core=True)
    return torch.stack([layout.pack_vector(
        cls, model["atmo"][t][:, lo:hi], logp=model["logp"][t] if b else None,
        core_only=True) for t in range(model["atmo"].shape[0])])


def class_blocks(zspec=None) -> dict:
    """Which 2-D blocks a vertical group carries (input side)."""
    bottom = zspec is None or zspec.bottom
    return dict(logp=bottom, precip=bottom, sst=bottom, tisr=True)


def group_levels(nz: int, zspec=None) -> tuple:
    """(nz_in, nz_core, z_off) of a vertical group (the full column for
    None)."""
    if zspec is None:
        return nz, nz, 0
    return zspec.nz_in, zspec.nz_core, zspec.z_off


def class_standardizer(layout: RegionLayout, cls, series: torch.Tensor,
                       nz: int, zspec=None) -> Standardizer:
    xi, yi = cls.input_shape
    xc, yc = cls.core_shape
    b = class_blocks(zspec)
    nz_in, nz_core, z_off = group_levels(nz, zspec)
    comp_in = component_expansion(xi, yi, NVAR, nz_in, **b)
    comp_out = core_component_map(xc, yc, NVAR, nz_in, nz_core, z_off,
                                  logp=b["logp"], precip=b["precip"])
    return compute_standardizer(series, comp_in, comp_out,
                                n_components(NVAR, nz_in, **b),
                                nvar_nz=(NVAR, nz_in))


def train_class(layout: RegionLayout, cls, truth: dict, model: Optional[dict],
                hyper: ESNHyper, seed: int, nz: int, *,
                n_discard: int = 10, n_batches: int = 20,
                precip_eps: float = 0.001, dtype=torch.float32,
                topology: str = "shift", zspec=None,
                region_chunk: Optional[int] = None, solve_dtype=None,
                device=None) -> ClassPack:
    """Train all reservoirs of one class in memory (train_reservoir
    equivalent) on `device` (default CUDA; raises without one).

    zspec: vertical-localization group (None = full column).  The port's
    two knobs beside the JAX options, which leave its result as it is at
    their defaults: region_chunk accumulates and solves the normal
    equations that many regions at a time (each region's equations are
    its own, and the noise is drawn for the whole class and cut to the
    chunk, so the result does not depend on it; a class's whole Gram at
    full width is (Rc, A, A), 150 GB for the interior class in float32);
    solve_dtype the precision of the ridge solve (default the Gram's, as
    the JAX train_class solves)."""
    device = resolve_device(device)
    series = pack_class_series(layout, cls, as_tensors(truth, device),
                               precip_eps, zspec=zspec).to(dtype)
    T, Rc, I = series.shape
    std = class_standardizer(layout, cls, series, nz, zspec=zspec)
    z_in = std.standardize_input(series)
    b = class_blocks(zspec)
    nz_in, nz_core, z_off = group_levels(nz, zspec)
    target = layout.input_to_target(
        cls, z_in.reshape(T * Rc, I), NVAR, nz_in, nz_core, z_off,
        **b).reshape(T, Rc, -1)
    z_model = None
    if model is not None:
        mser = pack_class_model_series(layout, cls, as_tensors(model, device),
                                       zspec=zspec).to(dtype)
        S = mser.shape[2]
        z_model = (mser - std.out_mean[None, :, :S]) / std.out_std[None, :, :S]

    radius = radius_by_lat(layout.lat_start[cls.region_ids],
                           layout.lat_end[cls.region_ids])
    cols, vals, win, shifts = generate(seed, Rc, I, hyper, radius,
                                       dtype=dtype, topology=topology,
                                       device=device)
    n = vals.shape[2]
    S = 0 if z_model is None else z_model.shape[2]
    res = BatchedReservoir(cols=cols, vals=vals, win_vals=win, n_in=I,
                           wout=torch.zeros((Rc, target.shape[2], S + n),
                                            dtype=dtype, device=device),
                           mean=std.in_mean, std=std.in_std, shifts=shifts)
    L = T - n_discard
    batch_size = find_closest_divisor(max(1, L // n_batches), L)
    lay_in = build_layout(*cls.input_shape, NVAR, nz_in, **b)
    chunk = Rc if region_chunk is None else max(1, int(region_chunk))
    parts = []
    for r0 in range(0, Rc, chunk):
        rows = slice(r0, min(r0 + chunk, Rc))
        cut = lambda t: None if t is None else t[:, rows].contiguous()
        res_ch = res if chunk >= Rc else dataclasses.replace(
            res, vals=res.vals[:, rows].contiguous(),
            win_vals=res.win_vals[rows].contiguous(),
            cols=res.cols if res.cols.dim() == 2
            else res.cols[rows].contiguous(),
            wout=res.wout[rows], mean=res.mean[rows], std=res.std[rows])
        noise = (class_noise(seed, 0, (Rc, I), dtype, device, rows)
                 if hyper.noise_mag > 0 else None)
        eq, _ = train_subseries(
            res_ch, hyper, cut(z_in), cut(target), cut(z_model), n_discard,
            batch_size, noise=noise,
            precip_info=precip_noise_info(std, lay_in, nz_in, precip_eps,
                                          rows))
        parts.append(solve_wout(eq, hyper, S, solve_dtype))
        del eq
    res = dataclasses.replace(res, wout=torch.cat(parts))
    return ClassPack(cls=cls, res=res, hyper=hyper, std=std, zspec=zspec)


def timed(timings: Optional[dict], key: str, device, fn):
    """fn(), its wall seconds added to timings[key] (the device
    synchronized on both sides) when timings is a dict."""
    if timings is None:
        return fn()
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
    return out


def fit_ocean_class(cls, o_series, target, atmo_pack, hyper, seed: int,
                    nz: int, *, n_discard: int = 2, dtype=torch.float32,
                    topology: str = "shift", hybrid_ocean: bool = False,
                    region_chunk: int = 32, solve_dtype=None,
                    timings: Optional[dict] = None,
                    device=None) -> OceanPack:
    """Generate and ridge-fit the slab reservoirs of one class from
    prepared (T_slab, Rc, I_o) inputs and (T_slab, Rc, O) SST targets, on
    `device` (default CUDA; raises without one).

    One batch of the T_slab - n_discard paired samples
    (train_slab_ocean_model:1331), region_chunk regions at a time: each
    chunk's Gram (region_chunk, A, A) is accumulated by K14 and solved
    (solve_dtype: the solve's precision, default the Gram's).
    hybrid_ocean: the readout also sees the previous slab step's SST core
    as a local-model block (predict_slab,
    mod_slab_ocean_reservoir.f90:1201-1249); its training stand-in is the
    lagged truth SST (persistence).  mean_sst and std_sst: the atmosphere
    standardizer's SST component.  timings: a dict that collects wall
    seconds of the stages ocean_generate, ocean_accumulate, ocean_solve."""
    device = resolve_device(device)
    o_series = torch.as_tensor(o_series).to(device=device, dtype=dtype)
    target = torch.as_tensor(target).to(device=device, dtype=dtype)
    T_slab, Rc, I_o = o_series.shape
    # initialize_slab_ocean_model:31
    cols, vals, win, shifts = timed(
        timings, "ocean_generate", device,
        lambda: generate(seed, Rc, I_o, hyper, np.full(Rc, 0.9), dtype=dtype,
                         topology=topology, device=device))
    n = vals.shape[2]
    O = target.shape[2]
    S_o = O if hybrid_ocean else 0
    kw = dict(dtype=dtype, device=device)
    res = BatchedReservoir(cols=cols, vals=vals, win_vals=win, n_in=I_o,
                           wout=torch.zeros((Rc, O, S_o + n), **kw),
                           mean=torch.zeros((Rc, I_o), **kw),
                           std=torch.ones((Rc, I_o), **kw), shifts=shifts)
    # model_in[k]: the SST core one slab step before target[k]
    model_in = (torch.cat([target[:1], target[:-1]])
                if hybrid_ocean else None)
    L = T_slab - n_discard
    batch_size = max(1, L - 1)
    parts = []
    for r0 in range(0, Rc, region_chunk):
        r1 = min(r0 + region_chunk, Rc)
        res_ch = dataclasses.replace(
            res, vals=res.vals[:, r0:r1].contiguous(),
            win_vals=res.win_vals[r0:r1].contiguous(),
            cols=res.cols if res.cols.dim() == 2
            else res.cols[r0:r1].contiguous(),
            wout=res.wout[r0:r1], mean=res.mean[r0:r1], std=res.std[r0:r1])
        cut = lambda t: None if t is None else t[:, r0:r1].contiguous()

        def accumulate():
            x0 = discard_transient(res_ch, hyper, cut(o_series[:n_discard]))
            return accumulate_batches(
                res_ch, hyper, cut(o_series[n_discard:]),
                cut(target[n_discard:]),
                None if model_in is None else cut(model_in[n_discard:]), x0,
                batch_size)[0]

        eq = timed(timings, "ocean_accumulate", device, accumulate)
        parts.append(timed(timings, "ocean_solve", device,
                           lambda: solve_wout(eq, hyper, S_o, solve_dtype)))
        del eq
    res = dataclasses.replace(res, wout=torch.cat(parts))
    sst_comp = NVAR * nz + 2   # components: atmo (4 nz), logp, precip, sst
    std = atmo_pack.std
    return OceanPack(
        cls=cls, res=res, hyper=hyper, idx_map=ocean_index_map(cls, nz),
        mean_sst=std.comp_mean[:, sst_comp:sst_comp + 1].contiguous(),
        std_sst=std.comp_std[:, sst_comp:sst_comp + 1].contiguous(),
        hybrid_readout=hybrid_ocean)


def ocean_series(cls, z_in: torch.Tensor, nz: int, slab_stride: int):
    """The slab inputs and targets of a class's standardized atmo input
    series z_in (T, Rc, I): the trailing slab_stride-sample rolling means
    of the ocean inputs, and the SST core, at the slab cadence (samples
    slab_stride - 1, 2 slab_stride - 1, ...)."""
    idx = torch.as_tensor(ocean_index_map(cls, nz), dtype=torch.long,
                          device=z_in.device)
    o_series = rolling_mean(z_in[:, :, idx], slab_stride)
    o_series = o_series[slab_stride - 1::slab_stride]   # (T_slab, Rc, I_o)
    sl = ocean_target_slice(cls, nz)
    sst_block = z_in[slab_stride - 1::slab_stride][:, :, sl[0]:sl[1]]
    T_slab, Rc, _ = o_series.shape
    target = sst_core_from_input(
        cls, sst_block.reshape(T_slab * Rc, -1)).reshape(T_slab, Rc, -1)
    return o_series, target


def train_ocean_class(layout: RegionLayout, cls, atmo_pack, hyper,
                      seed: int, nz: int, *, slab_stride: int = 28,
                      n_discard: int = 2, dtype=torch.float32,
                      truth: dict = None, precip_eps: float = 0.001,
                      topology: str = "shift", hybrid_ocean: bool = False,
                      device=None) -> OceanPack:
    """Train the slab-ocean reservoirs of one class in memory
    (train_slab_ocean_model / get_training_data_from_atmo,
    mod_slab_ocean_reservoir.f90:173-376), on `device` (default CUDA).

    Inputs: the atmo-standardized vectors through the ocean index map,
    slab_stride-rolling-averaged and strided to the slab step; target: the
    one-slab-step-ahead SST core."""
    device = resolve_device(device)
    series = pack_class_series(layout, cls, as_tensors(truth, device),
                               precip_eps).to(dtype)
    z_in = atmo_pack.std.standardize_input(series)
    o_series, target = ocean_series(cls, z_in, nz, slab_stride)
    return fit_ocean_class(cls, o_series, target, atmo_pack, hyper, seed, nz,
                           n_discard=n_discard, dtype=dtype,
                           topology=topology, hybrid_ocean=hybrid_ocean,
                           device=device)


def train_hybrid(gcm, layout: RegionLayout, truth: dict,
                 model: Optional[dict], hyper: ESNHyper, seed: int,
                 ocean: bool = False, ocean_hyper=None,
                 hybrid_ocean: bool = False, num_vert_levels: int = 1,
                 vert_overlap: int = 0, device=None,
                 **kw) -> HybridAtmosphere:
    """Train every region class in memory and assemble the hybrid
    atmosphere; class i draws from derive_seed(seed, 16 i).  With ocean,
    each class's slab ocean too (ocean_hyper, default OCEAN_HYPER; class i
    from derive_seed(seed, 500 + i); hybrid_ocean: the hybrid slab
    readout), the land fill base_sst (the truth's mean SST) and sea_mask
    (fmask_l > 0).  num_vert_levels > 1 enables vertical localization:
    each class trains one pack per vertical group (vert_specs(nz,
    num_vert_levels, vert_overlap), res_domain.f90:206-256), class i's
    group g from derive_seed(seed, 16 i + g), the packs in class-major,
    group-minor order; only bottom groups carry the surface blocks.  With
    one group vert_overlap has no effect, as in the JAX package, and the
    slab ocean with vertical groups raises, as there.  kw goes to
    train_class (its region_chunk and solve_dtype included)."""
    nz = gcm.geom.nlev if gcm is not None else None
    if num_vert_levels > 1:
        if ocean:
            raise NotImplementedError(
                "slab ocean with vertical localization is not wired; the "
                "reference's production config uses num_vert_levels=1")
        specs = vert_specs(nz, num_vert_levels, vert_overlap)
    else:
        specs = [None]
    device = resolve_device(device)
    packs = [train_class(layout, cls, truth, model, hyper,
                         derive_seed(seed, i * 16 + gi), nz, zspec=zs,
                         device=device, **kw)
             for i, cls in enumerate(layout.classes)
             for gi, zs in enumerate(specs)]
    ocean_packs = base_sst = sea_mask = None
    if ocean:
        ocean_hyper = ocean_hyper or OCEAN_HYPER
        dtype = kw.get("dtype", torch.float32)
        ocean_packs = [train_ocean_class(
            layout, cls, p, ocean_hyper, derive_seed(seed, 500 + i), nz,
            truth=truth, dtype=dtype, topology=kw.get("topology", "shift"),
            hybrid_ocean=hybrid_ocean, device=device)
            for i, (cls, p) in enumerate(zip(layout.classes, packs))]
        # land points of the ML SST grid get the training period's mean SST
        # (base_sst_grid, initialize_prediction:845-885); the mask: land
        # where the boundary land fraction is above 0
        base_sst = as_tensors({"sst": truth["sst"]}, device)["sst"] \
            .mean(dim=0).to(dtype)
        sea_mask = gcm.bd.fmask_l.to(device) > 0.0
    return HybridAtmosphere(gcm, layout, packs, ml_only=model is None,
                            ocean_packs=ocean_packs, base_sst=base_sst,
                            sea_mask=sea_mask, device=device)


# ----------------------------------------------------------------------
# self-contained data generation ("nature run" mode)
# ----------------------------------------------------------------------

def generate_nature_run(gcm, date0, n_samples: int, timestep_hours: int = 6,
                        spinup_days: int = 5):
    """Run the GCM as truth, saving grids every `timestep_hours`, on the
    GCM's device.

    Returns (truth dict of tensors (see the module docstring), the GCM
    state after each day of windows, the sample dates).  The spin-up
    (spinup_days, after stepone) runs GCM.run_days, the day loop with the
    slab coupler."""
    state, forcing = gcm.init_state(date0)
    date = date0
    state = gcm.stepone(state, forcing)
    state, date = gcm.run_days(state, date, spinup_days)
    steps = gcm.nsteps_day * timestep_hours // 24
    windows_per_day = 24 // timestep_hours

    def extract(s, pre_precip):
        # the window's exit: K15's physics stack, K6 and K20
        atmo, logp, _ = gcm.grid_state(s.spectral)
        precip = (s.fluxes.precip - pre_precip) / (timestep_hours * 3600.0)
        return dict(atmo=atmo, logp=logp, precip=precip, sst=s.sfc.sst_am)

    samples, snaps, dates = [], [], []
    while len(samples) < n_samples:
        # one forcing per day (the reference's daily fordate); the whole
        # day runs, as in the JAX package, so the snapshots agree
        forcing = gcm.forcing_for(state.sfc, date.tyear)
        take = min(windows_per_day, n_samples - len(samples))
        for w in range(windows_per_day):
            pre = state.fluxes.precip
            state = gcm.run_window(state, forcing, steps)
            if w < take:
                samples.append(extract(state, pre))
                dates.append(date.advance_hours(w * timestep_hours))
        snaps.append(state)
        date = date.advance_hours(take * timestep_hours)
    truth = {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
    truth["tisr"] = torch.stack([_tisr(gcm, d.tyear) for d in dates])
    return truth, snaps, dates


def _tisr(gcm, tyear) -> torch.Tensor:
    """Daily-mean TISR (lat, lon): the Hartmann insolation in float64 on
    the host, rounded to float32 as the JAX package stores it, on the
    GCM's device in its dtype."""
    g = gcm.geom
    f64 = torch.float64
    row = solar_flux_traced(float(tyear), 4.0 * SOLC,
                            torch.as_tensor(g.sin_lat, dtype=f64),
                            torch.as_tensor(g.cos_lat, dtype=f64))
    row = row.to(torch.float32).to(device=gcm.device, dtype=gcm.dtype)
    return row[:, None].expand(g.nlat, g.nlon).contiguous()


def make_imperfect_forecasts(hyb_gcm, truth: dict, dates,
                             timestep_hours: int = 6) -> dict:
    """6-h forecasts of the (imperfect) GCM launched from each truth state.

    Mirrors the reference's SPEEDY restart_6hour training inputs
    (read_model_states, speedy_res_interface.f90:634-720): forecast i is
    valid at sample i, launched from truth sample i-1 through the cycle's
    own inject_to_speedy and speedy_window.  The first entry repeats truth
    (never used as a target pair).  One window at a time; each window's
    month index, month fraction and year fraction are host numbers that
    become device fills, as in the cycle."""
    hyb = HybridAtmosphere.__new__(HybridAtmosphere)
    hyb.gcm = hyb_gcm
    hyb.device = hyb_gcm.device
    hyb.nz = hyb_gcm.geom.nlev
    hyb.gcm_steps = hyb_gcm.nsteps_day * timestep_hours // 24
    truth = as_tensors({k: truth[k] for k in ("atmo", "logp", "sst")},
                     hyb_gcm.device, hyb_gcm.dtype)
    fc_atmo, fc_logp = [truth["atmo"][0]], [truth["logp"][0]]
    for i in range(1, truth["atmo"].shape[0]):
        d = dates[i - 1]
        spec, _ = hyb.inject_to_speedy(truth["atmo"][i - 1],
                                       truth["logp"][i - 1])
        fa, fl, _ = hyb.speedy_window(spec, truth["sst"][i - 1],
                                      d.month - 1, d.tmonth, d.tyear)
        fc_atmo.append(fa)
        fc_logp.append(fl)
    return dict(atmo=torch.stack(fc_atmo), logp=torch.stack(fc_logp))

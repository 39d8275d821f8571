"""Typed run configuration.

Replaces the reference's configuration sprawl (compile-time constants in
initialize_model_parameters, config.sh env vars, sed source rewriting,
the fort.2 namelist, and the written controller file) with one dataclass
that serializes to JSON.  Defaults reproduce the reference's production
configuration (mod_reservoir.f90:12-75).  The fields, defaults and JSON
are the JAX package's: a config.json written by either package loads in
the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch

from speedy_ml_tpu_torch.esn.reservoir import ESNHyper


@dataclasses.dataclass
class RunConfig:
    # --- geometry ---
    trunc: int = 30
    nlon: int = 96
    nlat: int = 48
    nlev: int = 8
    n_regions: int = 1152
    overlap: int = 1
    num_vert_levels: int = 1
    vert_overlap: int = 0

    # --- hybrid cycle ---
    timestep_hours: int = 6            # model_parameters%timestep
    timestep_slab_hours: int = 168     # model_parameters%timestep_slab
    ml_only: bool = False
    slab_ocean: bool = True            # slab_ocean_model_bool
    # hybrid slab readout (predict_slab) vs ml-only slab (predict_slab_ml);
    # reference default ml_only_ocean=.True. (mod_slab_ocean_reservoir.f90:26)
    hybrid_ocean: bool = False
    precip: bool = True                # precip_bool
    precip_epsilon: float = 0.001

    # --- training lengths (hours; mod_reservoir.f90:32-35) ---
    discard_hours: int = 240
    training_hours: int = 227760 - 240
    sync_hours: int = 24 * 14
    prediction_hours: int = 8760 * 20
    n_batches: int = 20
    n_subseries: Optional[int] = None  # default: timestep_hours (strided)

    # --- reservoirs ---
    atmo: ESNHyper = dataclasses.field(default_factory=ESNHyper)
    ocean: ESNHyper = dataclasses.field(default_factory=lambda: ESNHyper(
        m=4000, sigma=0.6, beta_res=1e-4, noise_mag=0.10, using_prior=False))

    # --- numerics ---
    dtype: str = "float32"
    nsteps_day: int = 96

    # --- data/paths ---
    # first calendar year of the training data (the ERA year-file epoch;
    # iyear0 in the reference's mod_tsteps)
    start_year: int = 1990
    bc_path: Optional[str] = None
    era_path: Optional[str] = None
    # precomputed SPEEDY forecast-state year-files (read_model_states,
    # speedy_res_interface.f90:634-720); default: alongside era_path
    model_states_path: Optional[str] = None
    output_path: str = "./output"
    checkpoint_path: str = "./checkpoints"

    # --- misc (reference parity) ---
    sst_bias: float = 0.0
    train_on_sst_anomalies: bool = False
    seed: int = 33                     # init_random_marker(33)
    sppt_on: bool = False              # mod_tsteps.f90:68
    # eddy-KE growth-rate limiter (cgrate, dyn_step.f90:192-276); the
    # reference ships it uncalled, so default off
    cgrate_on: bool = False
    # coupling flags (mod_cpl_flags.f90): defaults = the reference's
    # production setting; see physics.land_sea.CplFlags for the modes
    icland: int = 1
    icsea: int = 0
    icice: int = 1
    isstan: int = 0
    # regional sea-model domains (cls_insea.h l_* flags); any of
    # globe/northe/natlan/npacif/tropic/indian
    sea_domains: tuple = ("globe",)
    # persist slab land/ice anomalies across 6-h cycles with a daily
    # coupler exchange — ON by default to match the reference, which
    # always carries them through restarts via fluxes.grd
    # (mod_cpl_land_model.f90:85-126); set False for the stateless
    # re-init-from-climatology behavior
    persist_surface: bool = True
    # write v_p/v_ml readout-contribution streams (outvec_component_contribs)
    emit_components: bool = False
    # reservoir graph family: "shift" (the ring ensemble) or
    # "random" (the reference's makesparse permutation graphs)
    topology: str = "shift"

    def save(self, path: str):
        d = dataclasses.asdict(self)
        with open(path, "w") as f:
            json.dump(d, f, indent=1)

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path) as f:
            d = json.load(f)
        d["atmo"] = ESNHyper(**d["atmo"])
        d["ocean"] = ESNHyper(**d["ocean"])
        # JSON has no tuple: the field's own type again
        d["sea_domains"] = tuple(d["sea_domains"])
        return cls(**d)

    def geometry(self):
        from speedy_ml_tpu_torch.core.geometry import Geometry
        return Geometry(trunc=self.trunc, nlon=self.nlon, nlat=self.nlat,
                        nlev=self.nlev)

    def torch_dtype(self) -> torch.dtype:
        """The torch dtype named by `dtype` ("float32", "float64", ...)."""
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"dtype {self.dtype!r} names no torch dtype")
        return dt

    def build_gcm(self, bd=None, *, device=None):
        """The configured GCM on `device` (default CUDA; raises without
        one)."""
        from speedy_ml_tpu_torch import resolve_device
        from speedy_ml_tpu_torch.gcm import GCM
        from speedy_ml_tpu_torch.physics.land_sea import CplFlags
        device = resolve_device(device)
        geom = self.geometry()
        dtype = self.torch_dtype()
        if bd is None:
            # real fort.2x climatology when it matches the grid, else the
            # synthetic aquaplanet (non-T30 geometries have no data files)
            from speedy_ml_tpu_torch.physics.boundaries import (
                load_boundary_data, synthetic_boundary_data)
            kw = dict(dtype=dtype, device=device)
            # fort.2x files exist only at the reference's 96x48 grid; a
            # smaller grid that happens to divide the record size would
            # silently read garbage, so gate on the geometry
            if self.bc_path:
                # explicitly configured path: load errors are the user's
                # bug (a typo must not silently train on the aquaplanet)
                bd = load_boundary_data(geom, path=self.bc_path, **kw)
            elif (geom.nlon, geom.nlat) == (96, 48):
                try:
                    bd = load_boundary_data(geom, path=self.bc_path, **kw)
                except (FileNotFoundError, OSError, ValueError):
                    bd = synthetic_boundary_data(geom, **kw)
            else:
                bd = synthetic_boundary_data(geom, **kw)
        flags = CplFlags(icland=self.icland, icsea=self.icsea,
                         icice=self.icice, isstan=self.isstan,
                         sea_domains=tuple(self.sea_domains))
        return GCM(geom, dtype=dtype, bc_path=self.bc_path,
                   nsteps_day=self.nsteps_day, bd=bd, sppt_on=self.sppt_on,
                   cpl_flags=flags, cgrate_on=self.cgrate_on, device=device)

    def build_layout(self):
        from speedy_ml_tpu_torch.esn.domain import RegionLayout
        return RegionLayout(self.geometry(), n_regions=self.n_regions,
                            overlap=self.overlap)

"""The hybrid atmosphere: per-region ESNs on the global grid.

Reference: the per-timestep cycle of parallelmain.f90:206-272 +
mpires.f90 sendrecievegrid (218-780).  This slice runs the ML-only cycle
(RunConfig.ml_only, the reference's predict_ml mode): every region's ESN
steps and reads out (predict_all), the cores assemble into the global
grid with the q/precip clamps (assemble_global), and the halo windows
gather back out as the next step's standardized feedback
(build_feedback).  Each of those is one hand-written kernel launch per
class or per cycle (kernels/).  The SPEEDY half of the coupled cycle
(inject_to_speedy, speedy_window, build_local_model, the safety gate)
comes with the SPEEDY slice.

Layouts follow the JAX package: fields (V, K, lat, lon), class vectors
(Rc, I) / (Rc, O), and the same packing order, so both compute the same
cycle from the same parameters.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.esn.domain import RegionClass, RegionLayout
from speedy_ml_tpu_torch.esn.reservoir import (BatchedReservoir, ESNHyper,
                                               esn_step)
from speedy_ml_tpu_torch.esn.standardize import Standardizer
from speedy_ml_tpu_torch.kernels.core_scatter import core_scatter
from speedy_ml_tpu_torch.kernels.readout import readout
from speedy_ml_tpu_torch.kernels.window_gather import window_gather
from speedy_ml_tpu_torch.physics.constants import SOLC
from speedy_ml_tpu_torch.physics.radiation import solar_flux_traced

SPEEDY_SLICE = "the SPEEDY slice of the port (spectral transform, dycore, " \
    "physics, gcm.py and the coupling steps)"
OPTIONS_SLICE = "a later slice of the port (cycle options: slab ocean, " \
    "persistent surface, climatology tables, components, vertical " \
    "localization, sharding)"


@dataclasses.dataclass(frozen=True)
class ClassState:
    """Dynamic per-class ESN state."""
    x: torch.Tensor            # (Rc, n) reservoir state
    feedback: torch.Tensor     # (Rc, I) standardized input for the next step
    local_model: torch.Tensor  # (Rc, S) standardized SPEEDY forecast


@dataclasses.dataclass(frozen=True)
class HybridState:
    classes: tuple             # tuple[ClassState, ...]
    sst_grid: torch.Tensor     # (lat, lon) current SST seen by the ESNs
    # SPEEDY safety gate.  The ML-only cycle runs no gate, so it stays a
    # host True and reading it costs no device sync; the coupled cycle
    # will carry a 0-d bool tensor here
    safe: bool | torch.Tensor
    step: int                  # cycle counter (host-side)
    ocean: tuple = ()          # slab-ocean states (later slice)
    sfc: object = None         # persistent surface (later slice)
    fluxes: object = None


class ClassPack(NamedTuple):
    """Per-class bundle: reservoir weights + geometry + scaling.

    `cls`, `hyper` and `zspec` are static; `res` and `std` are the
    parameters (HybridAtmosphere.params).  zspec: vertical-localization
    group, None for the full column (the only form in this slice)."""
    cls: RegionClass
    res: BatchedReservoir
    hyper: ESNHyper
    std: Standardizer
    zspec: object = None

    @property
    def bottom(self):
        return self.zspec is None or self.zspec.bottom


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


class HybridAtmosphere:
    """Hybrid cycle driver (ML-only cycle in this slice)."""

    NVAR = 4  # T, u, v, q

    def __init__(self, gcm, layout: RegionLayout, packs: list[ClassPack],
                 ml_only: bool = False, ocean_packs=None, base_sst=None,
                 sea_mask=None, *, device=None):
        """gcm may be None when ml_only: geometry then comes from
        layout.geom and the dtype from the packs.  device: where the cycle
        runs (default CUDA; raises without one); the packs must be there."""
        if not ml_only:
            raise NotImplementedError(
                f"the coupled cycle (ml_only=False) comes with {SPEEDY_SLICE}")
        if ocean_packs:
            raise NotImplementedError(
                f"slab-ocean packs come with {OPTIONS_SLICE}")
        if base_sst is not None or sea_mask is not None:
            raise NotImplementedError(
                f"the ML-ocean land fill comes with {OPTIONS_SLICE}")
        device = resolve_device(device)
        for p in packs:
            if p.zspec is not None:
                raise NotImplementedError(
                    f"vertical-localization packs come with {OPTIONS_SLICE}")
            if not _on(p.res.vals, device):
                raise ValueError(f"pack {p.cls.name} lives on "
                                 f"{p.res.vals.device}, not on {device}")
        self.gcm = gcm
        self.layout = layout
        self.packs = list(packs)
        self.ml_only = ml_only
        # JAX-package switches a caller may set; the cycle raises on them
        self.emit_components = False
        self.persist_surface = False
        self.device = self.packs[0].res.vals.device
        self.geom = gcm.geom if gcm is not None else layout.geom
        self.dtype = gcm.dtype if gcm is not None \
            else self.packs[0].res.vals.dtype
        self.nz = self.geom.nlev

        # static index tables of the gather/scatter kernels, built once:
        # per pack its (Rc, I) pack_table, and the grid's core_source_table
        g = self.geom
        self.feedback_index = [torch.as_tensor(
            layout.pack_table(p.cls, self.NVAR, self.nz, logp=p.bottom,
                              precip=p.bottom, sst=p.bottom, tisr=True),
            device=self.device) for p in self.packs]
        self.core_table = torch.as_tensor(
            layout.core_source_table([p.cls for p in self.packs], self.NVAR,
                                     self.nz), device=self.device)
        self._slat = torch.as_tensor(g.sin_lat, dtype=self.dtype,
                                     device=self.device)
        self._clat = torch.as_tensor(g.cos_lat, dtype=self.dtype,
                                     device=self.device)

    def set_mesh(self, mesh, shard_gcm: bool = True):
        raise NotImplementedError(f"the sharded cycle comes with "
                                  f"{OPTIONS_SLICE}")

    def set_tisr_table(self, table, hours_per_entry: int = 1):
        raise NotImplementedError(f"TISR tables come with {OPTIONS_SLICE}")

    def set_sst_table(self, table):
        raise NotImplementedError(f"SST tables come with {OPTIONS_SLICE}")

    # ------------------------------------------------------------------

    def init_state(self, sst_grid) -> HybridState:
        cls_states = []
        kw = dict(dtype=self.dtype, device=self.device)
        for p in self.packs:
            Rc = p.cls.count
            cls_states.append(ClassState(
                x=torch.zeros((Rc, p.res.n), **kw),
                feedback=torch.zeros((Rc, p.res.n_inputs), **kw),
                local_model=torch.zeros((Rc, p.res.n_speedy), **kw)))
        return HybridState(classes=tuple(cls_states),
                           sst_grid=torch.as_tensor(sst_grid, **kw),
                           safe=True, step=0)

    # ------------------------------------------------------------------
    # pieces of the cycle
    # ------------------------------------------------------------------

    @property
    def params(self):
        """Model parameters: (atmo (res, std) tuple, ocean tuple)."""
        return (tuple((p.res, p.std) for p in self.packs), ())

    def cast_wout_bf16(self):
        """Store the readout weights in bfloat16 (in place on the packs).

        The readout is bound by the Wout read (3.6 GB in f32 at m=6000 x
        1,152 regions); bf16 halves it.  The readout kernel rounds the
        augmented state to bf16 and keeps an f32 sum."""
        self.packs = [p._replace(res=dataclasses.replace(
            p.res, wout=p.res.wout.to(torch.bfloat16)))
            for p in self.packs]
        return self

    def _with_params(self, params):
        atmo_p, ocean_p = params
        if ocean_p:
            raise NotImplementedError(
                f"slab-ocean parameters come with {OPTIONS_SLICE}")
        return [ClassPack(cls=p.cls, res=r, hyper=p.hyper, std=s,
                          zspec=p.zspec)
                for p, (r, s) in zip(self.packs, atmo_p)]

    def predict_all(self, packs, hstate: HybridState):
        """ESN step + readout for every region (predict/predict_ml,
        mod_reservoir.f90:1416-1533).  Returns (new xs, physical outvecs):
        the readout kernel applies unstandardize_output."""
        new_x = []
        outvecs = []
        for p, cs in zip(packs, hstate.classes):
            x = esn_step(p.res, cs.x, cs.feedback, p.hyper.leakage)
            lm = None if self.ml_only else cs.local_model
            outvecs.append(readout(p.res.wout, x, lm, p.std.out_mean,
                                   p.std.out_std))
            new_x.append(x)
        return new_x, outvecs

    def assemble_global(self, packs, outvecs):
        """Scatter region outputs into global grids + clamps
        (tile_full_grid_with_local_state_vec_res + mpires.f90:444-478):
        one core-scatter launch for all classes.  Returns (atmo, logp,
        precip)."""
        if len(packs) != len(self.packs):
            raise ValueError("assemble_global: one output per pack")
        g = self.geom
        return core_scatter(outvecs, self.core_table, self.NVAR, self.nz,
                            g.nlat, g.nlon)

    def build_feedback(self, packs, atmo, logp, precip, sst_grid, tisr_grid):
        """Per-class standardized feedback vectors (sendrecievegrid
        scatter + standardize, mpires.f90:561-750): one window-gather
        launch for all classes."""
        fields = tuple(f.contiguous() for f in
                       (atmo, logp, precip, sst_grid, tisr_grid))
        return window_gather(fields, self.feedback_index,
                             [p.std.in_mean for p in packs],
                             [p.std.in_std for p in packs])

    def tisr_field(self, tyear, hour_of_year=None, table=None,
                   hours_per_entry: int = 1):
        """TISR input field for the current date: the analytic Hartmann
        daily-mean insolation (the table branch comes with the cycle
        options)."""
        if table is not None:
            raise NotImplementedError(f"TISR tables come with {OPTIONS_SLICE}")
        g = self.geom
        if not torch.is_tensor(tyear):
            # a device fill, not a host->device copy: no sync per cycle
            tyear = torch.full((), float(tyear), dtype=self.dtype,
                               device=self.device)
        row = solar_flux_traced(tyear, 4.0 * SOLC, self._slat, self._clat)
        return row[:, None].expand(g.nlat, g.nlon)

    # ------------------------------------------------------------------

    def _check_options(self):
        if self.emit_components:
            raise NotImplementedError(
                f"emit_components comes with {OPTIONS_SLICE}")
        if self.persist_surface:
            raise NotImplementedError(
                f"persist_surface comes with {OPTIONS_SLICE}")

    def cycle_with_params(self, params, hstate: HybridState, imon, fmon,
                          tyear, hour_of_year=None, sst_bias=0.0) -> tuple:
        """One 6-h hybrid step with explicit parameters (the ml_only
        branches of the JAX _cycle_jit, hybrid/model.py:579-749).
        Returns (new_state, diagnostics dict)."""
        self._check_options()
        packs = self._with_params(params)
        new_x, outvecs = self.predict_all(packs, hstate)
        atmo, logp, precip = self.assemble_global(packs, outvecs)
        tisr = self.tisr_field(tyear, hour_of_year)
        feedbacks = self.build_feedback(packs, atmo, logp, precip,
                                        hstate.sst_grid, tisr)
        locals_ = [cs.local_model for cs in hstate.classes]
        classes = tuple(
            ClassState(x=x, feedback=fb, local_model=lm)
            for x, fb, lm in zip(new_x, feedbacks, locals_))
        new_state = HybridState(classes=classes, sst_grid=hstate.sst_grid,
                                safe=hstate.safe, step=hstate.step + 1,
                                ocean=hstate.ocean, sfc=hstate.sfc,
                                fluxes=hstate.fluxes)
        diag = dict(atmo=atmo, logp=logp, precip=precip,
                    speedy_atmo=None, speedy_logp=None)
        return new_state, diag

    def cycle(self, hstate: HybridState, imon, fmon, tyear,
              hour_of_year=None, sst_bias=0.0) -> tuple:
        """Convenience wrapper using this instance's stored parameters."""
        return self.cycle_with_params(self.params, hstate, imon, fmon,
                                      tyear, hour_of_year, sst_bias)

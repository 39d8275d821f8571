"""The hybrid atmosphere: per-region ESNs coupled to the spectral GCM.

Reference: the per-timestep cycle of parallelmain.f90:206-272 +
mpires.f90 sendrecievegrid/run_model (218-780, 1516-1628) + the
iogrid(30)/(31) bridge (ppo_iogrid.f90:497-601).  Every region's ESN
steps and reads out (predict_all), the readout storing each core
straight into the global grid with the q/precip clamps (assemble_global
returns its views), and the halo windows gather back out as the next
step's standardized feedback (build_feedback): one hand-written kernel
launch each per class or per cycle (kernels/).  The coupled cycle
(ml_only=False) also injects the assembled grid into SPEEDY
(inject_to_speedy: the grid->spectral->grid double transform and the
safety gate), runs a 6-h SPEEDY window from a cold start
(speedy_window) and packs the forecast into each region's local-model
vector (build_local_model, K3 with a core-only table).

The window's entry and exit and the injection's glue are kernels too:
K17 (the surface and forcing, whose fsol plane is also the coupled
cycle's TISR field), K6_inject (the injection's spectral glue, K18, as
phase 0 of the synthesis of its gate's fields), K19 (the gate) and K20
(the exit, with the gate's select).  The ML-only cycle hands K3 the date,
and K3 works out the TISR elements it gathers (tisr_field, K17b, makes
the plane for a caller who asks for it).  The safety gate is a select,
not a branch: the window always runs, and K20 keeps the injected fields
where ok is false, so an unsafe state (and any NaN it makes) stays out
of the next state.  The flag stays on the device.

With persist_surface (the JAX package's default product path) the
coupled cycle carries the slab land, sea and ice temperatures and the
window fluxes' sums across cycles: the window starts from the carried
surface (K17's carry form), and one K21 launch after it adds the
window's sums where ok is true (a select again) or, on every fourth
cycle, runs the daily coupler and zeroes the sums.

The cycle's options (the JAX package's, A10c-1): with an SST table
(set_sst_table), an hour of the year and no slab ocean, the cycle first
replaces the state's SST grid with the table's day and the bias ramp (one
K23 launch); with a TISR table (set_tisr_table) and an hour of the year,
the TISR field both cycles feed back is the table's row, a view handed to
K3 (no launch); with emit_components the readout's launches (K2's
components form) also store its SPEEDY and reservoir parts, v_p and v_ml,
into two more grids, which the diagnostics return without the clamps.

With ocean packs (the slab ocean, the JAX package's product default) the
cycle also pushes each class's ocean inputs, a sub-vector of the bottom
pack's new feedback, into a ring of the last SLAB_STRIDE - 1 cycles (K22),
and every SLAB_STRIDE-th cycle (a slab step) averages the ring, steps the
slab ESNs (K1), reads them out (K2) and makes the new SST grid that the
next cycles' feedback and windows see (K22 again).  Whether a cycle is a
slab step is a host decision on the host step counter.

Layouts follow the JAX package: fields (V, K, lat, lon), class vectors
(Rc, I) / (Rc, O), and the same packing order, so both compute the same
cycle from the same parameters.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.esn.domain import RegionClass, RegionLayout, band
from speedy_ml_tpu_torch.esn.reservoir import (BatchedReservoir, ESNHyper,
                                               esn_step, synchronize)
from speedy_ml_tpu_torch.esn.standardize import Standardizer
from speedy_ml_tpu_torch.gcm import FluxAccumulator, GCMState
from speedy_ml_tpu_torch.kernels.core_scatter import (CoreScatter,
                                                      grid_blocks,
                                                      split_grid)
from speedy_ml_tpu_torch.kernels.gate_check import gate_check
from speedy_ml_tpu_torch.kernels.inject_spectral import inject_synthesis
from speedy_ml_tpu_torch.kernels.readout import readout
from speedy_ml_tpu_torch.kernels.slab_ocean import slab_ocean, sst_table
from speedy_ml_tpu_torch.kernels.sst_by_date import sst_by_date, table_day
from speedy_ml_tpu_torch.kernels.surface_forcing import (INDICES, SCALARS,
                                                         TisrDate,
                                                         scalar_values,
                                                         tisr_plane)
from speedy_ml_tpu_torch.kernels.window_gather import TisrRow, window_gather
from speedy_ml_tpu_torch.physics.land_sea import init_surface_state

# The cycle's row of per-cycle scalars (cycle_with_params(scalars=),
# HybridAtmosphere.scalar_row), float64 with the integers as exact
# doubles: K17's date as surface_forcing.scalar_values lists it (K21 and
# K3's date form read it too), K23's day and bias, the TISR table's row,
# K22's ring slot.  A captured CUDA graph of the cycle (hybrid/graph.py)
# reads the date from it, so that each replay takes its own.
ROW_SF = len(SCALARS) + len(INDICES)
ROW_SST = ROW_SF
ROW_TISR = ROW_SF + 2
ROW_SLOT = ROW_SF + 3
ROW_LEN = ROW_SF + 4


@dataclasses.dataclass(frozen=True)
class ClassState:
    """Dynamic per-class ESN state."""
    x: torch.Tensor            # (Rc, n) reservoir state
    feedback: torch.Tensor     # (Rc, I) standardized input for the next step
    local_model: torch.Tensor  # (Rc, S) standardized SPEEDY forecast


@dataclasses.dataclass(frozen=True)
class OceanClassState:
    """Slab-ocean reservoir state for one region class.

    buffer is a ring, not the JAX package's buffer: slot k holds the ocean
    inputs pushed at the cycles = k (mod W), W = SLAB_STRIDE - 1, so it is
    the JAX buffer (oldest first) rolled by step mod W
    (kernels/slab_ocean.py buffer_to_ring, ring_to_buffer); at step 0, where
    init_state and start_prediction seed it, the two are the same.  The
    cycle writes the ring in place (one slot a cycle, not a copy of the
    whole buffer): the next state shares the tensor, so a caller who keeps
    a state to run again from copies it first (ocean_snapshot)."""
    x: torch.Tensor            # (Rc, n_o)
    buffer: torch.Tensor       # (W, Rc, I_o) ring of the atmo inputs
    # standardized SST local model of the hybrid slab readout: the previous
    # slab step's own output (predict_slab persists its output as the next
    # step's imperfect model, mod_slab_ocean_reservoir.f90:1236-1238); None
    # for ML-only slabs
    lm: object = None          # (Rc, O_o) or None


@dataclasses.dataclass(frozen=True)
class HybridState:
    classes: tuple             # tuple[ClassState, ...]
    sst_grid: torch.Tensor     # (lat, lon) current SST seen by the ESNs
    # SPEEDY safety gate.  The ML-only cycle runs no gate, so it stays a
    # host True and reading it costs no device sync; the coupled cycle
    # carries a 0-d bool tensor on the device
    safe: bool | torch.Tensor
    step: int                  # cycle counter (host-side)
    ocean: tuple = ()          # OceanClassState per class (empty: no ML ocean)
    # persistent coupled surface (persist_surface): the carried
    # SurfaceState and the FluxAccumulator of the sums toward the daily
    # coupler; None until the first persistent cycle
    sfc: object = None
    fluxes: object = None


class ClassPack(NamedTuple):
    """Per-class bundle: reservoir weights + geometry + scaling.

    `cls`, `hyper` and `zspec` are static; `res` and `std` are the
    parameters (HybridAtmosphere.params).  zspec: vertical-localization
    group (esn.domain.VertSpec), None for the single full-column group.
    With num_vert_levels > 1 each (horizontal class, vertical group) is a
    pack of its own; only bottom groups carry logp/precip/sst
    (res_domain.f90:206-256)."""
    cls: RegionClass
    res: BatchedReservoir
    hyper: ESNHyper
    std: Standardizer
    zspec: object = None

    @property
    def bottom(self):
        return self.zspec is None or self.zspec.bottom


class OceanPack(NamedTuple):
    """Slab-ocean reservoirs for one region class.

    idx_map: static indices into the class's atmo input vector (the
    atmo_training_data_idx equivalent, esn/ocean.py ocean_index_map);
    mean_sst/std_sst (Rc, 1): the atmo standardizer's SST scalars (the
    outputs unstandardize with them).  hybrid_readout: the readout sees
    [previous SST output ; x~] instead of x~ alone (predict_slab vs
    predict_slab_ml, mod_slab_ocean_reservoir.f90:1201-1296)."""
    cls: RegionClass
    res: BatchedReservoir
    hyper: ESNHyper
    idx_map: np.ndarray
    mean_sst: torch.Tensor
    std_sst: torch.Tensor
    hybrid_readout: bool = False


def ocean_snapshot(hstate: HybridState) -> HybridState:
    """The state with copies of its ocean rings (a meshed state's: each
    shard's), which the next cycle then does not write (the cycle writes a
    ring in place)."""
    from speedy_ml_tpu_torch.parallel.mesh import Sharded
    copy_ = lambda b: (Sharded(t.clone() for t in b)
                       if isinstance(b, Sharded) else b.clone())
    return dataclasses.replace(hstate, ocean=tuple(
        dataclasses.replace(o, buffer=copy_(o.buffer))
        for o in hstate.ocean))


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


class HybridAtmosphere:
    """Hybrid cycle driver (atmosphere reservoirs, ML-only or coupled)."""

    TIMESTEP_HOURS = 6
    NVAR = 4  # T, u, v, q

    SLAB_STRIDE = 28   # atmosphere cycles per ocean step (168 h / 6 h)

    def __init__(self, gcm, layout: RegionLayout, packs: list[ClassPack],
                 ml_only: bool = False, ocean_packs=None, base_sst=None,
                 sea_mask=None, *, device=None):
        """gcm may be None when ml_only: geometry then comes from
        layout.geom and the dtype from the packs; the coupled cycle needs
        a GCM on the same device.  device: where the cycle runs (default
        CUDA; raises without one); the packs must be there, and so must
        the slab ocean's: ocean_packs (an OceanPack per layout class, in
        order), base_sst (lat, lon), the land fill of the ML SST grid, and
        sea_mask (lat, lon), > 0 where that fill applies (land)."""
        if not ml_only and (gcm is None or not hasattr(gcm, "dyn")):
            raise ValueError("the coupled cycle (ml_only=False) needs a GCM")
        device = resolve_device(device)
        if not ml_only and not _on(gcm.phis, device):
            raise ValueError(f"the GCM lives on {gcm.device}, not on "
                             f"{device}")
        if ocean_packs and any(p.zspec is not None for p in packs):
            raise NotImplementedError(
                "the slab ocean with vertical localization is not wired "
                "(nor in the JAX package, whose train_hybrid refuses it)")
        for p in packs:
            if not _on(p.res.vals, device):
                raise ValueError(f"pack {p.cls.name} lives on "
                                 f"{p.res.vals.device}, not on {device}")
        for op in ocean_packs or ():
            for nm, t in (("res.vals", op.res.vals),
                          ("res.wout", op.res.wout),
                          ("mean_sst", op.mean_sst),
                          ("std_sst", op.std_sst)):
                if not _on(t, device):
                    raise ValueError(f"ocean pack {op.cls.name}: {nm} lives "
                                     f"on {t.device}, not on {device}")
        for nm, t in (("base_sst", base_sst), ("sea_mask", sea_mask)):
            if t is not None and not (torch.is_tensor(t) and _on(t, device)):
                raise ValueError(f"{nm} must be a tensor on {device}")
        self.gcm = gcm
        self.layout = layout
        self.packs = list(packs)
        self.ml_only = ml_only
        self.ocean_packs = list(ocean_packs) if ocean_packs else None
        self.base_sst = base_sst
        self.sea_mask = sea_mask
        # date-indexed climatology tables (set_tisr_table/set_sst_table),
        # in the hybrid's dtype on its device: tisr_table (n_entries, lat,
        # lon), entry k valid at hour k * tisr_hours_per_entry of the
        # 365-day year; sst_table (365, lat, lon) daily
        # (get_tisr_by_date/get_sst_by_date, mpires.f90:1644-1725).
        # Absent: the analytic TISR, the SST held or the ML ocean's
        self.tisr_table = None
        self.tisr_hours_per_entry = 1
        self.sst_table = None
        # JAX-package switches a caller may set: emit_components stores the
        # readout's v_p/v_ml parts in the diagnostics; persist_surface
        # carries the coupled surface across cycles
        self.emit_components = False
        self.persist_surface = False
        # the hub-free sharded cycle (set_mesh): the regions' states and
        # readouts over lon sectors of the mesh's devices (hybrid/sharded.py)
        self.mesh = None
        self._sharded_ops = self._sharded_packs = None
        self._sharded_opacks = self._mesh_index = self._mesh_lat = None
        self.device = self.packs[0].res.vals.device
        self.geom = gcm.geom if gcm is not None else layout.geom
        self.dtype = gcm.dtype if gcm is not None \
            else self.packs[0].res.vals.dtype
        self.nz = self.geom.nlev
        # steps of the GCM inside one hybrid window
        self.gcm_steps = (gcm.nsteps_day * self.TIMESTEP_HOURS // 24
                          if gcm is not None else 0)

        # static index tables of the gather/scatter kernels, built once:
        # per pack its (Rc, I) pack_table and its (Rc, O) core output
        # index (views of one device tensor).  A vertical group's tables
        # take its bands (esn.domain.band): its input window's levels for
        # the feedback, its core's for the local model and the store, and
        # the 2-D blocks only for a bottom group (the JAX assemble_global,
        # build_feedback and build_local_model, hybrid/model.py:375-505);
        # one K3 launch and one K2 store a pack serve every group
        g = self.geom
        self.feedback_index = [torch.as_tensor(
            layout.pack_table(p.cls, self.NVAR, self.nz, logp=p.bottom,
                              precip=p.bottom, sst=p.bottom, tisr=True,
                              levels=band(p.zspec, self.nz, core=False)),
            device=self.device) for p in self.packs]
        # the local-model gather: K3 with core-only tables of the speedy
        # vector (atmo + logp: the output layout minus the precip block)
        self.local_index = [torch.as_tensor(
            layout.pack_table(p.cls, self.NVAR, self.nz, logp=p.bottom,
                              precip=False, sst=False, tisr=False,
                              core_only=True,
                              levels=band(p.zspec, self.nz, core=True)),
            device=self.device) for p in self.packs]
        idx = layout.core_output_index([p.cls for p in self.packs],
                                       self.NVAR, self.nz,
                                       [p.zspec for p in self.packs])
        flat = torch.as_tensor(np.concatenate([i.ravel() for i in idx]),
                               device=self.device)
        self.core_index = [v.view(i.shape) for v, i in zip(
            torch.split(flat, [i.size for i in idx]), idx)]
        self.grid_size, self.q_block, self.p_block = grid_blocks(
            self.NVAR, self.nz, g.nlat, g.nlon)
        self._slat = torch.as_tensor(g.sin_lat, dtype=self.dtype,
                                     device=self.device)
        self._clat = torch.as_tensor(g.cos_lat, dtype=self.dtype,
                                     device=self.device)
        # the slab ocean's tables (K22): the index maps on the device, and
        # the SST form's source table, land fill and mask
        self.ocean_index = self.ocean_table = None
        if self.ocean_packs:
            if len(self.ocean_packs) != len(layout.classes) or any(
                    op.cls is not cls for op, cls in zip(self.ocean_packs,
                                                         layout.classes)):
                raise ValueError("one ocean pack per layout class, in order")
            bottom = self._bottom_index()
            self.ocean_index = []
            for op, bi in zip(self.ocean_packs, bottom):
                idx = np.asarray(op.idx_map)
                if idx.min() < 0 or idx.max() >= self.packs[bi].res.n_in:
                    raise ValueError(f"ocean pack {op.cls.name}: its index "
                                     f"map leaves the input vector")
                self.ocean_index.append(torch.as_tensor(
                    idx.astype(np.int32), device=self.device))
            self.ocean_table = sst_table(
                layout, [op.cls for op in self.ocean_packs], base_sst,
                sea_mask, device=self.device, dtype=self.dtype)

    def set_mesh(self, mesh, shard_gcm: bool = True):
        """Switch the cycle to the hub-free sharded path over `mesh`
        (parallel/mesh.py; the JAX set_mesh, hybrid/model.py:164-185):
        each device steps and reads out its regions (K1, K2), K2 stores
        their cores into the device's lon sector, the sectors join into
        the global grid on mesh.devices[0], where the injection runs, each
        device gets its sector of the window's fields, SST and TISR, and
        K3 gathers its regions' feedback through a periodic lon halo, and
        their local model.  The regions' states are sharded (init_state,
        start_prediction, shard_state); the diagnostics stay global on
        mesh.devices[0].  shard_gcm=True (the JAX default) also
        distributes the GCM's window (GCM.set_mesh, on a copy of the
        GCM): its spectral state over m ranges and its grid and physics
        over latitude bands of the same devices; the injection, the gate
        (K19) and the window's exit (K20) run whole on mesh.devices[0]
        (the ML-only cycle runs no GCM).  shard_gcm=False keeps the whole
        window there.  With ocean packs the slab ocean's regions are
        sharded as the atmosphere's (each device's rings, K22's pushes, K1
        and K2 on its regions; slab_step), and K22's SST form runs whole
        on mesh.devices[0].  The captured loop (run_prediction with
        cycles_per_dispatch > 1, hybrid/graph.py) runs on a mesh too."""
        if not _on(self.packs[0].res.vals, mesh.devices[0]):
            raise ValueError(f"the mesh's first device {mesh.devices[0]} is "
                             f"not the hybrid's ({self.device})")
        from speedy_ml_tpu_torch.hybrid.sharded import ShardedCycleOps
        from speedy_ml_tpu_torch.parallel.mesh import replicate
        ops = ShardedCycleOps(self.layout, self.packs, mesh, self.nz)
        self._sharded_ops = ops
        self._sharded_packs = ops.shard_params(self.packs)
        self._mesh_lat = (replicate(self._slat, mesh),
                          replicate(self._clat, mesh))
        if self.ocean_packs:
            self._sharded_opacks = ops.shard_ocean_packs(self.ocean_packs)
            self._mesh_index = [replicate(i, mesh) for i in self.ocean_index]
        if shard_gcm and not self.ml_only:
            self.gcm = copy.copy(self.gcm)
            self.gcm.set_mesh(mesh)
        self.mesh = mesh

    def shard_state(self, hstate: HybridState) -> HybridState:
        """hstate with its regions' states (x, feedback, local_model) and
        its slab ocean's (x and lm by rows, the ring along its region axis)
        split over the mesh's devices (Sharded), as the sharded cycle
        takes them; a state already sharded is returned as it is."""
        ops = self._sharded_ops
        if ops is None:
            raise ValueError("shard_state: the hybrid has no mesh")
        from speedy_ml_tpu_torch.parallel.mesh import Sharded, shard_rows
        rep = {}
        if not all(isinstance(cs.x, Sharded) for cs in hstate.classes):
            rep["classes"] = tuple(
                ClassState(*(shard_rows(t, ops.mesh) for t in
                             (cs.x, cs.feedback, cs.local_model)))
                for cs in hstate.classes)
        if hstate.ocean and not isinstance(hstate.ocean[0].x, Sharded):
            rep["ocean"] = tuple(OceanClassState(
                x=shard_rows(o.x, ops.mesh),
                buffer=shard_rows(o.buffer, ops.mesh, dim=1),
                lm=None if o.lm is None else shard_rows(o.lm, ops.mesh))
                for o in hstate.ocean)
        return dataclasses.replace(hstate, **rep) if rep else hstate

    def _table(self, table, name: str) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(table) if not torch.is_tensor(table)
                            else table)
        if t.dim() != 3 or tuple(t.shape[1:]) != (self.geom.nlat,
                                                  self.geom.nlon):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"(n, {self.geom.nlat}, {self.geom.nlon})")
        return t.to(device=self.device, dtype=self.dtype).contiguous()

    def set_tisr_table(self, table, hours_per_entry: int = 1):
        """Install a TISR climatology over one 365-day year (full_tisr of
        get_tisr_by_date, mpires.f90:1644-1676).  table: (n_entries, lat,
        lon), entry k valid at hour k * hours_per_entry into the year;
        stored contiguous, so that a row is a contiguous view."""
        self.tisr_table = self._table(table, "set_tisr_table")
        self.tisr_hours_per_entry = int(hours_per_entry)

    def set_sst_table(self, table):
        """Install a daily SST climatology (365, lat, lon) (full_sst of
        get_sst_by_date, mpires.f90:1679-1725)."""
        self.sst_table = self._table(table, "set_sst_table")

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
        safe = True if self.ml_only else torch.ones(
            (), dtype=torch.bool, device=self.device)
        state = HybridState(classes=tuple(cls_states),
                            sst_grid=torch.as_tensor(sst_grid, **kw),
                            safe=safe, step=0,
                            ocean=self._init_ocean_states())
        return state if self.mesh is None else self.shard_state(state)

    def _init_ocean_states(self) -> tuple:
        if not self.ocean_packs:
            return ()
        W = self.SLAB_STRIDE - 1
        kw = dict(dtype=self.dtype, device=self.device)
        out = []
        for op in self.ocean_packs:
            Rc = op.cls.count
            lm = (torch.zeros((Rc, op.res.n_outputs), **kw)
                  if op.hybrid_readout else None)
            out.append(OceanClassState(
                x=torch.zeros((Rc, op.res.n), **kw),
                buffer=torch.zeros((W, Rc, len(op.idx_map)), **kw), lm=lm))
        return tuple(out)

    def start_prediction(self, truth_sync: dict, model_next: Optional[dict],
                         sst0) -> HybridState:
        """Synchronize the reservoirs on a truth window, then arm the first
        cycle (start_prediction/synchronize, mod_reservoir.f90:938-959,
        1352-1379).

        truth_sync: dict of grids (T, ...) as in hybrid.training; the last
        sample is the initial condition.  model_next: the imperfect
        model's forecast grids (atmo, logp) valid one step after the
        window's end, or None (zeros).  The ocean rings are seeded from
        the window (step 0: the ring is the JAX buffer)."""
        from speedy_ml_tpu_torch.esn.ocean import (ocean_target_slice,
                                                   sst_core_from_input)
        from speedy_ml_tpu_torch.hybrid.training import (as_tensors,
                                                         pack_class_series)
        kw = dict(dtype=self.dtype, device=self.device)
        truth = as_tensors(truth_sync, self.device)
        cls_states = []
        for p in self.packs:
            series = pack_class_series(self.layout, p.cls, truth,
                                       zspec=p.zspec)
            z = p.std.standardize_input(series.to(self.dtype))
            x = synchronize(p.res, torch.zeros((p.cls.count, p.res.n), **kw),
                            z[:-1], p.hyper.leakage)
            if model_next is not None:
                m = as_tensors(model_next, self.device, self.dtype)
                lo, hi = band(p.zspec, self.nz, core=True)
                vec = self.layout.pack_vector(
                    p.cls, m["atmo"][:, lo:hi],
                    logp=m["logp"] if p.bottom else None, core_only=True)
                S = p.res.n_speedy
                lm = ((vec[:, :S] - p.std.out_mean[:, :S])
                      / p.std.out_std[:, :S])
            else:
                lm = torch.zeros((p.cls.count, p.res.n_speedy), **kw)
            cls_states.append(ClassState(x=x, feedback=z[-1].contiguous(),
                                         local_model=lm.contiguous()))
        # the ocean rings from the sync window, paired with the BOTTOM atmo
        # pack of each class (the slab ocean reads the lowest-level inputs,
        # get_training_data_from_atmo)
        ocean_states = []
        if self.ocean_packs:
            W = self.SLAB_STRIDE - 1
            for op, bi, idx in zip(self.ocean_packs, self._bottom_index(),
                                   self.ocean_index):
                p = self.packs[bi]
                series = pack_class_series(self.layout, op.cls, truth)
                z = p.std.standardize_input(series.to(self.dtype))
                o_series = z[:, :, idx.long()]
                T = o_series.shape[0]
                reps = (W + T - 1) // T
                buf = o_series.repeat(reps, 1, 1)[-W:].contiguous()
                lm = None
                if op.hybrid_readout:
                    # the slab local model starts as the last observed SST
                    # core, standardized (start_prediction_slab seeds its
                    # outvec from the final SST, mod_slab_ocean_reservoir.f90:
                    # 769-800)
                    sl = ocean_target_slice(op.cls, self.nz)
                    lm = sst_core_from_input(
                        op.cls, z[-1, :, sl[0]:sl[1]]).contiguous()
                ocean_states.append(OceanClassState(
                    x=torch.zeros((op.cls.count, op.res.n), **kw),
                    buffer=buf, lm=lm))
        safe = True if self.ml_only else torch.ones(
            (), dtype=torch.bool, device=self.device)
        state = HybridState(classes=tuple(cls_states),
                            sst_grid=torch.as_tensor(sst0, **kw),
                            safe=safe, step=0, ocean=tuple(ocean_states))
        return state if self.mesh is None else self.shard_state(state)

    def _bottom_index(self) -> list:
        """Index into packs of each layout class's bottom pack (the one
        carrying the surface blocks), in layout.classes order."""
        out = []
        for cls in self.layout.classes:
            for i, p in enumerate(self.packs):
                if p.cls is cls and p.bottom:
                    out.append(i)
                    break
        return out

    # ------------------------------------------------------------------
    # pieces of the cycle
    # ------------------------------------------------------------------

    @property
    def params(self):
        """Model parameters: (atmo (res, std) tuple, ocean (res, mean_sst,
        std_sst) tuple)."""
        return (tuple((p.res, p.std) for p in self.packs),
                tuple((op.res, op.mean_sst, op.std_sst)
                      for op in (self.ocean_packs or ())))

    def cast_wout_bf16(self):
        """Store the readout weights in bfloat16 (in place on the packs).

        The readout is bound by the Wout read (3.6 GB in f32 at m=6000 x
        1,152 regions); bf16 halves it.  The readout kernel rounds the
        augmented state to bf16 and keeps an f32 sum.  The slab ocean's
        Wout (73 MB, read once every SLAB_STRIDE cycles) stays as it is."""
        self.packs = [p._replace(res=dataclasses.replace(
            p.res, wout=p.res.wout.to(torch.bfloat16)))
            for p in self.packs]
        if self._sharded_ops is not None:
            self._sharded_packs = self._sharded_ops.shard_params(self.packs)
        return self

    def _with_params(self, params):
        """(atmo packs, ocean packs) with the parameters of `params`."""
        atmo_p, ocean_p = params
        packs = [ClassPack(cls=p.cls, res=r, hyper=p.hyper, std=s,
                           zspec=p.zspec)
                 for p, (r, s) in zip(self.packs, atmo_p)]
        opacks = [op._replace(res=r, mean_sst=m, std_sst=s)
                  for op, (r, m, s) in zip(self.ocean_packs or (), ocean_p)]
        return packs, opacks

    def predict_all(self, packs, hstate: HybridState,
                    components: bool = False):
        """ESN step + readout for every region (predict/predict_ml,
        mod_reservoir.f90:1416-1533): the readout applies
        unstandardize_output and stores each region's core straight into
        the global grid with the q/precip clamps (the core scatter,
        tile_full_grid_with_local_state_vec_res + mpires.f90:444-478).
        Returns (new xs, the flat grid [atmo, logp, precip]), allocated
        here once a cycle.  components=True (K2's components form) also
        returns (v_p, v_ml): two more flat grids of the readout's
        standardized SPEEDY and reservoir parts, without the clamps
        (outvec_component_contribs, mod_reservoir.f90:1456-1467)."""
        if len(packs) != len(self.packs):
            raise ValueError("predict_all: one class state per pack")
        grids = torch.empty((3 if components else 1, self.grid_size),
                            dtype=packs[0].std.out_mean.dtype,
                            device=self.device)
        grid = grids[0]
        parts = (grids[1], grids[2]) if components else None
        new_x = []
        for p, cs, index in zip(packs, hstate.classes, self.core_index):
            x = esn_step(p.res, cs.x, cs.feedback, p.hyper.leakage)
            lm = None if self.ml_only else cs.local_model
            readout(p.res.wout, x, lm, p.std.out_mean, p.std.out_std,
                    scatter=CoreScatter(grid, index, self.q_block,
                                        self.p_block), parts=parts)
            new_x.append(x)
        if components:
            return new_x, grid, parts
        return new_x, grid

    def assemble_global(self, packs, grid):
        """The global (atmo (4, K, lat, lon), logp, precip) of predict_all's
        grid: views, no launch (the readout assembled and clamped it)."""
        g = self.geom
        return split_grid(grid, self.NVAR, self.nz, g.nlat, g.nlon)

    def build_feedback(self, packs, atmo, logp, precip, sst_grid, tisr_grid):
        """Per-class standardized feedback vectors (sendrecievegrid
        scatter + standardize, mpires.f90:561-750): one window-gather
        launch for all classes.  tisr_grid: the TISR plane, its date (a
        TisrDate) or a table's row (a TisrRow)."""
        fields = tuple(f.contiguous() for f in
                       (atmo, logp, precip, sst_grid)) + (
            tisr_grid if isinstance(tisr_grid, (TisrDate, TisrRow))
            else tisr_grid.contiguous(),)
        return window_gather(fields, self.feedback_index,
                             [p.std.in_mean for p in packs],
                             [p.std.in_std for p in packs])

    def inject_to_speedy(self, atmo, logp):
        """Grid -> spectral with truncation, and back (iogrid 30).

        One analysis launch (K5) for [T, q, logp | u, v] (u, v times 1/cos
        for vdspec), one launch (K6_inject) for vds, the truncations,
        uvspec, the state's two levels and the synthesis of the fields the
        safety check reads, and K19 for the gate.  Returns (SpectralState,
        safe), safe a 0-d bool tensor: the physical-range gate on the
        post-transform fields (ppo_iogrid.f90:563-577)."""
        sht = self.gcm.sht
        K = self.nz
        qg = torch.clamp(atmo[3], min=0.0)
        spec = sht.analysis(torch.cat([atmo[0], qg, logp[None], atmo[1],
                                       atmo[2]]), 2 * K + 1)
        # the double transform: back to grid for the safety check (and the
        # smoothing the trained weights expect)
        state, grid = inject_synthesis(sht, spec, K)
        safe, _ = gate_check(grid, K)
        return state, safe

    def _run_window(self, spec: SpectralState, sst_hybrid, imon, fmon,
                    tyear, sfc_carry=None,
                    scalars=None) -> tuple[GCMState, torch.Tensor]:
        """The window from a cold start: the surface from climatology and
        the hybrid SST and the forcing (K17 and K5; with sfc_carry, the
        persistent surface, the slab models' fields are the carry's and
        the forcing reads its stl_lm), zero carries (one fill), stepone,
        gcm_steps leapfrog steps from istep 0 (so the shortwave cadence
        inside a window is static).  Returns (the window's end state, its
        forcing's fsol plane): solar_flux_traced at tyear with 4 SOLC, the
        TISR plane of the same date (tisr_field's, bit for bit).  scalars:
        K17's device-scalar form's row (the first ROW_SF of the cycle's),
        or None."""
        gcm = self.gcm
        sfc, forcing = gcm.window_entry(imon, fmon, tyear, sst_hybrid,
                                        sfc_carry=sfc_carry, scalars=scalars)
        radiation, fluxes = gcm.window_carries()
        gstate = GCMState(spectral=spec, sfc=sfc, radiation=radiation,
                          fluxes=fluxes, istep=0)
        # on a meshed GCM the forcing's planes are cut into the bands once
        # a window
        win = forcing if gcm.mesh is None else gcm.shard_forcing(forcing)
        gstate = gcm.stepone(gstate, win)
        return gcm.run_window(gstate, win, self.gcm_steps), forcing.fsol

    def speedy_window(self, spec: SpectralState, sst_hybrid, imon, fmon,
                      tyear, sfc_carry=None):
        """SPEEDY for one 6-h window from a cold start (run_model,
        mpires.f90:1516-1628), then the fields at leapfrog level 0 (iogrid
        31; GCM.grid_state).  sfc_carry: the persistent coupled surface
        (a SurfaceState) or None (the climatology).  Returns (atmo (4, K,
        lat, lon), logp, window FluxAccumulator)."""
        gstate, _ = self._run_window(spec, sst_hybrid, imon, fmon, tyear,
                                     sfc_carry)
        atmo, logp, _ = self.gcm.grid_state(gstate.spectral)
        return atmo, logp, self.gcm.whole(gstate.fluxes)

    def build_local_model(self, packs, fc_atmo, fc_logp):
        """Per-class standardized SPEEDY forecast vectors (core atmo +
        logp): one K3 launch for all classes with the core-only tables."""
        fields = (fc_atmo.contiguous(),) + (fc_logp.contiguous(),) * 4
        S = [p.res.n_speedy for p in packs]
        return window_gather(
            fields, self.local_index,
            [p.std.out_mean[:, :s].contiguous() for p, s in zip(packs, S)],
            [p.std.out_std[:, :s].contiguous() for p, s in zip(packs, S)])

    def tisr_field(self, tyear, hour_of_year=None, table=None,
                   hours_per_entry: int = 1):
        """TISR input field (lat, lon) for the current date.  With a table
        and an hour of the year (host ints), its row (hour_of_year //
        hours_per_entry) % n_entries, as get_tisr_by_date indexes it
        (mpires.f90:1644-1676): a view, no launch.  Otherwise the analytic
        Hartmann daily-mean insolation, one K17b launch (tyear a host
        number).  Without a table the cycles do not call it: the coupled
        cycle feeds back its window's fsol plane, the same plane made by
        K17, and the ML-only cycle hands K3 the date (tisr_date), whose
        TISR elements are this plane's bit for bit."""
        if table is not None and hour_of_year is not None:
            return table[(int(hour_of_year) // int(hours_per_entry))
                         % table.shape[0]]
        return tisr_plane(tyear, self._slat, self._clat, self.geom.nlon)

    def sst_by_date(self, hour_of_year, sst_bias, table, dev=None):
        """The daily climatology's SST with the non-stationary bias ramp
        over open water (get_sst_by_date, mpires.f90:1679-1725: the bias
        added where SST > 273 K): day (hour_of_year // 24) % n_days of
        `table`, one K23 launch (the day and the bias host numbers; with
        dev, K23's device-scalar form reads them from the cycle's row)."""
        day = table_day(hour_of_year, table.shape[0])
        if dev is None:
            return sst_by_date(table, day, sst_bias)
        return sst_by_date(table, day, sst_bias, dev)

    def tisr_date(self, tyear, dev=None) -> TisrDate:
        """The date of tisr_field's plane, as K3 takes it in place of the
        plane (tyear a host number; dev: the date's row on the card, which
        K3's device-scalar form reads instead)."""
        return TisrDate(tyear, self._slat, self._clat, dev)

    def scalar_row(self, imon, fmon, tyear, hour_of_year=None,
                   sst_bias: float = 0.0, step: int = 0) -> list:
        """The cycle's row of per-cycle scalars (ROW_* layout) for these
        host numbers and the host step: what the kernels' device-scalar
        forms read in place of the host numbers, the same values."""
        phys = getattr(self.gcm, "phys", None)
        v, ix = scalar_values((imon, fmon), 0.0, tyear,
                              phys.gamlat if phys is not None else 0.0,
                              phys.pexp if phys is not None else 0.0)
        day = row = 0
        if hour_of_year is not None:
            if self.sst_table is not None:
                day = table_day(hour_of_year, self.sst_table.shape[0])
            if self.tisr_table is not None:
                row = ((int(hour_of_year) // int(self.tisr_hours_per_entry))
                       % self.tisr_table.shape[0])
        slot = step % (self.SLAB_STRIDE - 1) if self.ocean_packs else 0
        return v + [float(i) for i in ix] + [float(day), float(sst_bias),
                                             float(row), float(slot)]

    # ------------------------------------------------------------------

    def cycle_with_params(self, params, hstate: HybridState, imon, fmon,
                          tyear, hour_of_year=None, sst_bias=0.0,
                          scalars=None) -> tuple:
        """One 6-h hybrid step with explicit parameters (the JAX
        _cycle_jit, hybrid/model.py:579-749, without the options of later
        slices).  imon (0-based month) and fmon are host numbers; tyear a
        float; hour_of_year a host int into the 365-day year, which the
        climatology tables need (without it they are not read), and
        sst_bias the SST ramp's offset (K) that the SST table's day takes
        over open water.  With persist_surface the coupled cycle carries
        the slab surface and the flux sums in the state (sfc, fluxes): the
        first cycle starts them from the climatology (one K17 launch, one
        fill), and after the window K21 accumulates or, when step % 4 == 3,
        couples (JAX :614-659).  With emit_components the diagnostics also
        hold vp_atmo, vp_logp, vp_precip, vml_atmo, vml_logp and
        vml_precip (JAX :735-747).  scalars: None, or the cycle's row of
        per-cycle scalars (scalar_row of these host numbers and the
        state's step, a float64 tensor on the hybrid's device): the kernels
        that read the date (K17, K21, K23, K3, K22's push) take it from the
        row, in their device-scalar forms, so that a captured CUDA graph of
        the cycle (hybrid/graph.py) replays at each cycle's date; the host
        numbers then choose only what the host chooses (the tables, the
        coupler's day, the slab step) and feed the CPU route.  On a mesh
        (set_mesh) the regions' part of the cycle runs sharded (JAX
        :577-583, 604-608, 662-669, 738-745; hybrid/sharded.py), the state's
        regions Sharded, and so does the slab ocean's (JAX :604-608,
        662-726; slab_step); the row of scalars lives on mesh.devices[0],
        where K17, K21 and K23 read it, and the slices that a shard's K3
        (the TISR date or a table's row) and K22 read are copied to the
        shard's device on the device.  Returns (new_state, diagnostics
        dict)."""
        rf = torch.profiler.record_function
        ops = self._sharded_ops
        packs, opacks = self._with_params(params)
        sf = None if scalars is None else scalars[:ROW_SF]
        # the SST that the ESN inputs and SPEEDY see this cycle: without an
        # ML ocean, the daily climatology (JAX :590-596); K23 writes it
        if (self.sst_table is not None and hour_of_year is not None
                and not self.ocean_packs):
            with rf("sst_by_date"):
                hstate = dataclasses.replace(hstate, sst_grid=self.sst_by_date(
                    hour_of_year, sst_bias, self.sst_table,
                    None if scalars is None
                    else scalars[ROW_SST:ROW_SST + 2]))
        # the TISR of the tables: a row of the table (a view; K3 reads the
        # row from the cycle's row in the device-scalar form)
        tisr_row = None
        if self.tisr_table is not None and hour_of_year is not None:
            tisr_row = self.tisr_field(
                tyear, hour_of_year, table=self.tisr_table,
                hours_per_entry=self.tisr_hours_per_entry) \
                if scalars is None else TisrRow(
                    self.tisr_table, scalars[ROW_TISR:ROW_TISR + 1])
        components = bool(self.emit_components)
        with rf("predict_all"):
            if ops is None:
                out = self.predict_all(packs, hstate, components=components)
                new_x, grid = out[0], out[1]
                parts = out[2] if components else None
            else:
                # each device's regions stored into its sector, the
                # sectors joined on this device
                if any(r is not p.res or st is not p.std
                       for (r, st), p in zip(params[0], self.packs)) or any(
                        r is not op.res for (r, _, _), op in zip(
                            params[1], self.ocean_packs or ())):
                    raise ValueError("on a mesh the cycle runs the "
                                     "hybrid's own parameters (set_mesh "
                                     "shards them)")
                sp = self._sharded_packs
                hstate = self.shard_state(hstate)
                new_x = ops.step(sp, [cs.x for cs in hstate.classes],
                                 [cs.feedback for cs in hstate.classes])
                sectors = ops.assemble(
                    sp, new_x, None if self.ml_only else
                    [cs.local_model for cs in hstate.classes], components)
                grid, *parts = ops.gather(sectors, self.device)
        atmo, logp, precip = self.assemble_global(packs, grid)
        safe = hstate.safe
        fc_atmo = fc_logp = tisr = None
        new_sfc, new_fluxes = hstate.sfc, hstate.fluxes
        if not self.ml_only:
            carry = acc = None
            if self.persist_surface:
                carry, acc = hstate.sfc, hstate.fluxes
                if carry is None:   # first cycle: the climatology
                    g = self.geom
                    carry = init_surface_state(self.gcm.bd, imon, fmon,
                                               flags=self.gcm.cpl)
                    acc = FluxAccumulator.zeros(g.nlat, g.nlon, self.dtype,
                                                self.device)
            with rf("inject_to_speedy"):
                spec, safe = self.inject_to_speedy(atmo, logp)
            # the gate (ppo_iogrid.f90:563-577, mpires.f90:721) as a
            # select: the window runs whatever the flag, and where
            # ok = prev & safe is false K20 keeps the injected fields in
            # place of the forecast, so no NaN reaches the next state.
            # The driver stops on the flag.
            prev = hstate.safe if torch.is_tensor(hstate.safe) else \
                torch.full((), bool(hstate.safe), device=self.device)
            # the window's forcing already holds this date's TISR plane
            # (its fsol), so the coupled cycle launches no K17b; a TISR
            # table's row takes its place (K17 still makes fsol for
            # SPEEDY's radiation)
            with rf("speedy_window"):
                gstate, tisr = self._run_window(spec, hstate.sst_grid, imon,
                                                fmon, tyear, carry, sf)
                fc_atmo, fc_logp, safe = self.gcm.grid_state(
                    gstate.spectral, select=(prev, safe, atmo, logp))
            if self.persist_surface:
                # the window's sums count where ok (safe, now prev & safe)
                # is true, as the JAX cycle hands the coupler zeros for a
                # skipped window; the daily exchange on every fourth cycle
                # (agcm_to_coupler/coupler_to_agcm), at the cycle's date
                cpd = 24 // self.TIMESTEP_HOURS
                with rf("slab_couple"):
                    new_sfc, new_fluxes = self.gcm.couple(
                        carry, acc, imon, fmon, window=gstate.fluxes,
                        ok=safe, do_couple=hstate.step % cpd == cpd - 1,
                        scalars=sf)
        with rf("build_feedback"):
            if tisr_row is not None:
                tisr = tisr_row
            elif tisr is None:
                # the ML-only cycle: K3 takes the date (on a mesh each
                # shard's K3)
                tisr = (self.tisr_date(tyear, sf) if ops is None
                        else ops.tisr_dates(tyear, *self._mesh_lat, sf))
            if ops is None:
                feedbacks = self.build_feedback(packs, atmo, logp, precip,
                                                hstate.sst_grid, tisr)
            else:
                if isinstance(tisr, TisrRow):
                    tisr = ops.tisr_rows(tisr.table, tisr.row)
                planes = torch.is_tensor(tisr)
                st = (ops.lon_sectors(hstate.sst_grid, tisr) if planes
                      else ops.lon_sectors(hstate.sst_grid))
                feedbacks = ops.feedback(sp, *ops.sector_fields(sectors),
                                         [f[0] for f in st],
                                         [f[1] for f in st] if planes
                                         else tisr)
        if self.ml_only:
            locals_ = [cs.local_model for cs in hstate.classes]
        else:
            with rf("build_local_model"):
                locals_ = (self.build_local_model(packs, fc_atmo, fc_logp)
                           if ops is None else ops.local_model(
                               sp, ops.lon_sectors(fc_atmo, fc_logp)))
        sst_grid, ocean = hstate.sst_grid, hstate.ocean
        if opacks and ocean:
            with rf("slab_ocean"):
                sst_grid, ocean = self.slab_step(
                    opacks, hstate, feedbacks, None if scalars is None
                    else scalars[ROW_SLOT:ROW_SLOT + 1])
        classes = tuple(
            ClassState(x=x, feedback=fb, local_model=lm)
            for x, fb, lm in zip(new_x, feedbacks, locals_))
        new_state = HybridState(classes=classes, sst_grid=sst_grid,
                                safe=safe, step=hstate.step + 1,
                                ocean=ocean, sfc=new_sfc,
                                fluxes=new_fluxes)
        diag = dict(atmo=atmo, logp=logp, precip=precip,
                    speedy_atmo=fc_atmo, speedy_logp=fc_logp)
        if components:
            # the standardized v_p/v_ml parts as global grids (the
            # reference's v_p/v_ml NetCDF streams): views of the grids
            # K2's components form stored without the clamps
            for name, flat in zip(("vp", "vml"), parts):
                a, l, p = self.assemble_global(packs, flat)
                diag.update({f"{name}_atmo": a, f"{name}_logp": l,
                             f"{name}_precip": p})
        return new_state, diag

    def slab_step(self, opacks, hstate: HybridState, feedbacks,
                  slot=None) -> tuple:
        """The slab ocean of one cycle (JAX :678-726; parallelmain.f90:
        236-248, mpires.f90:753-757): the bottom feedback's ocean inputs
        into each ring (K22, in place), and on a slab step (step %
        SLAB_STRIDE == SLAB_STRIDE - 1, a host decision) the rings' means,
        the slab ESN step (K1) and readout (K2, bare; with hybrid_readout
        the previous output is the local model, and the new one replaces
        it) per class, and the new SST grid (K22).  Returns (the SST grid,
        the ocean states): on other cycles hstate's grid, x and lm.  slot:
        None, or the ring's slot on the card (K22's device-scalar form).
        On a mesh each shard pushes into its rings from its feedback and
        steps and reads out its regions (K22's push forms, K1 and K2 a
        shard), the readouts are joined in region order on
        mesh.devices[0] and K22's SST form runs whole there: nothing is
        summed across shards, so the result is the unsharded one's."""
        fbs = [feedbacks[i] for i in self._bottom_index()]
        ops = self._sharded_ops
        slab = hstate.step % self.SLAB_STRIDE == self.SLAB_STRIDE - 1
        oc = hstate.ocean
        if ops is None:
            shards = [(opacks, oc, fbs, self.ocean_index, slot)]
        else:
            from speedy_ml_tpu_torch.parallel.mesh import Sharded
            slots = [None] * ops.D if slot is None else ops.broadcast(slot)
            part = lambda v, d: None if v is None else v[d]
            shards = [([sp[d] for sp in self._sharded_opacks],
                       [OceanClassState(o.x[d], o.buffer[d], part(o.lm, d))
                        for o in oc], [f[d] for f in fbs],
                       [i[d] for i in self._mesh_index], slots[d])
                      for d in range(ops.D)]
        # per shard, per class: (x', the standardized readout)
        steps = []
        for packs, states, fb, idx, sl in shards:
            means = slab_ocean("push_mean" if slab else "push",
                               bufs=[o.buffer for o in states],
                               step=hstate.step, fbs=fb, idx_maps=idx,
                               slot=sl)
            if slab:
                steps.append([self._slab_readout(op, o.x, o.lm, u)
                              for op, o, u in zip(packs, states, means)])
        if not slab:
            return hstate.sst_grid, oc
        if ops is None:
            xs, outs = zip(*steps[0])
            whole = list(outs)
        else:
            xs = [Sharded(st[c][0] for st in steps) for c in range(len(oc))]
            outs = [Sharded(st[c][1] for st in steps)
                    for c in range(len(oc))]
            whole = [ops.gather_pieces(o) for o in outs]
        states = tuple(OceanClassState(
            x=x, buffer=o.buffer, lm=out if op.hybrid_readout else None)
            for op, o, x, out in zip(opacks, oc, xs, outs))
        sst = slab_ocean("sst", outs=whole,
                         mean_sst=[op.mean_sst for op in opacks],
                         std_sst=[op.std_sst for op in opacks],
                         table=self.ocean_table)
        return sst, states

    def _slab_readout(self, op, x, lm, u):
        """One class's slab ESN step (K1) and readout (K2, with the
        previous output as the local model with hybrid_readout): (x', the
        standardized readout)."""
        x = esn_step(op.res, x, u, op.hyper.leakage)
        if op.hybrid_readout and lm is None:
            lm = torch.zeros((x.shape[0], op.res.n_outputs),
                             dtype=self.dtype, device=x.device)
        return x, readout(op.res.wout, x, lm if op.hybrid_readout else None)

    def cycle(self, hstate: HybridState, imon, fmon, tyear,
              hour_of_year=None, sst_bias=0.0) -> tuple:
        """Convenience wrapper using this instance's stored parameters."""
        return self.cycle_with_params(self.params, hstate, imon, fmon,
                                      tyear, hour_of_year, sst_bias)

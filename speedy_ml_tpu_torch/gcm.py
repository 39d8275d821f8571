"""The atmospheric GCM: dynamics + physics + the surface state.

Counterpart of the JAX package's gcm.py (the reference's at_gcm.f90 and
dyn_stloop.f90): `GCM` holds the static tables on one device and exposes
the step functions; one window is `nsteps` leapfrog steps (the hybrid's
6-h window is 24 x 900 s).  The step counter is a host integer, so the
shortwave cadence (every NSTRAD steps) is a Python branch and a window
makes no host read.

The day loop (run_days) runs a day's window and then the slab
coupler's exchange, one K21 launch (kernels/slab_couple.py); the GCM
holds the slab coefficients, the elnino weights and the observed SST
anomalies on its device, built once.

The optional physics of the reference, off by default: with sppt_on and a
state that carries the SPPT pattern (init_state makes one; the hybrid's
cold-start window carries none, and runs without SPPT), each leapfrog
step draws the noise from the state's torch.Generator, advances the
pattern (K24's AR(1) form), synthesizes it (K6) and hands it to the
physics, whose K24 launch multiplies the tendencies; RDF is the physics'
(PhysicsModel.randfh, K25), the cgrate limiter the dycore's (cgrate_on,
K26).
Without a BoundaryData the GCM reads the reference's fort.20-26 files
from bc_path or $SPEEDY_ML_BC_PATH.

On a mesh (set_mesh, the JAX package's GCM.set_mesh) a window runs
sharded: the spectral state as m ranges and the grid as latitude bands
of the shards (dycore/sharded.py), the column physics, the radiation
carry and the window's flux sums on the bands (the carry's randfv whole
on every shard), cgrate (K26's rows and range forms) on the m ranges and
RDF (K25's sums and band forms) on the bands.  The step functions take
whole or sharded states and return sharded ones (gather_state joins
them); the window's entry (K17 and K5, the daily forcing) runs whole on
mesh.devices[0] and its planes are cut into the bands; grid_state, the
window's exit, joins the m ranges on mesh.devices[0].
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.core.constants import PhysicalConstants
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.dycore.model import DycoreModel, GridTendencies
from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.kernels.rdf import rdf_sums
from speedy_ml_tpu_torch.kernels.slab_couple import FLUX_FIELDS, slab_couple
from speedy_ml_tpu_torch.kernels.spectral_stack import (physics_ncos,
                                                        spectral_stack)
from speedy_ml_tpu_torch.kernels.window_select import window_select
from speedy_ml_tpu_torch.parallel.mesh import Sharded
from speedy_ml_tpu_torch.physics.boundaries import (BoundaryData,
                                                    boundary_path,
                                                    load_boundary_data)
from speedy_ml_tpu_torch.physics.driver import (DailyForcing, PhysicsModel,
                                                RadiationCarry, SpptGrid,
                                                zero_views)
from speedy_ml_tpu_torch.physics.land_sea import (CplFlags, SurfaceState,
                                                  build_slab_coeffs,
                                                  coupled_state,
                                                  sea_domain_mask,
                                                  sstan_for_window)

NSTRAD = 3   # shortwave radiation period in steps (mod_tsteps.f90:65)


@dataclasses.dataclass(frozen=True)
class FluxAccumulator:
    """Daily-mean flux accumulation (ppo_dmflux.f90 essentials)."""
    hflux_l: torch.Tensor
    hflux_s: torch.Tensor
    hflux_i: torch.Tensor
    precip: torch.Tensor   # accumulated total precip [g/m^2 over the window]

    @staticmethod
    def zeros(nlat, nlon, dtype, device=None):
        """Zero sums: views of one zeroed buffer (one fill on the card)."""
        return FluxAccumulator(*zero_views([(nlat, nlon)] * 4, dtype,
                                           device))


def zero_carries(K, nlat, nlon, dtype, device=None, rdf_nlat=None):
    """A window's zero RadiationCarry and FluxAccumulator, all eleven
    fields views of one zeroed buffer: one fill on the card.  rdf_nlat:
    randfv's latitudes (a mesh's band keeps them all), default nlat."""
    shapes = RadiationCarry.shapes(K, nlat, nlon, rdf_nlat)
    v = zero_views(shapes + [(nlat, nlon)] * 4, dtype, device)
    return RadiationCarry(*v[:len(shapes)]), FluxAccumulator(*v[len(shapes):])


@dataclasses.dataclass(frozen=True)
class GCMState:
    """Everything a window advances.  istep is a host int.  sppt_spec and
    sppt_gen: the SPPT pattern (K, mx, nx) complex and the torch.Generator
    its draws come from (on the GCM's device), or None when SPPT is off
    (the default; sppt_on=.false., mod_tsteps.f90:68).  The generator is
    the JAX state's sppt_key, but it is not split: each step draws from it
    in place, so a state stepped twice draws twice."""
    spectral: SpectralState
    sfc: SurfaceState
    radiation: RadiationCarry
    fluxes: FluxAccumulator
    istep: int = 0
    sppt_spec: Optional[torch.Tensor] = None
    sppt_gen: Optional[torch.Generator] = None


class GCM:
    """SPEEDY on one device (default CUDA; raises without one)."""

    def __init__(self, geom: Geometry = Geometry(),
                 constants: PhysicalConstants = PhysicalConstants(),
                 dtype=torch.float32, bc_path: Optional[str] = None,
                 nsteps_day: int = 96, bd: Optional[BoundaryData] = None,
                 sppt_on: bool = False, zonal: str = "dft",
                 scan_unroll: int = 1, cgrate_on: bool = False,
                 cpl_flags: Optional[CplFlags] = None, sstan_monthly=None,
                 sstan_year0: int = 1990, sstom12=None, *, device=None):
        # cpl_flags: coupling modes (mod_cpl_flags.f90); sstan_monthly:
        # observed monthly SST anomalies (M, nlat, nlon) starting Jan of
        # sstan_year0 (the fort.30 anomaly file, obs_ssta); sstom12:
        # ocean-model SST climatology for icsea>=3 (12, nlat, nlon).
        # scan_unroll: the JAX package's leapfrog steps unrolled per scan
        # iteration, numerically identical; the port runs its steps one by
        # one, so any value gives the same GCM
        self.device = resolve_device(device)
        if bd is None:
            bc_path = boundary_path(bc_path)
        self.geom = geom
        self.const = constants
        self.dtype = dtype
        self.dyn = DycoreModel(geom, constants, dtype=dtype,
                               nsteps_day=nsteps_day, zonal=zonal,
                               cgrate_on=cgrate_on, device=self.device)
        self.sht = self.dyn.sht
        self.phys = PhysicsModel(geom, constants, dtype=dtype,
                                 device=self.device)
        self.sppt = None
        if sppt_on:
            from speedy_ml_tpu_torch.physics.sppt import SPPT
            self.sppt = SPPT(self.sht, geom.nlev, nsteps_day)
        if bd is None:
            bd = load_boundary_data(geom, self.sht, constants.grav, bc_path)
        self.bd = bd.to(device=self.device, dtype=dtype)
        self.cpl = cpl_flags if cpl_flags is not None else CplFlags()
        # the slab models' tables, host numpy worked out once, on the
        # device: the coefficients, the elnino blend weights (wsst_ob,
        # cpl_sea.f90:33-35), the anomaly series (a day's three months
        # are views of it) and the ocean model's climatology
        lat_deg = np.rad2deg(geom.lat_radians)
        kw = dict(dtype=dtype, device=self.device)
        self.slab = build_slab_coeffs(self.bd, lat_deg, dtype,
                                      sea_domains=self.cpl.sea_domains,
                                      device=self.device)
        self.wsst_ob = (torch.as_tensor(sea_domain_mask(
            "elnino", lat_deg, geom.nlon), **kw)
            if self.cpl.icsea >= 4 else None)
        self.sstan_monthly = (None if sstan_monthly is None else
                              torch.as_tensor(np.asarray(sstan_monthly),
                                              **kw))
        self.sstan_year0 = sstan_year0
        self.sstom12 = (None if sstom12 is None else
                        torch.as_tensor(np.asarray(sstom12), **kw))
        self.nsteps_day = nsteps_day
        # spectral orography (a static table)
        self.phis = self.sht.trunct(self.sht.grid_to_spec(self.bd.orog))
        self.mesh = self.grid = self.sdyn = None

    # ------------------------------------------------------------------
    # the mesh
    # ------------------------------------------------------------------

    def set_mesh(self, mesh, axis: str = "regions"):
        """Distribute the GCM over `mesh` (parallel/mesh.py Mesh; the JAX
        package's GCM.set_mesh, gcm.py:169-188): the spectral dynamics
        over ranges of the zonal wavenumber m (SpectralTransform.set_mesh
        on a copy of the transform; dycore/sharded.py), the column physics
        over latitude bands (PhysicsModel.band_view, the boundary data
        cut into the bands once), the spectral orography as m ranges.
        mesh.devices[0] must be the GCM's device.  The cgrate limiter runs
        on the m ranges and RDF on the bands, each sum that crosses the
        shards gathered in shard order and summed in the whole kernel's
        order (dycore/sharded.py, _rdf_join); RDF's patterns (phys.randfh)
        are cut into the bands here, so they are set before."""
        from speedy_ml_tpu_torch.dycore.sharded import ShardedDycore
        sht = copy.copy(self.sht)
        sht.set_mesh(mesh, axis)
        sdyn = ShardedDycore(self.dyn, sht)
        grid = sht.grid
        self.phys_bands = [self.phys.band_view(b, dev)
                           for b, dev in zip(grid.bands, mesh.devices)]
        self.bd_bands = grid.split_fields(self.bd)
        self.phis_ranges = grid.split_ranges(self.phis)
        self._band_fns = [functools.partial(self._physics_fn, phys=p, bd=b)
                          for p, b in zip(self.phys_bands, self.bd_bands)]
        # copies and copy_bytes count the moves of the runs from here
        grid.copies = grid.copy_bytes = 0
        self.sht, self.sdyn, self.grid, self.mesh = sht, sdyn, grid, mesh

    def whole(self, value):
        """A sharded value (Sharded m ranges of a SpectralState, or bands
        of a dataclass of grid fields) joined on mesh.devices[0]; any
        other value as it is."""
        if not isinstance(value, Sharded):
            return value
        if isinstance(value[0], SpectralState):
            return self.sdyn.join_state(value)
        return self.grid.join_fields(value)

    def shard_state(self, gstate: GCMState) -> GCMState:
        """gstate with its spectral state as the shards' m ranges and its
        surface, radiation carry and flux sums as their latitude bands
        (each field left as it is where it is sharded already)."""
        rep = {}
        if not isinstance(gstate.spectral, Sharded):
            rep["spectral"] = self.sdyn.split_state(gstate.spectral)
        for nm in ("sfc", "radiation", "fluxes"):
            v = getattr(gstate, nm)
            if v is not None and not isinstance(v, Sharded):
                rep[nm] = self.grid.split_fields(v)
        return dataclasses.replace(gstate, **rep) if rep else gstate

    def gather_state(self, gstate: GCMState) -> GCMState:
        """A sharded GCMState joined on mesh.devices[0] (the unsharded
        GCM's state)."""
        return dataclasses.replace(gstate, **{
            nm: self.whole(getattr(gstate, nm))
            for nm in ("spectral", "sfc", "radiation", "fluxes")})

    def shard_forcing(self, forcing) -> Sharded:
        """A DailyForcing as each shard's: its planes the band's rows,
        tcorh and qcorh the m range's (a Sharded forcing as it is)."""
        if isinstance(forcing, Sharded):
            return forcing
        g = self.grid
        per = {f.name: (g.split_ranges(getattr(forcing, f.name))
                        if f.name in ("tcorh", "qcorh") else
                        g.split_bands(getattr(forcing, f.name)))
               for f in dataclasses.fields(forcing)}
        return Sharded(DailyForcing(**{k: v[d] for k, v in per.items()})
                       for d in range(g.D))

    def window_carries(self):
        """A window's zero RadiationCarry and FluxAccumulator
        (zero_carries): one fill, or on a mesh one fill a band, each
        band's on its shard's device (Sharded)."""
        g = self.geom
        if self.mesh is None:
            return zero_carries(g.nlev, g.nlat, g.nlon, self.dtype,
                                self.device)
        c = [zero_carries(g.nlev, 2 * (p1 - p0), g.nlon, self.dtype, dev,
                          rdf_nlat=g.nlat)
             for (p0, p1), dev in zip(self.grid.bands, self.mesh.devices)]
        return Sharded(a for a, _ in c), Sharded(b for _, b in c)

    def sstan_months(self, date):
        """The observed anomalies of the (previous, this, next) month of
        `date` (a ModelDate): three (lat, lon) views of the series, months
        out of its range clamped to its edges (the reference keeps the
        anomaly constant at end-of-file); None when there is no series or
        the flags use none (isstan <= 0 and icsea < 4)."""
        if self.sstan_monthly is None or (self.cpl.isstan <= 0
                                          and self.cpl.icsea < 4):
            return None
        M = self.sstan_monthly.shape[0]
        i = (date.year - self.sstan_year0) * 12 + (date.month - 1)
        return tuple(self.sstan_monthly[k]
                     for k in np.clip([i - 1, i, i + 1], 0, M - 1))

    def sstan_for(self, date) -> Optional[torch.Tensor]:
        """Observed SST anomaly at `date` (obs_ssta + the 3-month forint,
        cpl_sea.f90:85-88 + 246-279), or None (sstan_months)."""
        months = self.sstan_months(date)
        if months is None:
            return None
        return sstan_for_window(torch.stack(months), date.tmonth)

    def couple(self, sfc: SurfaceState, fluxes, imon, fmon, *, sstan=None,
               window=None, ok=None, do_couple: bool = True, scalars=None):
        """The slab coupler (couple_daily) and the persistent surface's
        accumulation in one K21 launch: (the coupled SurfaceState, or sfc
        when do_couple is false; the FluxAccumulator of the sums, zero
        after a coupling, or None without a window).  fluxes: the sums
        (a FluxAccumulator); window: the window's FluxAccumulator, counted
        where ok (a 0-d bool tensor) is true; sstan: as slab_couple's;
        scalars: K21's device-scalar form's row (slab_couple's), or None."""
        fields = lambda f: [getattr(f, k) for k in FLUX_FIELDS]
        sfc, fluxes, window = (self.whole(v) for v in (sfc, fluxes, window))
        win = None if window is None else fields(window)
        planes, fx = slab_couple(self.bd, self.slab, sfc, fields(fluxes),
                                 (imon, fmon), self.cpl, window=win, ok=ok,
                                 do_couple=do_couple, sstan=sstan,
                                 wsst=self.wsst_ob, sstom12=self.sstom12,
                                 scalars=scalars)
        return (sfc if planes is None else coupled_state(planes),
                None if fx is None else FluxAccumulator(*fx))

    def forcing_for(self, sfc: SurfaceState, tyear) -> DailyForcing:
        """Date-dependent forcing (fordate) of the surface sfc (whole on
        mesh.devices[0] on a mesh)."""
        return self.phys.daily_forcing(self.bd, self.whole(sfc), tyear,
                                       self.dyn.sht)

    def window_entry(self, imon, fmon, tyear, sst_hybrid=None,
                     sst_bias: float = 0.0, sfc_carry=None, scalars=None):
        """(the climatological surface of (imon, fmon) with the hybrid SST,
        its forcing at tyear): init_surface_state and forcing_for in one
        K17 launch and the K5 analysis; imon, fmon and tyear host
        numbers.  sfc_carry: the persistent surface, whose slab models'
        fields the window takes (PhysicsModel.surface_and_forcing).
        scalars: K17's device-scalar form's row (surface_forcing's), or
        None."""
        return self.phys.surface_and_forcing(self.bd, imon, fmon, tyear,
                                             self.dyn.sht, sst_hybrid,
                                             sst_bias, self.cpl,
                                             self.whole(sfc_carry), scalars)

    def init_state(self, date, spectral: Optional[SpectralState] = None,
                   sst_hybrid=None, sst_bias: float = 0.0,
                   sppt_seed: int = 0) -> tuple[GCMState, DailyForcing]:
        """agcm_init: surface + radiation init for `date` (a ModelDate).
        With sppt_on the state carries the SPPT pattern's first draw and
        its generator, seeded from sppt_seed (the JAX package draws from
        PRNGKey(sppt_seed): the draws differ, their law is the same)."""
        g = self.geom
        sfc, forcing = self.window_entry(date.month - 1, date.tmonth,
                                         date.tyear, sst_hybrid, sst_bias)
        if spectral is None:
            from speedy_ml_tpu_torch.dycore.init import rest_state
            spectral = rest_state(self.dyn, self.bd.orog)[0]
        radiation, fluxes = zero_carries(g.nlev, g.nlat, g.nlon, self.dtype,
                                         self.device)
        sppt_spec = sppt_gen = None
        if self.sppt is not None:
            sppt_gen = torch.Generator(device=self.device)
            sppt_gen.manual_seed(int(sppt_seed))
            sppt_spec = self.sppt.init_state(self.sppt.noise(sppt_gen))
        state = GCMState(spectral=spectral, sfc=sfc, radiation=radiation,
                         fluxes=fluxes, istep=0, sppt_spec=sppt_spec,
                         sppt_gen=sppt_gen)
        return state, forcing

    # ------------------------------------------------------------------

    def physics_synthesis(self, state: SpectralState, j: int, dyn=None,
                          stack=None):
        """The grid [t, q, phi (K each), logp | u, v (K each)] at level j:
        one synthesis launch over K15's physics stack [t, q, phi, ps |
        u cos, v cos] (`stack`, when the step made it; else K15 alone).
        dyn: the DycoreModel (a shard's view: the band of the whole
        stack)."""
        K = self.geom.nlev
        dyn = dyn or self.dyn
        if stack is None:
            stack = spectral_stack(dyn, state, self.phis, None, j)[1]
        return dyn.sht.synthesis(stack, physics_ncos(K))

    def physics_grid(self, state: SpectralState, j: int, dyn=None,
                     stack=None):
        """Grid (ug, vg, tg, qg, phig, pslg) at level j for the physics
        (physics_synthesis, sliced)."""
        K = self.geom.nlev
        gall = self.physics_synthesis(state, j, dyn, stack)
        return (gall[3 * K + 1:4 * K + 1], gall[4 * K + 1:5 * K + 1],
                gall[0:K], gall[K:2 * K], gall[2 * K:3 * K], gall[3 * K])

    def grid_state(self, state: SpectralState, select=None):
        """The grid fields of leapfrog level 0 (iogrid 31): (atmo (4, K,
        lat, lon) = [t, u, v, q], logp, ok): K15's physics stack, K6 and
        K20.  select: None (ok is None) or (prev, safe, atmo_in, logp_in),
        which keeps the given fields where prev & safe is false
        (kernels/window_select.py).  A sharded state (a mesh) is joined
        on mesh.devices[0] first."""
        state = self.whole(state)
        return window_select(self.physics_synthesis(state, 0),
                             self.geom.nlev, select)

    def _physics_fn(self, state: SpectralState, j: int, dyn: DycoreModel,
                    sfc, forcing, carry, lradsw, sums=None, sppt=None,
                    stack=None, phys=None, bd=None):
        """Spectral state (or the step's physics stack) -> grid fields ->
        PhysicsModel.compute_with_sums.  sums: None, or (fluxes, rsteps,
        delt2), the window's flux sums, which the physics step then forms
        too (a leapfrog step).  sppt: None, or the step's SPPT pattern
        (an SpptGrid, or the JAX package's tapered pattern).  The aux is
        (carry', FluxDiag, the new FluxAccumulator or, without sums,
        None).  phys, bd: a band's PhysicsModel and boundary data (a
        mesh's shard), else the GCM's."""
        grid = self.physics_grid(state, j, dyn, stack)
        with torch.profiler.record_function("physics"):
            ut, vt, tt, qt, *aux = (phys or self.phys).compute_with_sums(
                *grid, bd=self.bd if bd is None else bd, sfc=sfc, forcing=forcing, carry=carry,
                lradsw=lradsw, sums=sums, sppt_pattern=sppt)
        return GridTendencies(u=ut, v=vt, t=tt, tr=qt[None]), tuple(aux)

    def leapfrog(self, gstate: GCMState, forcing: DailyForcing,
                 eta: Optional[torch.Tensor] = None) -> GCMState:
        """One filtered leapfrog step with physics (stloop body); its
        physics step also forms the window's flux sums (K12_pbl_flux).
        SPPT runs when the GCM has it and the state carries its pattern
        (a window built without it, as the hybrid's cold start, runs
        without SPPT, as in the JAX package): the draw is eta (K, mx, nx)
        complex when given, else drawn from the state's generator."""
        if self.mesh is not None:
            return self._leapfrog_mesh(gstate, forcing, eta)
        lradsw = gstate.istep % NSTRAD == 0   # mod(istep, 3) == 1, 1-based
        sums = (gstate.fluxes, 1.0 / self.nsteps_day, self.dyn.delt2)
        sppt_spec, pattern = gstate.sppt_spec, None
        if self.sppt is not None and gstate.sppt_spec is not None:
            if eta is None:
                eta = self.sppt.noise(gstate.sppt_gen)
            sppt_spec = self.sppt.step(gstate.sppt_spec, eta)       # K24
            pattern = SpptGrid(self.sht.spec_to_grid(sppt_spec),    # K6
                               self.sppt.mu)
        spec, (carry, _, fluxes) = self.dyn.leapfrog_step(
            gstate.spectral, self.phis, physics_fn=self._physics_fn,
            physics_args=(gstate.sfc, forcing, gstate.radiation, lradsw,
                          sums, pattern),
            corrections=(forcing.tcorh, forcing.qcorh))
        return GCMState(spectral=spec, sfc=gstate.sfc, radiation=carry,
                        fluxes=fluxes, istep=gstate.istep + 1,
                        sppt_spec=sppt_spec, sppt_gen=gstate.sppt_gen)

    def _rdf_join(self, ptends, auxs):
        """The bands' physics finished after their column kernels
        (PhysicsModel.finish): on a shortwave step RDF's sums of every band
        (K25's sums form) gathered on every shard in latitude order, then
        each band's RDF (K25's band form) and SPPT.  The aux loses its
        BandTail."""
        tails = [a[3] for a in auxs]
        sums = [None] * self.grid.D
        if tails[0].xs is not None:
            sums = self.grid.all_bands([rdf_sums(t.xs) for t in tails],
                                       dim=-1)
        out_t, out_a = [], []
        for phys, pt, aux, tail, sm in zip(self.phys_bands, ptends, auxs,
                                           tails, sums):
            ut, vt, tt, qt, carry = phys.finish(
                pt.u, pt.v, pt.t, pt.tr[0], aux[0], tail.xs,
                tail.sppt_pattern, sm)
            out_t.append(GridTendencies(u=ut, v=vt, t=tt, tr=qt[None]))
            out_a.append((carry,) + tuple(aux[1:3]))
        return out_t, out_a

    def _join(self):
        """The sharded dycore's physics_join: _rdf_join with RDF, else
        None."""
        return (self._rdf_join if self.phys_bands[0].randfh is not None
                else None)

    def _leapfrog_mesh(self, gstate, forcing, eta=None) -> GCMState:
        """leapfrog on the shards (dycore/sharded.py): each band's physics
        with its surface, forcing, carry and flux sums; SPPT's pattern
        stepped whole on mesh.devices[0] and synthesized into each band."""
        gs, fc = self.shard_state(gstate), self.shard_forcing(forcing)
        D = self.grid.D
        lradsw = gs.istep % NSTRAD == 0
        rsteps, delt2 = 1.0 / self.nsteps_day, self.dyn.delt2
        sppt_spec, patterns = gs.sppt_spec, [None] * D
        if self.sppt is not None and gs.sppt_spec is not None:
            if eta is None:
                eta = self.sppt.noise(gs.sppt_gen)
            sppt_spec = self.sppt.step(gs.sppt_spec, eta)           # K24
            patterns = [SpptGrid(sh.synthesis(s), self.sppt.mu.to(s.device))
                        for sh, s in zip(self.sht.shards,
                                         self.grid.broadcast(sppt_spec))]
        args = [(gs.sfc[d], fc[d], gs.radiation[d], lradsw,
                 (gs.fluxes[d], rsteps, delt2), patterns[d])
                for d in range(D)]
        spec, aux = self.sdyn.leapfrog_step(
            gs.spectral, self.phis_ranges, self._band_fns, args,
            [(f.tcorh, f.qcorh) for f in fc], self._join())
        return GCMState(spectral=spec, sfc=gs.sfc,
                        radiation=Sharded(a[0] for a in aux),
                        fluxes=Sharded(a[2] for a in aux),
                        istep=gs.istep + 1, sppt_spec=sppt_spec,
                        sppt_gen=gs.sppt_gen)

    def stepone(self, gstate: GCMState, forcing: DailyForcing) -> GCMState:
        """Cold-start double half-step with physics (ini_stepone.f90)."""
        if self.mesh is not None:
            gs, fc = self.shard_state(gstate), self.shard_forcing(forcing)
            spec, aux = self.sdyn.stepone(
                gs.spectral, self.phis_ranges, self._band_fns,
                [(gs.sfc[d], fc[d], gs.radiation[d], True)
                 for d in range(self.grid.D)],
                [(f.tcorh, f.qcorh) for f in fc], self._join())
            return dataclasses.replace(gs, spectral=spec, radiation=Sharded(
                a[0] for a in aux))
        spec, (carry, _, _) = self.dyn.stepone(
            gstate.spectral, self.phis, physics_fn=self._physics_fn,
            physics_args=(gstate.sfc, forcing, gstate.radiation, True),
            corrections=(forcing.tcorh, forcing.qcorh))
        return dataclasses.replace(gstate, spectral=spec, radiation=carry)

    def run_window(self, gstate: GCMState, forcing: DailyForcing,
                   nsteps: int) -> GCMState:
        """`nsteps` leapfrog steps (a 6-h window = 24 steps)."""
        if self.mesh is not None:
            gstate = self.shard_state(gstate)
            forcing = self.shard_forcing(forcing)
        for _ in range(nsteps):
            gstate = self.leapfrog(gstate, forcing)
        return gstate

    def run_days(self, gstate: GCMState, date, ndays: int,
                 stepone_first: bool = False):
        """agcm_main day loop: fordate (K17's forcing form and K5), the
        sums zeroed (one fill), stepone on the first day when asked, a
        day's leapfrog steps, the date advanced, then the coupler at the
        new date with its observed anomaly (K21's day form).  istep runs
        on across days.  Returns (state, date)."""
        g = self.geom
        for _ in range(ndays):
            forcing = self.forcing_for(gstate.sfc, date.tyear)
            if self.mesh is not None:
                forcing = self.shard_forcing(forcing)
            gstate = dataclasses.replace(gstate, fluxes=FluxAccumulator.zeros(
                g.nlat, g.nlon, self.dtype, self.device))
            if stepone_first:
                gstate = self.stepone(gstate, forcing)
                stepone_first = False
            gstate = self.run_window(gstate, forcing, self.nsteps_day)
            date = date.advance_day()
            # the exchange at day end (agcm_to_coupler/coupler_to_agcm)
            months = self.sstan_months(date)
            sfc, _ = self.couple(
                gstate.sfc, gstate.fluxes, date.month - 1, date.tmonth,
                sstan=None if months is None else (months, date.tmonth))
            gstate = dataclasses.replace(gstate, sfc=sfc)
        return gstate, date

"""The atmospheric GCM: dynamics + physics + the surface state.

Counterpart of the JAX package's gcm.py (the reference's at_gcm.f90 and
dyn_stloop.f90): `GCM` holds the static tables on one device and exposes
the step functions; one window is `nsteps` leapfrog steps (the hybrid's
6-h window is 24 x 900 s).  The step counter is a host integer, so the
shortwave cadence (every NSTRAD steps) is a Python branch and a window
makes no host read.

The daily day loop with the slab coupler (run_days) and SPPT come with
later slices.  Without a BoundaryData the GCM reads the reference's
fort.20-26 files from bc_path or $SPEEDY_ML_BC_PATH.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.core.constants import PhysicalConstants
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.dycore.model import DycoreModel, GridTendencies
from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.kernels.spectral_stack import (physics_ncos,
                                                        spectral_stack)
from speedy_ml_tpu_torch.kernels.window_select import window_select
from speedy_ml_tpu_torch.physics.boundaries import (BoundaryData,
                                                    boundary_path,
                                                    load_boundary_data)
from speedy_ml_tpu_torch.physics.driver import (OPTIONAL_SLICE,
                                                DailyForcing, PhysicsModel,
                                                RadiationCarry, zero_views)
from speedy_ml_tpu_torch.physics.land_sea import (SLAB_SLICE, CplFlags,
                                                  SurfaceState)

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


def zero_carries(K, nlat, nlon, dtype, device=None):
    """A window's zero RadiationCarry and FluxAccumulator, all eleven
    fields views of one zeroed buffer: one fill on the card."""
    shapes = RadiationCarry.shapes(K, nlat, nlon)
    v = zero_views(shapes + [(nlat, nlon)] * 4, dtype, device)
    return RadiationCarry(*v[:len(shapes)]), FluxAccumulator(*v[len(shapes):])


@dataclasses.dataclass(frozen=True)
class GCMState:
    """Everything a window advances.  istep is a host int."""
    spectral: SpectralState
    sfc: SurfaceState
    radiation: RadiationCarry
    fluxes: FluxAccumulator
    istep: int = 0


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
        # scan_unroll: the JAX package's leapfrog steps unrolled per scan
        # iteration, numerically identical; the port runs its steps one by
        # one, so any value gives the same GCM
        self.device = resolve_device(device)
        if sppt_on:
            raise NotImplementedError(f"SPPT comes with {OPTIONAL_SLICE}")
        if (sstan_monthly is not None or sstom12 is not None
                or sstan_year0 != 1990):
            raise NotImplementedError(f"SST anomalies come with {SLAB_SLICE}")
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
        if bd is None:
            bd = load_boundary_data(geom, self.sht, constants.grav, bc_path)
        self.bd = bd.to(device=self.device, dtype=dtype)
        self.cpl = cpl_flags if cpl_flags is not None else CplFlags()
        self.nsteps_day = nsteps_day
        # spectral orography (a static table)
        self.phis = self.sht.trunct(self.sht.grid_to_spec(self.bd.orog))

    def set_mesh(self, mesh, axis: str = "regions"):
        raise NotImplementedError("the multi-GPU GCM comes with the "
                                  "multi-GPU slice of the port (A16)")

    def forcing_for(self, sfc: SurfaceState, tyear) -> DailyForcing:
        """Date-dependent forcing (fordate) of the surface sfc."""
        return self.phys.daily_forcing(self.bd, sfc, tyear, self.sht)

    def window_entry(self, imon, fmon, tyear, sst_hybrid=None,
                     sst_bias: float = 0.0):
        """(the climatological surface of (imon, fmon) with the hybrid SST,
        its forcing at tyear): init_surface_state and forcing_for in one
        K17 launch and the K5 analysis; imon, fmon and tyear host
        numbers."""
        return self.phys.surface_and_forcing(self.bd, imon, fmon, tyear,
                                             self.sht, sst_hybrid, sst_bias,
                                             self.cpl)

    def init_state(self, date, spectral: Optional[SpectralState] = None,
                   sst_hybrid=None, sst_bias: float = 0.0
                   ) -> tuple[GCMState, DailyForcing]:
        """agcm_init: surface + radiation init for `date` (a ModelDate)."""
        g = self.geom
        sfc, forcing = self.window_entry(date.month - 1, date.tmonth,
                                         date.tyear, sst_hybrid, sst_bias)
        if spectral is None:
            from speedy_ml_tpu_torch.dycore.init import rest_state
            spectral = rest_state(self.dyn, self.bd.orog)[0]
        radiation, fluxes = zero_carries(g.nlev, g.nlat, g.nlon, self.dtype,
                                         self.device)
        state = GCMState(spectral=spectral, sfc=sfc, radiation=radiation,
                         fluxes=fluxes, istep=0)
        return state, forcing

    # ------------------------------------------------------------------

    def physics_synthesis(self, state: SpectralState, j: int, dyn=None,
                          stack=None):
        """The grid [t, q, phi (K each), logp | u, v (K each)] at level j:
        one synthesis launch over K15's physics stack [t, q, phi, ps |
        u cos, v cos] (`stack`, when the step made it; else K15 alone)."""
        K = self.geom.nlev
        if stack is None:
            stack = spectral_stack(dyn or self.dyn, state, self.phis, None,
                                   j)[1]
        return self.sht.synthesis(stack, physics_ncos(K))

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
        (kernels/window_select.py)."""
        return window_select(self.physics_synthesis(state, 0),
                             self.geom.nlev, select)

    def _physics_fn(self, state: SpectralState, j: int, dyn: DycoreModel,
                    sfc, forcing, carry, lradsw, sums=None, stack=None):
        """Spectral state (or the step's physics stack) -> grid fields ->
        PhysicsModel.compute_with_sums.  sums: None, or (fluxes, rsteps,
        delt2), the window's flux sums, which the physics step then forms
        too (a leapfrog step).  The aux is (carry', FluxDiag, the new
        FluxAccumulator or, without sums, None)."""
        grid = self.physics_grid(state, j, dyn, stack)
        with torch.profiler.record_function("physics"):
            ut, vt, tt, qt, *aux = self.phys.compute_with_sums(
                *grid, bd=self.bd, sfc=sfc, forcing=forcing, carry=carry,
                lradsw=lradsw, sums=sums)
        return GridTendencies(u=ut, v=vt, t=tt, tr=qt[None]), tuple(aux)

    def leapfrog(self, gstate: GCMState, forcing: DailyForcing) -> GCMState:
        """One filtered leapfrog step with physics (stloop body); its
        physics step also forms the window's flux sums (K12_pbl_flux)."""
        lradsw = gstate.istep % NSTRAD == 0   # mod(istep, 3) == 1, 1-based
        sums = (gstate.fluxes, 1.0 / self.nsteps_day, self.dyn.delt2)
        spec, (carry, _, fluxes) = self.dyn.leapfrog_step(
            gstate.spectral, self.phis, physics_fn=self._physics_fn,
            physics_args=(gstate.sfc, forcing, gstate.radiation, lradsw,
                          sums),
            corrections=(forcing.tcorh, forcing.qcorh))
        return GCMState(spectral=spec, sfc=gstate.sfc, radiation=carry,
                        fluxes=fluxes, istep=gstate.istep + 1)

    def stepone(self, gstate: GCMState, forcing: DailyForcing) -> GCMState:
        """Cold-start double half-step with physics (ini_stepone.f90)."""
        spec, (carry, _, _) = self.dyn.stepone(
            gstate.spectral, self.phis, physics_fn=self._physics_fn,
            physics_args=(gstate.sfc, forcing, gstate.radiation, True),
            corrections=(forcing.tcorh, forcing.qcorh))
        return dataclasses.replace(gstate, spectral=spec, radiation=carry)

    def run_window(self, gstate: GCMState, forcing: DailyForcing,
                   nsteps: int) -> GCMState:
        """`nsteps` leapfrog steps (a 6-h window = 24 steps)."""
        for _ in range(nsteps):
            gstate = self.leapfrog(gstate, forcing)
        return gstate

    def run_days(self, gstate, date, ndays, stepone_first=False):
        raise NotImplementedError(f"the day loop with the slab coupler "
                                  f"comes with {SLAB_SLICE}")

"""Physics driver: the parametrization suite for one time step.

Counterpart of the JAX package's physics/driver.py (the reference's
phy_phypar.f90).  It takes the grid fields at the physics time level, the
coupled-surface state, the daily forcing and the radiation carry
(shortwave runs every nstrad steps; its results persist in the carry),
and returns grid tendencies, the new carry and the flux diagnostics.

The step is four kernel launches (hot spot B2 of ROADMAP queue B), each
through its wrapper in kernels/: K9 column_moist (humidity, convection,
large-scale condensation), or on the shortwave steps K9_moist_shortwave
moist_shortwave (the same and the clouds and the shortwave);
K10a_down_surface down_surface (the downward longwave and the surface
fluxes); K10b radlw_up; K12 column_pbl (the vertical diffusion and the
sums), or on a leapfrog step K12_pbl_flux pbl_flux (the same and the
window's flux sums).  On a CUDA tensor each launches its hand-written
kernel and nothing else runs on the card; on a CPU tensor each runs its
plain version.  The shortwave cadence is a Python branch on a host bool;
data-dependent level indices (itop, icltop) stay on the device, never
read by the host.

The reference's optional physics, off by default: with randfh set (RDF)
one K25 launch after the four adds the random diabatic forcing to the
temperature tendency (and on a shortwave step forms the carry's randfv
from the step's heating); with an SPPT pattern one K24 launch then
multiplies the four tendencies by (1 + r).
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.core.constants import GAMMA_LAPSE
from speedy_ml_tpu_torch.kernels import column_longwave
from speedy_ml_tpu_torch.kernels.column_moist import (column_moist,
                                                      moist_shortwave,
                                                      moist_tables)
from speedy_ml_tpu_torch.kernels.column_pbl import (column_pbl, pbl_flux,
                                                    pbl_tables)
from speedy_ml_tpu_torch.kernels.column_shortwave import (
    ShortwaveForcing, shortwave_tables)
from speedy_ml_tpu_torch.kernels.surface_fluxes import surface_tables
from speedy_ml_tpu_torch.kernels.surface_forcing import (FORCING, DayArgs,
                                                         surface_forcing)
from speedy_ml_tpu_torch.physics import radiation as rad
from speedy_ml_tpu_torch.physics.boundaries import BoundaryData
from speedy_ml_tpu_torch.kernels.rdf import RdfHeating, rdf, rdf_band
from speedy_ml_tpu_torch.kernels.sppt import sppt_perturb
from speedy_ml_tpu_torch.physics.land_sea import (CplFlags, SurfaceState,
                                                  surface_state)
from speedy_ml_tpu_torch.physics.randfor import rdf_weights

VIEW_ALIGN = 64   # elements between the starts of zero_views' fields


def zero_views(shapes, dtype, device=None) -> list:
    """Zero tensors of the given shapes as views of one zeroed buffer: one
    fill on the card, not one a field.  Each view starts at a multiple of
    VIEW_ALIGN elements, aligned as an allocation of its own would be."""
    sizes = [math.prod(s) for s in shapes]
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // VIEW_ALIGN) * VIEW_ALIGN)
    buf = torch.zeros(starts[-1], dtype=dtype, device=device)
    return [buf[o:o + n].view(s) for o, n, s in zip(starts, sizes, shapes)]


def _on_device(val, dev):
    """val with its tensors (and those of a NamedTuple or dataclass of
    them) on dev; the same object where nothing moves."""
    if torch.is_tensor(val):
        return val.to(dev)
    if isinstance(val, tuple) and hasattr(val, "_fields"):
        return val._make(_on_device(x, dev) for x in val)
    if dataclasses.is_dataclass(val) and not isinstance(val, type):
        return dataclasses.replace(val, **{
            f.name: _on_device(getattr(val, f.name), dev)
            for f in dataclasses.fields(val) if f.init})
    return val


@dataclasses.dataclass(frozen=True)
class RadiationCarry:
    """State persisting between shortwave radiation steps."""
    tau2: torch.Tensor      # (K, 4, lat, lon) LW transmissivities
    stratc: torch.Tensor    # (2, lat, lon)
    tt_rsw: torch.Tensor    # (K, lat, lon) SW heating (tendency units)
    ssrd: torch.Tensor      # (lat, lon) surface downward SW
    ssr: torch.Tensor       # net surface SW
    tsr: torch.Tensor       # net TOA SW
    randfv: torch.Tensor    # (2, lat, K) RDF vertical modulation

    @staticmethod
    def shapes(K, nlat, nlon, rdf_nlat=None) -> list:
        """The fields' shapes, in the field order (randfv's latitudes
        rdf_nlat, default nlat)."""
        G = (nlat, nlon)
        return [(K, 4) + G, (2,) + G, (K,) + G, G, G, G,
                (2, rdf_nlat or nlat, K)]

    @staticmethod
    def zeros(K, nlat, nlon, dtype, device=None):
        """A zero carry: views of one zeroed buffer (one fill on the
        card)."""
        shapes = RadiationCarry.shapes(K, nlat, nlon)
        return RadiationCarry(*zero_views(shapes, dtype, device))


@dataclasses.dataclass(frozen=True)
class DailyForcing:
    """Daily radiative/surface forcing (fordate, ini_fordate.f90)."""
    fsol: torch.Tensor
    ozupp: torch.Tensor
    ozone: torch.Tensor
    zenit: torch.Tensor
    stratz: torch.Tensor
    alb_l: torch.Tensor
    alb_s: torch.Tensor
    albsfc: torch.Tensor
    snowc: torch.Tensor
    tcorh: torch.Tensor     # spectral T diffusion correction
    qcorh: torch.Tensor     # spectral q diffusion correction


class FluxDiag(NamedTuple):
    """Per-step fluxes for the coupler and the hybrid output."""
    precnv: torch.Tensor
    precls: torch.Tensor
    hflux_l: torch.Tensor
    hflux_s: torch.Tensor
    hflux_i: torch.Tensor
    olr: torch.Tensor
    ts: torch.Tensor


class SpptGrid(NamedTuple):
    """SPPT's pattern as the leapfrog step hands it to the physics: the
    synthesized grid (K, lat, lon), not yet clipped, and the taper mu
    (K,); K24 forms clip(grid, -1, 1) * mu."""
    grid: torch.Tensor
    mu: torch.Tensor


class BandTail(NamedTuple):
    """What a band's physics step leaves to run after every band's column
    kernels on a mesh with RDF (PhysicsModel.finish): the step's heating
    on a shortwave step (else None) and its SPPT pattern (or None)."""
    xs: object
    sppt_pattern: object


class PhysicsModel:
    """Static tables on one device (default CUDA; raises without one
    unless device="cpu") + the phypar step function."""

    def __init__(self, geom, constants, dtype=torch.float32, randfh=None,
                 *, device=None):
        self.device = resolve_device(device)
        self.geom = geom
        self.const = constants
        self.dtype = dtype
        hsg = np.asarray(geom.half_sigma, dtype=np.float64)
        sig = 0.5 * (hsg[1:] + hsg[:-1])
        dsig = hsg[1:] - hsg[:-1]
        sigl = np.log(sig)
        # half-level interpolation weights (inphys, ini_inphys.f90:39-45)
        wvi1 = np.zeros(geom.nlev)
        wvi2 = np.zeros(geom.nlev)
        for k in range(geom.nlev - 1):
            wvi1[k] = 1.0 / (sigl[k + 1] - sigl[k])
            wvi2[k] = (np.log(hsg[k + 1]) - sigl[k]) * wvi1[k]
        wvi2[geom.nlev - 1] = (np.log(0.99) - sigl[geom.nlev - 1]) \
            * wvi1[geom.nlev - 2]
        np_dt = np.float64 if dtype == torch.float64 else np.float32
        t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64),
                                      device=self.device).to(dtype)
        self.sig, self.sigh, self.dsig = sig, hsg, dsig
        self.wvi2 = np.asarray(wvi2, dtype=np_dt)
        self.wvi2_t = t(self.wvi2)
        self.wvi2_bot = float(wvi2[geom.nlev - 1])
        self.sigl_bot = float(sigl[geom.nlev - 1])
        grdsig = np.asarray(constants.grav / (dsig * constants.p0),
                            dtype=np_dt)
        self.grdsig = t(grdsig)
        self.grdscp = t(np.asarray(grdsig / constants.cp, dtype=np_dt))
        self.sig_t = t(sig)
        self.slat_t, self.clat_t = t(geom.sin_lat), t(geom.cos_lat)
        # the diffusion corrections' lapse-rate constants
        # (ini_fordate.f90:72-113), Python numbers as the JAX package's
        self.gamlat = GAMMA_LAPSE / (1000.0 * constants.grav)
        self.pexp = 1.0 / (constants.rgas / constants.akap * 0.0
                           + 287.0 * self.gamlat)
        self.fband = rad.build_fband()
        # the tables of the column kernels and their plain versions
        self.moist_tabs = moist_tables(sig, dsig, self.sig_t, self.wvi2_t,
                                       self.grdsig, self.grdscp, constants)
        self.lw_tabs = column_longwave.longwave_tables(
            self.wvi2, dsig, constants.sbc, self.fband, dtype, self.device)
        self.sfc_tabs = surface_tables(self.sigl_bot, self.wvi2_bot,
                                       constants, dtype, self.device)
        self.pbl_tabs = pbl_tables(sig, hsg, dsig, self.grdsig, self.grdscp,
                                   constants)
        self.sw_tabs = shortwave_tables(sig, dsig, self.grdscp)
        # random diabatic forcing: the horizontal patterns (2, nlat, nlon)
        # or None (RDF off, the reference's default: nstrdf=0), and
        # xs_rdf's two vertical weights
        self.rdf_w = rdf_weights(sig, geom.nlon, dtype, self.device)
        self.randfh = randfh
        # the latitude band (p0, p1) of a mesh's band_view, None whole
        self.band = None

    @property
    def randfh(self):
        return self._randfh

    @randfh.setter
    def randfh(self, value):
        """The RDF patterns (2, nlat, nlon), stored in the model's dtype on
        its device (init_randfh's float32 array is taken as it is), or
        None."""
        if value is not None:
            g = self.geom
            value = torch.as_tensor(np.asarray(value) if not
                                    torch.is_tensor(value) else value)
            if tuple(value.shape) != (2, g.nlat, g.nlon):
                raise ValueError(f"randfh: shape {tuple(value.shape)}, "
                                 f"expected (2, {g.nlat}, {g.nlon})")
            value = value.to(device=self.device, dtype=self.dtype) \
                .contiguous()
        self._randfh = value

    # ------------------------------------------------------------------

    def band_view(self, band, device) -> "PhysicsModel":
        """A copy of the model for one latitude band of a mesh (GCM.set_mesh;
        band = (p0, p1), parallel/mesh.py lat_bands) on `device`: the
        per-latitude tables (sin and cos of latitude) and RDF's patterns
        (randfh, as it is set when the view is made) as the band's rows,
        the other tables on the device.  Its compute runs the band's
        columns: K9, K9_moist_shortwave, K10a_down_surface, K10b and K12
        take (K, rows, lon) fields and index their (lat,) tables by the
        field's own rows, so a band needs no offset.  With RDF its
        compute_with_sums stops after the column kernels (RDF's smoothing
        crosses the bands): GCM runs `finish` on every band once each
        band's sums are gathered."""
        from speedy_ml_tpu_torch.parallel.mesh import band_rows
        v = copy.copy(self)
        dev = torch.device(device)
        for nm, val in vars(self).items():
            setattr(v, nm, _on_device(val, dev))
        v.device = dev
        nlat = self.geom.nlat
        v.slat_t = band_rows(self.slat_t, band, nlat, dim=0).to(dev)
        v.clat_t = band_rows(self.clat_t, band, nlat, dim=0).to(dev)
        if self.randfh is not None:
            v._randfh = band_rows(self.randfh, band, nlat).to(dev)
        v.band = tuple(band)
        return v

    def day_args(self, tyear) -> DayArgs:
        """What K17 needs for the forcing of day tyear (a host number; a
        0-d tensor only on the CPU)."""
        return DayArgs(tyear, self.slat_t, self.clat_t, self.gamlat,
                       self.pexp)

    def daily_forcing(self, bd: BoundaryData, sfc: SurfaceState, tyear,
                      sht) -> DailyForcing:
        """fordate(1): solar forcing, surface albedo, diffusion
        corrections, of the surface sfc: one K17 launch (the grid fields,
        the zonal solar fields as contiguous (lat, lon) planes, as the
        shortwave kernel reads them) and one K5 launch (tcorh and
        qcorh)."""
        _, frc = surface_forcing(bd, sfc=sfc, day=self.day_args(tyear))
        return self.forcing_of(frc, sht)

    def surface_and_forcing(self, bd: BoundaryData, imon, fmon, tyear, sht,
                            sst_hybrid=None, sst_bias: float = 0.0,
                            flags: CplFlags = CplFlags(), sfc_carry=None,
                            scalars=None):
        """(init_surface_state(bd, imon, fmon, sst_hybrid, sst_bias,
        flags), daily_forcing of that surface at tyear) in one K17 launch
        and the K5 analysis: the window's entry.  sfc_carry: the
        persistent surface (a SurfaceState) whose slab models' fields
        replace the climatology's (the ini_land restart path: stl_lm and
        stl_am its stl_lm, sst_om its sst_om, tice_om and tice_am its
        tice_om; sst_am stays), the forcing reading its stl_lm (K17's
        carry form).  scalars: None, or K17's device-scalar form's row on
        the card (surface_forcing), from which the kernel reads the date."""
        planes, frc = surface_forcing(
            bd, month=(imon, fmon), sst_hybrid=sst_hybrid,
            sst_bias=sst_bias, day=self.day_args(tyear),
            stl_carry=None if sfc_carry is None else sfc_carry.stl_lm,
            scalars=scalars)
        sfc = surface_state(planes, flags.icsea)
        if sfc_carry is not None:
            sfc = dataclasses.replace(
                sfc, stl_lm=sfc_carry.stl_lm, stl_am=sfc_carry.stl_lm,
                sst_om=sfc_carry.sst_om, tice_om=sfc_carry.tice_om,
                tice_am=sfc_carry.tice_om)
        return sfc, self.forcing_of(frc, sht)

    @staticmethod
    def forcing_of(frc, sht) -> DailyForcing:
        """The DailyForcing of K17's FORCING planes: the planes as they
        are, tcorh and qcorh from one analysis of the first two."""
        p = dict(zip(FORCING, frc))
        spec = sht.analysis(frc[:2])
        return DailyForcing(fsol=p["fsol"], ozupp=p["ozupp"],
                            ozone=p["ozone"], zenit=p["zenit"],
                            stratz=p["stratz"], alb_l=p["alb_l"],
                            alb_s=p["alb_s"], albsfc=p["albsfc"],
                            snowc=p["snowc"], tcorh=spec[0], qcorh=spec[1])

    # ------------------------------------------------------------------

    def compute(self, ug, vg, tg, qg, phig, pslg, *, bd: BoundaryData,
                sfc: SurfaceState, forcing: DailyForcing,
                carry: RadiationCarry, lradsw: bool, sppt_pattern=None):
        """Physics tendencies from grid fields at the physics time level:
        the JAX package's PhysicsModel.compute.

        Inputs (K, lat, lon) except pslg (lat, lon); lradsw a host bool
        (shortwave every nstrad steps).  Returns (utend, vtend, ttend,
        qtend, carry', FluxDiag), as the JAX method does.  The step is the
        kernels K9 (or K9_moist_shortwave with the shortwave),
        K10a_down_surface, K10b and K12 in this order; the stage methods
        below can be called (and timed) alone."""
        return self.compute_with_sums(
            ug, vg, tg, qg, phig, pslg, bd=bd, sfc=sfc, forcing=forcing,
            carry=carry, lradsw=lradsw, sppt_pattern=sppt_pattern)[:6]

    def compute_with_sums(self, ug, vg, tg, qg, phig, pslg, *,
                          bd: BoundaryData, sfc: SurfaceState,
                          forcing: DailyForcing, carry: RadiationCarry,
                          lradsw: bool, sppt_pattern=None, sums=None):
        """`compute` and, on a leapfrog step, the window's flux sums in the
        same launches.  sums: None, or (fluxes, rsteps, delt2): the
        window's FluxAccumulator and the Python factors of its sums
        (GCM.leapfrog), formed by K12_pbl_flux in place of K12.  Returns
        compute's six values and the new FluxAccumulator (None without
        sums).

        With randfh set (RDF), one K25 launch after the column kernels
        adds the random diabatic forcing to ttend (and on a shortwave step
        forms the carry's new randfv).  sppt_pattern: None, the JAX
        package's tapered pattern (K, lat, lon), for which each tendency
        is multiplied by (1 + pattern), or an SpptGrid (the synthesized
        pattern and mu: K24 clips and tapers it); one K24 launch
        multiplies the four tendencies, after RDF (finish).  On a band of
        a mesh with RDF the eighth value is the step's BandTail, and RDF
        and SPPT have not run."""
        # --- humidity, convection, large-scale condensation, and every
        # nstrad steps clouds and shortwave radiation (K9, or
        # K9_moist_shortwave)
        m, carry = self.moist(tg, qg, phig, pslg, bd, forcing, carry, lradsw)
        # --- longwave down and the surface fluxes (K10a_down_surface)
        (slrd, dfabs_lw, flux_bands, st4a), fx = self.down_surface(
            m, ug, vg, tg, phig, bd, sfc, forcing, carry)
        # --- longwave up (K10b)
        slr, olr, dfabs_lw = column_longwave.radlw_up(
            tg, fx.tsfc, slrd, fx.slru[2], dfabs_lw, flux_bands, st4a,
            carry.tau2, carry.stratc, self.lw_tabs)
        # --- vertical diffusion, the sums and the fluxes for the coupler,
        # with the window's flux sums on a leapfrog step (K12, or
        # K12_pbl_flux)
        ut, vt, ttend, qtend, diag, fluxes = self.tendency_sums(
            m, phig, carry, sfc, fx, dfabs_lw, olr, sums)
        xs = (RdfHeating(ttm=m.ttend, tt_rsw=carry.tt_rsw, dfabs=dfabs_lw,
                         rps=m.rps, grdscp=self.pbl_tabs.grdscp,
                         w=self.rdf_w)
              if self.randfh is not None and lradsw else None)
        if self.band is not None and self.randfh is not None:
            # a band of a mesh: RDF and SPPT wait for every band's sums
            return (ut, vt, ttend, qtend, carry, diag, fluxes,
                    BandTail(xs, sppt_pattern))
        ut, vt, ttend, qtend, carry = self.finish(ut, vt, ttend, qtend,
                                                  carry, xs, sppt_pattern)
        return ut, vt, ttend, qtend, carry, diag, fluxes

    def finish(self, ut, vt, ttend, qtend, carry, xs=None, sppt_pattern=None,
               sums=None):
        """The step's optional physics after its column kernels: RDF (K25;
        xs the shortwave step's heating or None) and then SPPT (K24).  On a
        band of a mesh RDF is K25's band form, whose sums are every band's
        gathered (2, K, nlat) on a shortwave step (else None).  Returns
        (utend, vtend, ttend, qtend, carry')."""
        # --- random diabatic forcing (phy_phypar.f90:202-215; K25)
        if self.randfh is not None:
            if self.band is None:
                ttend, randfv = rdf(ttend, self.randfh, carry.randfv, xs)
            else:
                ttend, randfv = rdf_band(ttend, self.randfh, carry.randfv,
                                         self.band, sums)
            carry = dataclasses.replace(carry, randfv=randfv)
        # --- SPPT on the physics tendencies (phy_phypar.f90:218-228; K24)
        if sppt_pattern is not None:
            grid, mu = (sppt_pattern if isinstance(sppt_pattern, SpptGrid)
                        else (sppt_pattern, None))
            ut, vt, ttend, qtend = sppt_perturb((ut, vt, ttend, qtend),
                                                grid, mu)
        return ut, vt, ttend, qtend, carry

    def moist(self, tg, qg, phig, pslg, bd, forcing, carry, lradsw):
        """Humidity, convection and large-scale condensation (K9), and
        with lradsw the clouds and the shortwave in the same launch
        (K9_moist_shortwave): (MoistColumns, the radiation carry)."""
        if not lradsw:
            return column_moist(tg, qg, phig, pslg, self.moist_tabs), carry
        sol = rad.SolarForcing(fsol=forcing.fsol, ozupp=forcing.ozupp,
                               ozone=forcing.ozone, zenit=forcing.zenit,
                               stratz=forcing.stratz)
        m, (tau2, stratc, tt_rsw, ssrd, ssr, tsr) = moist_shortwave(
            tg, qg, phig, pslg, self.moist_tabs,
            ShortwaveForcing(fmask=bd.fmask_l, sol=sol,
                             albsfc=forcing.albsfc, tabs=self.sw_tabs))
        return m, RadiationCarry(tau2=tau2, stratc=stratc, tt_rsw=tt_rsw,
                                 ssrd=ssrd, ssr=ssr, tsr=tsr,
                                 randfv=carry.randfv)

    def down_surface(self, m, ug, vg, tg, phig, bd, sfc, forcing, carry):
        """The downward longwave and the surface fluxes
        (K10a_down_surface): ((slrd, dfabs, flux_bands, st4a),
        SurfaceFluxes)."""
        return column_longwave.down_surface(
            tg, carry.tau2, m.psg, ug, vg, m.qg, phig, phi0=bd.phis0,
            fmask=bd.fmask_l, tland=sfc.stl_am, tsea=sfc.sst_am,
            swav=sfc.soilw_am, ssrd=carry.ssrd, forog=bd.forog,
            alb_l=forcing.alb_l, alb_s=forcing.alb_s, snowc=forcing.snowc,
            clat=self.clat_t, lw_tabs=self.lw_tabs, sfc_tabs=self.sfc_tabs)

    def tendency_sums(self, m, phig, carry, sfc, fx, dfabs_lw, olr,
                      sums=None):
        """The vertical diffusion and the sums (K12): the radiative
        heating and the diffusion tendencies (with the surface fluxes on
        the lowest level) summed onto the moist ones, and the fluxes for
        the coupler.  Returns (utend, vtend, ttend, qtend, FluxDiag, the new
        FluxAccumulator or None).  sums: None, or (fluxes, rsteps, delt2)
        as in compute_with_sums: the window's flux sums in the same launch
        (K12_pbl_flux)."""
        args = (m, phig, fx, carry.tt_rsw, carry.ssrd, dfabs_lw, sfc.tice_am,
                sfc.sice_am, self.pbl_tabs)
        if sums is None:
            (ut, vt, ttend, qtend, hflux_i), fluxes = column_pbl(*args), None
        else:
            ut, vt, ttend, qtend, hflux_i, fluxes = pbl_flux(*args, *sums)
        diag = FluxDiag(precnv=m.precnv, precls=m.precls,
                        hflux_l=fx.hfluxn[0], hflux_s=fx.hfluxn[1],
                        hflux_i=hflux_i, olr=olr, ts=fx.tsfc)
        return ut, vt, ttend, qtend, diag, fluxes

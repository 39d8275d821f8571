"""Physics driver: the parametrization suite for one time step.

Counterpart of the JAX package's physics/driver.py (the reference's
phy_phypar.f90).  It takes the grid fields at the physics time level, the
coupled-surface state, the daily forcing and the radiation carry
(shortwave runs every nstrad steps; its results persist in the carry),
and returns grid tendencies, the new carry and the flux diagnostics.

The step is mixed (hot spot B2 of ROADMAP queue B).  The moist group
(humidity, convection, large-scale condensation) is one call of
kernels.column_moist and the longwave pair two calls of
kernels.column_longwave: on a CUDA tensor each launches its hand-written
kernel (K9, K10), on a CPU tensor its plain version.  The clouds and the
shortwave, the surface fluxes, the vertical diffusion and the final sums
are plain PyTorch on the device; their kernels are still to write.  The
shortwave cadence is a Python branch on a host bool; data-dependent
level indices (itop, icltop) are torch.gather calls and comparisons
(selects in the kernels), never host reads.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from speedy_ml_tpu_torch.core.constants import GAMMA_LAPSE, REFRH1
from speedy_ml_tpu_torch.kernels import column_longwave
from speedy_ml_tpu_torch.kernels.column_moist import (column_moist,
                                                      moist_tables)
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics import radiation as rad
from speedy_ml_tpu_torch.physics.boundaries import BoundaryData
from speedy_ml_tpu_torch.physics.humidity import qsat_from_t
from speedy_ml_tpu_torch.physics.land_sea import SurfaceState
from speedy_ml_tpu_torch.physics.surface import suflux
from speedy_ml_tpu_torch.physics.vdiff import vdifsc

OPTIONAL_SLICE = "the optional-physics slice of the port (A15)"


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
    def zeros(K, nlat, nlon, dtype, device=None):
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return RadiationCarry(tau2=z(K, 4, nlat, nlon),
                              stratc=z(2, nlat, nlon),
                              tt_rsw=z(K, nlat, nlon), ssrd=z(nlat, nlon),
                              ssr=z(nlat, nlon), tsr=z(nlat, nlon),
                              randfv=z(2, nlat, K))


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


class PhysicsModel:
    """Static tables on one device + the phypar step function."""

    def __init__(self, geom, constants, dtype=torch.float32, randfh=None,
                 *, device="cpu"):
        if randfh is not None:
            raise NotImplementedError(
                f"random diabatic forcing (RDF) comes with {OPTIONAL_SLICE}")
        self.geom = geom
        self.const = constants
        self.dtype = dtype
        self.device = torch.device(device)
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
        self.fband = rad.build_fband()
        # the tables of the column kernels and their plain versions
        self.moist_tabs = moist_tables(sig, dsig, self.sig_t, self.wvi2_t,
                                       self.grdsig, self.grdscp, constants)
        self.lw_tabs = column_longwave.longwave_tables(
            self.wvi2, dsig, constants.sbc, self.fband, dtype, self.device)

    # ------------------------------------------------------------------

    def daily_forcing(self, bd: BoundaryData, sfc: SurfaceState, tyear,
                      sht) -> DailyForcing:
        """fordate(1): solar forcing, surface albedo, diffusion
        corrections.  tyear: a float or a 0-d tensor on the device (a
        float becomes a device fill, so no copy from the host)."""
        c = self.const
        if not torch.is_tensor(tyear):
            tyear = torch.full((), float(tyear), dtype=self.dtype,
                               device=self.device)
        sol = rad.sol_oz_traced(tyear, self.slat_t, self.clat_t,
                                self.geom.nlon)
        snowc = torch.clamp(sfc.snowd_am / pc.SD2SC, max=1.0)
        alb_l = bd.alb0 + snowc * (pc.ALBSN - bd.alb0)
        alb_s = pc.ALBSEA + sfc.sice_am * (pc.ALBICE - pc.ALBSEA)
        albsfc = alb_s + bd.fmask_l * (alb_l - alb_s)

        # T/q correction terms for the horizontal diffusion
        # (ini_fordate.f90:72-113); one analysis launch for both
        gamlat = GAMMA_LAPSE / (1000.0 * c.grav)
        corh = gamlat * bd.phis0
        pexp = 1.0 / (c.rgas / c.akap * 0.0 + 287.0 * gamlat)
        tsfc = bd.fmask_l * sfc.stl_am + bd.fmask_s * sfc.sst_am
        tref_s = tsfc + corh
        psfc = (tsfc / tref_s) ** pexp
        qref = qsat_from_t(tref_s, torch.ones_like(tref_s))
        qsfc = qsat_from_t(tsfc, psfc)
        spec = sht.analysis(torch.stack([corh, REFRH1 * (qref - qsfc)]))
        return DailyForcing(fsol=sol.fsol, ozupp=sol.ozupp, ozone=sol.ozone,
                            zenit=sol.zenit, stratz=sol.stratz, alb_l=alb_l,
                            alb_s=alb_s, albsfc=albsfc, snowc=snowc,
                            tcorh=spec[0], qcorh=spec[1])

    # ------------------------------------------------------------------

    def compute(self, ug, vg, tg, qg, phig, pslg, *, bd: BoundaryData,
                sfc: SurfaceState, forcing: DailyForcing,
                carry: RadiationCarry, lradsw: bool, sppt_pattern=None):
        """Physics tendencies from grid fields at the physics time level.

        Inputs (K, lat, lon) except pslg (lat, lon); lradsw a host bool
        (shortwave every nstrad steps).  Returns (utend, vtend, ttend,
        qtend, carry', FluxDiag).  The step is the stage methods below in
        this order; each can be called (and timed) alone."""
        if sppt_pattern is not None:
            raise NotImplementedError(f"SPPT comes with {OPTIONAL_SLICE}")
        # --- humidity, convection, large-scale condensation (K9)
        m = column_moist(tg, qg, phig, pslg, self.moist_tabs)
        # --- shortwave radiation (every nstrad steps)
        if lradsw:
            carry = self.shortwave(m, phig, bd, forcing, carry)
        # --- longwave down (K10)
        slrd, dfabs_lw, flux_bands, st4a = column_longwave.radlw_down(
            tg, carry.tau2, self.lw_tabs)
        # --- surface fluxes
        fx = self.surface_fluxes(m, ug, vg, tg, phig, bd, sfc, forcing,
                                 carry, slrd)
        # --- longwave up (K10)
        slr, olr, dfabs_lw = column_longwave.radlw_up(
            tg, fx.tsfc, slrd, fx.slru[2], dfabs_lw, flux_bands, st4a,
            carry.tau2, carry.stratc, self.lw_tabs)
        # --- PBL / vertical diffusion
        pbl = self.vertical_diffusion(m, ug, vg, phig)
        # --- the sums, and the fluxes for the coupler
        ut, vt, ttend, qtend, diag = self.tendency_sums(
            m, carry, sfc, fx, dfabs_lw, olr, pbl)
        return ut, vt, ttend, qtend, carry, diag

    def shortwave(self, m, phig, bd, forcing, carry) -> RadiationCarry:
        """Clouds and the shortwave step: the new radiation carry."""
        K = self.geom.nlev
        sol = rad.SolarForcing(fsol=forcing.fsol, ozupp=forcing.ozupp,
                               ozone=forcing.ozone, zenit=forcing.zenit,
                               stratz=forcing.stratz)
        gse = (m.se[K - 2] - m.se[K - 1]) / (phig[K - 2] - phig[K - 1])
        icltop, cloudc, clstr, qcloud = rad.cloud(
            m.qg, m.rh, m.precnv, m.precls, m.itop, gse, bd.fmask_l)
        ssrd, ssr, tsr, dfabs_sw, tau2, stratc = rad.radsw(
            m.psg, m.qg, icltop, cloudc, clstr, qcloud, sol, forcing.albsfc,
            sig=self.sig, dsig=self.dsig)
        grdscp = self.grdscp[:, None, None]
        return RadiationCarry(tau2=tau2, stratc=stratc,
                              tt_rsw=dfabs_sw * m.rps[None] * grdscp,
                              ssrd=ssrd, ssr=ssr, tsr=tsr,
                              randfv=carry.randfv)

    def surface_fluxes(self, m, ug, vg, tg, phig, bd, sfc, forcing, carry,
                       slrd):
        c = self.const
        return suflux(m.psg, ug, vg, tg, m.qg, m.rh, phig, phi0=bd.phis0,
                      fmask=bd.fmask_l, tland=sfc.stl_am, tsea=sfc.sst_am,
                      swav=sfc.soilw_am, ssrd=carry.ssrd, slrd=slrd,
                      forog=bd.forog, alb_l=forcing.alb_l,
                      alb_s=forcing.alb_s, snowc=forcing.snowc,
                      clat_row=self.clat_t, sigl_bot=self.sigl_bot,
                      wvi2_bot=self.wvi2_bot, rd=287.0, cp=c.cp,
                      alhc=c.alhc, sbc=c.sbc)

    def vertical_diffusion(self, m, ug, vg, phig):
        c = self.const
        return vdifsc(ug, vg, m.se, m.rh, m.qg, m.qsat, phig, m.icnv,
                      sig=self.sig, sigh=self.sigh, dsig=self.dsig, cp=c.cp,
                      alhc=c.alhc)

    def tendency_sums(self, m, carry, sfc, fx, dfabs_lw, olr, pbl):
        """The radiative heating and the diffusion tendencies (with the
        surface fluxes on the lowest level) summed onto the moist ones,
        and the fluxes for the coupler.  Returns (utend, vtend, ttend,
        qtend, FluxDiag)."""
        c = self.const
        rps = m.rps
        tt_rlw = dfabs_lw * rps[None] * self.grdscp[:, None, None]
        ttend = m.ttend + carry.tt_rsw + tt_rlw
        ut_pbl, vt_pbl, tt_pbl, qt_pbl = pbl
        bot = self.geom.nlev - 1
        gs, gc = self.grdsig[bot], self.grdscp[bot]
        add_bot = lambda a, f: torch.cat([a[:bot], (a[bot] + f)[None]])
        ut_pbl = add_bot(ut_pbl, fx.ustr[2] * rps * gs)
        vt_pbl = add_bot(vt_pbl, fx.vstr[2] * rps * gs)
        tt_pbl = add_bot(tt_pbl, fx.shf[2] * rps * gc)
        qt_pbl = add_bot(qt_pbl, fx.evap[2] * rps * gs)
        ttend = ttend + tt_pbl
        qtend = m.qtend + qt_pbl

        # difice as in ppo_dmflux.f90:114-118
        esbc = pc.EMISFC * c.sbc
        difice = ((pc.ALBSEA - pc.ALBICE) * carry.ssrd
                  + esbc * (pc.SSTFR ** 4 - sfc.tice_am ** 4)
                  + fx.shf[1] + fx.evap[1] * c.alhc)
        diag = FluxDiag(precnv=m.precnv, precls=m.precls,
                        hflux_l=fx.hfluxn[0], hflux_s=fx.hfluxn[1],
                        hflux_i=fx.hfluxn[1] + difice * (1.0 - sfc.sice_am),
                        olr=olr, ts=fx.tsfc)
        return ut_pbl, vt_pbl, ttend, qtend, diag

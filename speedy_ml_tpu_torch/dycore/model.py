"""The primitive-equation spectral dynamical core (T30L8 by default).

Counterpart of the JAX package's dycore/model.py (the reference's
dyn_step.f90, dyn_grtend.f90, dyn_sptend.f90, dyn_implic.f90,
dyn_geop.f90, ini_indyns.f90, ini_impint.f90).  Tables are built in numpy
float64 and held as tensors of the model dtype on one device.

One step (`step`) is six kernel launches around the physics:
  K15 spectral_stack (the dynamics stack at level j2-1 and, with physics,
     the physics stack at level 0: uvspec, grad, geopotential),
  K6 (spec_to_grid of the dynamics stack),
  [physics at level 0, which runs its own K6 on the physics stack],
  K7 grid_dynamics (the column math of grid_tendencies, plus the physics
     tendencies, into the stack that feeds the forward transforms),
  K5 (grid_to_spec of that stack, u and v scaled by 1/cos),
  K8 spectral_tail (vds, sptend, the semi-implicit correction, the
     diffusion, the drag and the leapfrog with its filter).
With cgrate_on (off by default, as in the reference) K8 runs its tendency
form, which leaves vor's and div's diffused tendencies to K26 cgrate (the
growth-rate limiter, then their leapfrog): seven launches.
On CPU tensors the kernels run their plain versions, which are built
from SpectralTransform.uvspec and grad and the methods below
(geopotential, grid_tendencies, to_spectral_tendencies, sptend,
implicit_correction, ...), the counterparts of the JAX functions.
"""

from __future__ import annotations

import copy
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.core.constants import (GAMMA_LAPSE, HSCALE, HSHUM,
                                                TDRS, THD, THDD, THDS,
                                                PhysicalConstants)
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.core.spectral import SpectralTransform
from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.kernels.cgrate import cgrate, damp_plain
from speedy_ml_tpu_torch.kernels.grid_dynamics import (ColumnTables,
                                                       column_blob,
                                                       column_tendencies,
                                                       grid_dynamics,
                                                       spectral_inputs)
from speedy_ml_tpu_torch.kernels.spectral_stack import (dynamics_ncos,
                                                        spectral_stack,
                                                        stack_blob)
from speedy_ml_tpu_torch.kernels.spectral_tail import (spectral_tail,
                                                       tail_blob)

class ImplicitCoeffs(NamedTuple):
    """Semi-implicit gravity-wave + implicit-diffusion coefficients for
    one step length (ini_impint.f90), as tensors; `blob` is the same
    tables packed in float32 for K8 (None for a float64 model)."""
    tref: torch.Tensor     # (K,)
    tref1: torch.Tensor    # (K,) rgas*tref
    tref2: torch.Tensor    # (K,) akap*tref
    tref3: torch.Tensor    # (K,) fsgr*tref
    xc: torch.Tensor       # (K, K) (already scaled by xi)
    xd: torch.Tensor       # (K, K)
    xj_g: torch.Tensor     # (M, N, K, K) per-(m, n) inverse; zero for l=0
    xj: torch.Tensor       # (lmax, K, K) the inverse of l = 1..lmax
    dhsx: torch.Tensor     # (K,) xi*dhs
    elz: torch.Tensor      # (M, N) l(l+1)*xi/a^2
    dmp1: torch.Tensor     # (M, N) 1/(1+dmp*dt)
    dmp1d: torch.Tensor
    dmp1s: torch.Tensor
    blob: Optional[torch.Tensor] = None
    col: Optional[ColumnTables] = None


class GridTendencies(NamedTuple):
    """Grid-space physics tendencies (added to the dynamics tendencies)."""
    u: torch.Tensor        # (K, lat, lon)
    v: torch.Tensor
    t: torch.Tensor
    tr: torch.Tensor       # (R, K, lat, lon)


# physics callback: (state, j_phys, model, *args, stack=) ->
# GridTendencies or (GridTendencies, aux); stack is K15's physics stack of
# level j_phys, made by the step's own launch
PhysicsFn = Callable[..., GridTendencies]


def _hordif(field, fdt, dmp, dmp1):
    return (fdt - dmp * field) * dmp1


class DycoreModel:
    """Static tables on one device and the step functions."""

    m0 = 0   # the first zonal wavenumber of a shard's view (shard_view)

    def __init__(self, geom: Geometry = Geometry(),
                 constants: PhysicalConstants = PhysicalConstants(),
                 dtype=torch.float32, nsteps_day: int = 96,
                 alph: float = 0.5, rob: float = 0.05, wil: float = 0.53,
                 zonal: str = "dft", cgrate_on: bool = False, *,
                 device=None):
        self.device = resolve_device(device)
        self.geom = geom
        self.const = constants
        self.cgrate_on = cgrate_on
        self.dtype = dtype
        self.sht = SpectralTransform(geom, radius=constants.rearth,
                                     dtype=dtype, zonal=zonal,
                                     device=self.device)
        self.cdtype = self.sht.cdtype
        self.nsteps_day = nsteps_day
        self.delt = 86400.0 / nsteps_day
        self.delt2 = 2.0 * self.delt
        self.alph, self.rob, self.wil = alph, rob, wil

        c = constants
        self._f = lambda x: torch.as_tensor(
            np.asarray(x, dtype=np.float64), device=self.device).to(dtype)
        f = self._f
        self.dhs = f(geom.dhs)
        self.dhsr = f(geom.dhsr)
        self.fsgr = f(geom.fsgr(c.akap))
        self.coriol = f(2.0 * c.omega * geom.sin_lat)

        # geopotential coefficients (ini_indyns.f90:89-92)
        hsg, fsgn = geom.half_sigma, geom.full_sigma
        xgeop1 = c.rgas * np.log(hsg[1:] / fsgn)
        xgeop2 = np.zeros(geom.nlev)
        xgeop2[1:] = c.rgas * np.log(fsgn[1:] / hsg[1:-1])
        corf = np.zeros(geom.nlev)
        for k in range(1, geom.nlev - 1):
            corf[k] = xgeop1[k] * 0.5 * np.log(hsg[k + 1] / fsgn[k]) \
                / np.log(fsgn[k + 1] / fsgn[k - 1])
        self.xgeop1_np, self.xgeop2_np = xgeop1, xgeop2
        self.xgeop1, self.xgeop2, self.geop_corf = f(xgeop1), f(xgeop2), \
            f(corf)
        # K15's tables (None for a float64 model: the kernel is float32)
        self.stack_blob = stack_blob(self) \
            if dtype == torch.float32 else None

        # horizontal diffusion damping (ini_indyns.f90:96-112); the f64
        # values feed build_implicit, as the JAX package's do in f64 runs
        npowhd = 4
        hdiff, hdifd, hdifs = (1 / (THD * 3600), 1 / (THDD * 3600),
                               1 / (THDS * 3600))
        rlap = 1.0 / (geom.trunc * (geom.trunc + 1))
        twn = np.add.outer(np.arange(geom.mx),
                           np.arange(geom.nx)).astype(np.float64)
        elap = twn * (twn + 1.0) * rlap
        dt_np = np.float64 if dtype == torch.float64 else np.float32
        self.dmp_np = np.asarray(hdiff * elap ** npowhd, dtype=dt_np)
        self.dmpd_np = np.asarray(hdifd * elap ** npowhd, dtype=dt_np)
        self.dmps_np = np.asarray(hdifs * elap, dtype=dt_np)
        self.dmp, self.dmpd, self.dmps = (f(self.dmp_np), f(self.dmpd_np),
                                          f(self.dmps_np))
        self.sdrag = 1.0 / (TDRS * 3600.0)

        # orographic T/q vertical correction profiles (ini_indyns.f90:114-127)
        rgam = c.rgas * GAMMA_LAPSE / (1000.0 * c.grav)
        tcorv = np.zeros(geom.nlev)
        qcorv = np.zeros(geom.nlev)
        tcorv[1:] = fsgn[1:] ** rgam
        qcorv[2:] = fsgn[2:] ** (HSCALE / HSHUM)
        self.tcorv, self.qcorv = f(tcorv), f(qcorv)

        # the three step lengths of stepone + the main loop (ini_stepone)
        self.imp_half = self.build_implicit(0.5 * self.delt, alph)
        self.imp_full = self.build_implicit(self.delt, alph)
        self.imp_double = self.build_implicit(self.delt2, alph)

    # ------------------------------------------------------------------
    # table builders
    # ------------------------------------------------------------------

    def build_implicit(self, dt: float, alph: float) -> ImplicitCoeffs:
        """Semi-implicit matrices for step length dt (ini_impint.f90)."""
        g, c = self.geom, self.const
        kx, a = g.nlev, c.rearth
        hsg, dhs = g.half_sigma.astype(np.float64), g.dhs
        fsg, fsgr = g.full_sigma, g.fsgr(c.akap)

        dmp1 = 1.0 / (1.0 + self.dmp_np.astype(np.float64) * dt)
        dmp1d = 1.0 / (1.0 + self.dmpd_np.astype(np.float64) * dt)
        dmp1s = 1.0 / (1.0 + self.dmps_np.astype(np.float64) * dt)

        rgam = c.rgas * GAMMA_LAPSE / (1000.0 * c.grav)
        tref = 288.0 * np.maximum(0.2, fsg) ** rgam
        xi = dt * alph
        xxi = xi / (a * a)
        ll = np.add.outer(np.arange(g.mx), np.arange(g.nx)).astype(np.float64)
        elz = ll * (ll + 1.0) * xxi

        ya = -c.akap * np.outer(tref, dhs)
        xa = np.zeros((kx, kx))
        for k in range(1, kx):
            xa[k, k - 1] = 0.5 * (c.akap * tref[k] / fsg[k]
                                  - (tref[k] - tref[k - 1]) / dhs[k])
        for k in range(kx - 1):
            xa[k, k] = 0.5 * (c.akap * tref[k] / fsg[k]
                              - (tref[k + 1] - tref[k]) / dhs[k])
        dsum = np.cumsum(dhs)
        xb = np.zeros((kx, kx))
        for k in range(kx - 1):
            for k1 in range(kx):
                xb[k, k1] = dhs[k1] * dsum[k] - (dhs[k1] if k1 <= k else 0.0)
        xc = ya + xa[:, : kx - 1] @ xb[: kx - 1, :]
        xd = np.zeros((kx, kx))
        for k in range(kx):
            for k1 in range(k + 1, kx):
                xd[k, k1] = c.rgas * np.log(hsg[k1 + 1] / hsg[k1])
            xd[k, k] = c.rgas * np.log(hsg[k + 1] / fsg[k])
        xe = xd @ xc

        lmax = g.lmax
        ell = np.arange(1, lmax + 1, dtype=np.float64)
        xxx = ell * (ell + 1.0) / (a * a)
        xf = (xi * xi) * xxx[:, None, None] * (
            c.rgas * np.outer(tref, dhs)[None] - xe[None]) + np.eye(kx)[None]
        xj = np.linalg.inv(xf)
        ll_int = np.add.outer(np.arange(g.mx), np.arange(g.nx))
        xj_g = np.zeros((g.mx, g.nx, kx, kx))
        pos = ll_int > 0
        xj_g[pos] = xj[np.clip(ll_int[pos], 1, lmax) - 1]

        f = self._f
        imp = ImplicitCoeffs(
            tref=f(tref), tref1=f(c.rgas * tref), tref2=f(c.akap * tref),
            tref3=f(fsgr * tref), xc=f(xc * xi), xd=f(xd), xj_g=f(xj_g),
            xj=f(xj),
            dhsx=f(xi * dhs), elz=f(elz), dmp1=f(dmp1), dmp1d=f(dmp1d),
            dmp1s=f(dmp1s))
        col = ColumnTables(coriol=self.coriol, dhs=self.dhs,
                           dhsr=self.dhsr, fsgr=self.fsgr, tref=imp.tref,
                           tref3=imp.tref3, rgas=c.rgas, akap=c.akap)
        if self.dtype == torch.float32:
            imp = imp._replace(blob=tail_blob(self, imp))
            col = col._replace(blob=column_blob(col))
        return imp._replace(col=col)

    def column_tables(self, imp: ImplicitCoeffs) -> ColumnTables:
        return imp.col

    def _zero_mean(self, psdt):
        """psdt's (m, n) = (0, 0) coefficient set to zero, in place (none
        on a shard whose m range does not start at 0)."""
        if self.m0 == 0:
            psdt[0, 0] = 0.0

    # ------------------------------------------------------------------
    # a shard of the mesh (GCM.set_mesh)
    # ------------------------------------------------------------------

    M_TABLES = ("dmp", "dmpd", "dmps")
    IMP_M_TABLES = ("elz", "dmp1", "dmp1d", "dmp1s", "xj_g")

    def shard_view(self, sht, band) -> "DycoreModel":
        """A copy of the dycore for one shard: sht the shard's view of the
        transform (SpectralTransform.shard_view: its m range from sht.m0,
        its latitude band), the (m, n) tables of the range, the Coriolis
        rows of the band (K7), the three step lengths' coefficients sliced
        likewise, and the kernels' blobs built from the slices (K15's,
        K8's with xj up to the range's largest total wavenumber, K7's).
        The step methods of the copy run its range and band."""
        from speedy_ml_tpu_torch.parallel.mesh import band_rows
        v = copy.copy(self)
        dev = sht.device
        m0, mr = sht.m0, sht.gradx.shape[0]
        to = lambda t: t.to(dev).contiguous()
        rng = lambda t: to(t.narrow(0, m0, mr))
        v.sht, v.device, v.m0 = sht, dev, m0
        for nm in ("dhs", "dhsr", "fsgr", "xgeop1", "xgeop2", "geop_corf",
                   "tcorv", "qcorv"):
            setattr(v, nm, to(getattr(self, nm)))
        for nm in self.M_TABLES:
            setattr(v, nm, rng(getattr(self, nm)))
        v.coriol = to(band_rows(self.coriol, band, self.geom.nlat, dim=0))
        v.stack_blob = (stack_blob(v) if self.dtype == torch.float32
                        else None)
        lmax = m0 + mr + self.geom.nx - 2
        for nm in ("imp_half", "imp_full", "imp_double"):
            imp = getattr(self, nm)
            new = {k: to(getattr(imp, k)) for k in ImplicitCoeffs._fields
                   if torch.is_tensor(getattr(imp, k))}
            new.update({k: rng(getattr(imp, k)) for k in self.IMP_M_TABLES})
            new.update(xj=to(imp.xj[:lmax]), blob=None)
            imp = imp._replace(**new)
            col = imp.col._replace(
                coriol=v.coriol, dhs=v.dhs, dhsr=v.dhsr, fsgr=v.fsgr,
                tref=imp.tref, tref3=imp.tref3, blob=None)
            if self.dtype == torch.float32:
                imp = imp._replace(blob=tail_blob(v, imp))
                col = col._replace(blob=column_blob(col))
            setattr(v, nm, imp._replace(col=col))
        return v

    # ------------------------------------------------------------------
    # diagnostic pieces
    # ------------------------------------------------------------------

    def geopotential(self, t_spec, phis):
        """Hydrostatic integration in spectral space (dyn_geop.f90).
        t_spec (K, M, N), phis (M, N) -> phi (K, M, N)."""
        kx = self.geom.nlev
        x1, x2 = self.xgeop1_np, self.xgeop2_np
        layers = [phis + float(x1[kx - 1]) * t_spec[kx - 1]]
        for k in range(kx - 2, -1, -1):
            layers.append(layers[-1] + float(x2[k + 1]) * t_spec[k + 1]
                          + float(x1[k]) * t_spec[k])
        phi = torch.stack(layers[::-1], dim=0)
        # zonal-mean lapse-rate correction (m=0 coefficients only; a
        # shard whose range does not start at m = 0 holds none)
        if self.m0 != 0:
            return phi
        tm0 = t_spec[:, 0, :]
        corr = self.geop_corf[1:kx - 1, None] * (tm0[2:kx] - tm0[0:kx - 2])
        phi = phi.clone()
        phi[1:kx - 1, 0, :] = phi[1:kx - 1, 0, :] + corr
        return phi

    # ------------------------------------------------------------------
    # tendency computation (the plain pieces of K6/K7/K5/K8)
    # ------------------------------------------------------------------

    def dynamics_stack(self, state: SpectralState, j: int):
        """The spectral stack the grid tendencies need at level j:
        [vor, div, t, tracers | ucos, vcos, dps/dx, dps/dy] (K15 alone)
        and the index from which 1/cos applies."""
        stacked, _ = spectral_stack(self, state, None, j, None)
        return stacked, dynamics_ncos(self.geom.nlev, self.geom.ntracers)

    def grid_tendencies(self, state: SpectralState, j2: int,
                        imp: ImplicitCoeffs):
        """Nonlinear grid-point dynamics tendencies (dyn_grtend.f90).

        Returns ((utend, vtend, ttend, trtend, psdt), grid_fields)."""
        g = self.geom
        stacked, ncos = self.dynamics_stack(state, j2)
        gall = self.sht.synthesis(stacked, ncos)
        utend, vtend, ttend, trtend, psfield, gf = column_tendencies(
            gall, self.column_tables(imp), g.nlev, g.ntracers)
        psdt = self.sht.grid_to_spec(psfield).clone()
        self._zero_mean(psdt)
        return (utend, vtend, ttend, trtend, psdt), gf

    def analysis_stack(self, stack):
        """K5 over the stack K7 writes: fields from 1 + (2+R)K on are the
        u/v stacks of vdspec and get the 1/cos scale."""
        g = self.geom
        return self.sht.analysis(stack, 1 + (2 + g.ntracers) * g.nlev)

    def tendencies_from_analysis(self, A):
        """Spectral tendencies from the analysed stack
        [psfield; ke, ttend, trtend; u stack; v stack]
        (dyn_grtend.f90:233-278): (psdt, vordt, divdt, tdt, trdt)."""
        g = self.geom
        K, R = g.nlev, g.ntracers
        S = (2 + R) * K
        psdt = A[0].clone()
        self._zero_mean(psdt)
        s_all, u_all, v_all = A[1:1 + S], A[1 + S:1 + 2 * S], \
            A[1 + 2 * S:1 + 3 * S]
        vor_all, div_all = self.sht.vds(u_all, v_all)
        vordt = vor_all[:K]
        divdt = div_all[:K] - self.sht.lap(s_all[:K])
        tdt = div_all[K:2 * K] + s_all[K:2 * K]
        trdt = (div_all[2 * K:] + s_all[2 * K:]).reshape(R, K,
                                                          *A.shape[-2:])
        return psdt, vordt, divdt, tdt, trdt

    def to_spectral_tendencies(self, utend, vtend, ttend, trtend,
                               grid_fields) -> tuple:
        """Grid tendencies -> spectral (dyn_grtend.f90:233-278): one
        analysis over the stacked fields.  Returns (vordt, divdt, tdt,
        trdt)."""
        stack = spectral_inputs(
            torch.zeros_like(grid_fields["umean"]), utend, vtend, ttend,
            trtend, grid_fields)
        return self.tendencies_from_analysis(self.analysis_stack(stack))[1:]

    def sptend(self, state: SpectralState, j4: int, imp: ImplicitCoeffs,
               phis, divdt, tdt, psdt):
        """Linear (reference-profile) spectral tendencies (dyn_sptend.f90)."""
        g = self.geom
        K = g.nlev
        div_s, t_s, ps_s = state.div[j4], state.t[j4], state.ps[j4]
        dhs = self.dhs[:, None, None]
        dmeanc = (div_s * dhs).sum(dim=0)
        psdt = (psdt - dmeanc).clone()
        self._zero_mean(psdt)
        # sigma-dot on half levels; the bottom half level stays exactly 0
        incr = -dhs[:-1] * (div_s[:-1] - dmeanc)
        z1 = torch.zeros_like(div_s[:1])
        sigdtc = torch.cat([z1, torch.cumsum(incr, dim=0), z1], dim=0)
        dtref = (imp.tref[1:] - imp.tref[:-1])[:, None, None]
        dumk = torch.cat([z1, sigdtc[1:K] * dtref, z1], dim=0)
        tdt = tdt - (dumk[1:] + dumk[:-1]) * self.dhsr[:, None, None] \
            + imp.tref3[:, None, None] * (sigdtc[1:] + sigdtc[:-1]) \
            - imp.tref2[:, None, None] * dmeanc
        phi = self.geopotential(t_s, phis)
        gp = phi + self.const.rgas * imp.tref[:, None, None] * ps_s[None]
        divdt = divdt - self.sht.lap(gp)
        return divdt, tdt, psdt

    def implicit_correction(self, imp: ImplicitCoeffs, divdt, tdt, psdt):
        """Semi-implicit gravity-wave correction (dyn_implic.f90)."""
        cd = self.cdtype
        ye = torch.einsum("kl,lmn->kmn", imp.xd.to(cd), tdt) \
            + imp.tref1[:, None, None] * psdt[None]
        yf = divdt + imp.elz[None] * ye
        divdt_new = torch.einsum("mnkl,lmn->kmn", imp.xj_g.to(cd), yf)
        psdt = psdt - (divdt_new * imp.dhsx[:, None, None]).sum(dim=0)
        tdt = tdt + torch.einsum("kl,lmn->kmn", imp.xc.to(cd), divdt_new)
        return divdt_new, tdt, psdt

    def diffuse(self, state: SpectralState, imp: ImplicitCoeffs, vordt,
                divdt, tdt, trdt, corrections=None):
        """Horizontal diffusion with the orographic corrections, the
        stratospheric drag and the extra top-level del^2
        (dyn_step.f90:60-106), in the JAX package's order."""
        g = self.geom
        tcorh, qcorh = corrections if corrections is not None \
            else (None, None)
        vor0, div0 = state.vor[0], state.div[0]
        vordt = _hordif(vor0, vordt, self.dmp[None], imp.dmp1[None])
        divdt = _hordif(div0, divdt, self.dmpd[None], imp.dmp1d[None])
        ctmp = state.t[0] + (tcorh[None] * self.tcorv[:, None, None]
                             if tcorh is not None else 0.0)
        tdt = _hordif(ctmp, tdt, self.dmp[None], imp.dmp1[None])
        vordt, divdt, tdt = vordt.clone(), divdt.clone(), tdt.clone()
        if self.m0 == 0:
            vordt[0, 0, :] = vordt[0, 0, :] - self.sdrag * vor0[0, 0, :]
            divdt[0, 0, :] = divdt[0, 0, :] - self.sdrag * div0[0, 0, :]
        vordt[0] = _hordif(vor0[0], vordt[0], self.dmps, imp.dmp1s)
        divdt[0] = _hordif(div0[0], divdt[0], self.dmps, imp.dmp1s)
        tdt[0] = _hordif(ctmp[0], tdt[0], self.dmps, imp.dmp1s)
        qtmp = state.tr[0, 0] + (qcorh[None] * self.qcorv[:, None, None]
                                 if qcorh is not None else 0.0)
        trdt = trdt.clone()
        trdt[0] = _hordif(qtmp, trdt[0], self.dmpd, imp.dmp1d)
        for itr in range(1, g.ntracers):
            trdt[itr] = _hordif(state.tr[0, itr], trdt[itr], self.dmp,
                                imp.dmp1)
        return vordt, divdt, tdt, trdt

    def timint(self, field, fdt, j1: int, dt: float, eps: float):
        """Leapfrog + Robert-Asselin-Williams filter (dyn_step.f90:153-190)."""
        if self.geom.nlon == 4 * self.geom.nlat_half:
            fdt = self.sht.trunct(fdt)
        old1, oldj = field[0], field[j1 - 1]
        fnew = old1 + dt * fdt
        wil = self.wil
        new1 = oldj + wil * eps * (old1 - 2.0 * oldj + fnew)
        new2 = fnew - (1.0 - wil) * eps * (new1 - 2.0 * oldj + fnew)
        return torch.stack([new1, new2], dim=0)

    def _cgrate(self, vor, div, vordt, divdt):
        """Eddy-kinetic-energy growth-rate limiter (cgrate,
        dyn_step.f90:192-276): per field, the eddy (m > 0) growth rate
        grate = -sum Re(fdt conj(invlap f)) is compared per level (k >= 1)
        against grmax rnorm, rnorm = -sum Re(f conj(invlap f)) >= 0; on a
        trigger every eddy coefficient of the tendency is damped by the
        largest 0.8 grate / rnorm.  The plain formula (kernels/cgrate.py
        damp_plain), K26's first phases."""
        return (damp_plain(vor, vordt, self.sht.elm2)[0],
                damp_plain(div, divdt, self.sht.elm2)[0])

    def spectral_tail_plain(self, A, state: SpectralState, phis,
                            corrections, imp: ImplicitCoeffs, j1: int,
                            dt: float, eps: float, j4: int,
                            implicit: bool, cg: bool = False
                            ) -> SpectralState:
        """K8's plain version: the step after the forward transforms; cg
        its tendency form (vor[0], div[0] the diffused tendencies, vor[1],
        div[1] zero)."""
        psdt, vordt, divdt, tdt, trdt = self.tendencies_from_analysis(A)
        divdt, tdt, psdt = self.sptend(state, j4, imp, phis, divdt, tdt,
                                       psdt)
        if implicit:
            divdt, tdt, psdt = self.implicit_correction(imp, divdt, tdt,
                                                        psdt)
        vordt, divdt, tdt, trdt = self.diffuse(state, imp, vordt, divdt,
                                               tdt, trdt, corrections)
        if cg:
            tend = lambda fdt: torch.stack([fdt, torch.zeros_like(fdt)])
            vor, div = tend(vordt), tend(divdt)
        else:
            vor = self.timint(state.vor, vordt, j1, dt, eps)
            div = self.timint(state.div, divdt, j1, dt, eps)
        return SpectralState(
            vor=vor, div=div,
            t=self.timint(state.t, tdt, j1, dt, eps),
            ps=self.timint(state.ps, psdt, j1, dt, eps),
            tr=self.timint(state.tr, trdt, j1, dt, eps))

    # ------------------------------------------------------------------
    # the full step
    # ------------------------------------------------------------------

    def step(self, state: SpectralState, phis, j1: int, j2: int, dt: float,
             imp: ImplicitCoeffs, physics_fn: Optional[PhysicsFn] = None,
             physics_args: tuple = (), corrections: Optional[tuple] = None):
        """One time step (dyn_step.f90):

        Fnew = F(0) + dt * [T_dyn(F(j2-1)) + T_phy(F(0))], then the RAW
        filter.  j1, j2 in the Fortran 1-based convention: (1,1) forward,
        (1,2) initial leapfrog, (2,2) filtered leapfrog.  The physics
        always evaluates at level 0 (the Robert-filtered centre, as the
        reference hardwires grtend(..., J1=1, j2)).  corrections =
        (tcorh, qcorh).  Returns (new_state, aux); aux is None without
        physics."""
        g = self.geom
        stacked, pstack = spectral_stack(
            self, state, phis, j2 - 1,
            0 if physics_fn is not None else None)                 # K15
        gall = self.sht.synthesis(stacked,
                                  dynamics_ncos(g.nlev, g.ntracers))  # K6
        aux, ptend = None, None
        if physics_fn is not None:
            out = physics_fn(state, 0, self, *physics_args, stack=pstack)
            if isinstance(out, tuple) and not isinstance(out,
                                                         GridTendencies):
                ptend, aux = out
            else:
                ptend = out
        stack = grid_dynamics(gall, ptend, self.column_tables(imp),
                              g.nlev, g.ntracers)                   # K7
        A = self.analysis_stack(stack)                              # K5
        if dt <= 0.0:
            return state, aux
        eps = 0.0 if j1 == 1 else self.rob
        # alph = 0: explicit linear terms at level j2-1, no correction
        implicit = self.alph != 0.0
        new_state = spectral_tail(self, A, state, phis, corrections, imp,
                                  j1, dt, eps, 0 if implicit else j2 - 1,
                                  implicit, self.cgrate_on)         # K8
        if self.cgrate_on:
            new_state = cgrate(self, state, new_state, j1, dt, eps)  # K26
        return new_state, aux

    def stepone(self, state: SpectralState, phis, physics_fn=None,
                physics_args: tuple = (), corrections=None):
        """Cold-start double half-step (ini_stepone.f90)."""
        state, aux = self.step(state, phis, 1, 1, 0.5 * self.delt,
                               self.imp_half, physics_fn, physics_args,
                               corrections)
        state, aux = self.step(state, phis, 1, 2, self.delt, self.imp_full,
                               physics_fn, physics_args, corrections)
        return state, aux

    def leapfrog_step(self, state: SpectralState, phis, physics_fn=None,
                      physics_args: tuple = (), corrections=None):
        """The main-loop filtered leapfrog step (dyn_stloop.f90:43)."""
        return self.step(state, phis, 2, 2, self.delt2, self.imp_double,
                         physics_fn, physics_args, corrections)

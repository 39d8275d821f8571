"""K12 and K12_pbl_flux: the vertical diffusion and the sums that close
one physics step (csrc/column_pbl.cu), with the window's flux sums on a
leapfrog step, and their plain versions.

`column_pbl` (K12) is, per grid column, the JAX package's
physics/vdiff.py:16 vdifsc (shallow convection, moisture diffusion above
the PBL, damping of super-adiabatic lapse rates) followed by the sums of
physics/driver.py:258-275 and :298-307: the radiative heating and the
diffusion tendencies (with the surface stresses and fluxes on the lowest
level) summed onto the moist ones, and the sea-ice heat flux.  In: K9's
MoistColumns, phig, K10a_down_surface's SurfaceFluxes, the carry's tt_rsw
and ssrd, K10b's dfabs and the surface state's tice and sice.  Out:
(utend, vtend, ttend, qtend, hflux_i).

`pbl_flux` (K12_pbl_flux) is the same and, in the same launch, the
window's flux sums of a leapfrog step (the JAX package's gcm.py:273-280,
kernels/flux_accumulate.py): the step's heat fluxes (hflux_l, hflux_s and
the hflux_i it forms) times rsteps = 1/nsteps_day and its precipitation
(K9's precnv + precls) times delt2/2 added to the FluxAccumulator given.
Out: K12's five and the new accumulator (the one given is left as it
is).

The vertical tables and the constants reach the kernel as one small
buffer in the model's dtype (PblTables.blob), built once from the very
Python floats the plain version uses.  The kernels are compiled for
float32 (the main path) and float64.

On a CPU tensor each wrapper runs its plain version (`column_pbl_plain`,
then for pbl_flux `flux_accumulate_plain`); on a CUDA tensor it launches
its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels.flux_accumulate import (FluxTerms,
                                                         flux_accumulate_plain)
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics.vdiff import vdifsc

KERNEL_LEVELS = (5, 7, 8)   # K values compiled in csrc/column_pbl.cu
N_TABLES, N_SCALARS = 7, 9  # the blob: (K,) tables, then scalars
# the operands, in the order of PblIn (csrc/column_pbl.cuh): level fields,
# icnv (int64), planes
LEVEL_INPUTS = ("se", "rh", "qg", "qsat", "phig", "ttend", "qtend",
                "tt_rsw", "dfabs_lw")
PLANE_INPUTS = ("rps", "ustr", "vstr", "shf_s", "shf", "evap_s", "evap",
                "hflux_s", "ssrd", "tice", "sice")
INPUTS = LEVEL_INPUTS + ("icnv",) + PLANE_INPUTS
# K12_pbl_flux's operands after INPUTS, in the order of PblFlux: the four
# running sums, the step's land heat flux and K9's precipitations
FLUX_INPUTS = ("acc_hflux_l", "acc_hflux_s", "acc_hflux_i", "acc_precip",
               "hflux_l", "precnv", "precls")


class PblTables(NamedTuple):
    sig: np.ndarray         # (K,) float64, host
    sigh: np.ndarray        # (K+1,)
    dsig: np.ndarray        # (K,)
    grdsig: torch.Tensor    # (K,) in the model's dtype, on the device
    grdscp: torch.Tensor
    cp: float
    alhc: float
    sbc: float
    blob: torch.Tensor      # the kernel's tables, see pbl_tables


def vdifsc_tables(sig, sigh, dsig, cp):
    """vdifsc's tables (physics/vdiff.py), as it forms them: rsig, rsig1,
    drh0 and fvdiq2 per layer pair (k, k+1) (0 at k = K-1), the flag of
    the pairs that diffuse moisture above the PBL; and the scalars
    fshcse, fshcq, fvdise."""
    K = len(dsig)
    cshc = dsig[K - 1] / 3600.0
    cvdi = (sigh[K - 1] - sigh[1]) / ((K - 2) * 3600.0)
    fvdiq = cvdi / pc.TRVDI
    rsig = [float(x) for x in 1.0 / dsig]
    denom = 1.0 - np.asarray(sigh[1:], dtype=np.float64)
    rsig1 = [float(x) for x in 1.0 / np.where(denom > 0, denom, 1.0)]
    drh0 = [float(pc.RHGRAD * (sig[k + 1] - sig[k])) for k in range(K - 1)]
    fvdiq2 = [float(fvdiq * sigh[k + 1]) for k in range(K - 1)]
    vdon = [1.0 if 2 <= k < K - 2 and sigh[k + 1] > 0.5 else 0.0
            for k in range(K)]
    scalars = [float(cshc / (pc.TRSHC * cp)), float(cshc / pc.TRSHC),
               float(cvdi / (pc.TRVDS * cp))]
    return rsig, rsig1, drh0 + [0.0], fvdiq2 + [0.0], vdon, scalars


def pbl_tables(sig, sigh, dsig, grdsig, grdscp, const) -> PblTables:
    """The tables of both versions.  sig, sigh, dsig: float64 numpy;
    grdsig, grdscp: the model's (K,) tensors, which the plain version
    multiplies with and the blob copies; const: cp, alhc, sbc.  The blob,
    in the tensors' dtype, in the order csrc/column_pbl.cuh reads it:
    rsig, rsig1, grdsig, grdscp, drh0, fvdiq2, vdon (K each), then alhc,
    fshcse, fshcq, 1 - REDSHC, SEGRAD, fvdise, ALBSEA - ALBICE, esbc,
    SSTFR ** 4."""
    dtype, device = grdsig.dtype, grdsig.device
    host = lambda x: torch.tensor([float(v) for v in x],
                                  dtype=torch.float64).to(dtype).to(device)
    rsig, rsig1, drh0, fvdiq2, vdon, (fshcse, fshcq, fvdise) = \
        vdifsc_tables(sig, sigh, dsig, const.cp)
    scalars = [const.alhc, fshcse, fshcq, 1.0 - pc.REDSHC, pc.SEGRAD, fvdise,
               pc.ALBSEA - pc.ALBICE, pc.EMISFC * const.sbc, pc.SSTFR ** 4]
    blob = torch.cat([host(rsig), host(rsig1), grdsig, grdscp, host(drh0),
                      host(fvdiq2), host(vdon), host(scalars)]).contiguous()
    return PblTables(sig=sig, sigh=sigh, dsig=dsig, grdsig=grdsig,
                     grdscp=grdscp, cp=const.cp, alhc=const.alhc,
                     sbc=const.sbc, blob=blob)


def column_pbl_plain(m, phig, fx, tt_rsw, ssrd, dfabs_lw, tice, sice,
                     tabs: PblTables):
    """The plain PyTorch version of the kernel: vdifsc (whose ua, va are
    unused), then the sums of the JAX package's PhysicsModel.compute."""
    K = m.se.shape[0]
    rps = m.rps
    ut, vt, tt, qt = vdifsc(None, None, m.se, m.rh, m.qg, m.qsat, phig,
                            m.icnv, sig=tabs.sig, sigh=tabs.sigh,
                            dsig=tabs.dsig, cp=tabs.cp, alhc=tabs.alhc)
    tt_rlw = dfabs_lw * rps[None] * tabs.grdscp[:, None, None]
    ttend = m.ttend + tt_rsw + tt_rlw
    bot = K - 1
    gs, gc = tabs.grdsig[bot], tabs.grdscp[bot]
    add_bot = lambda a, f: torch.cat([a[:bot], (a[bot] + f)[None]])
    ut = add_bot(ut, fx.ustr[2] * rps * gs)
    vt = add_bot(vt, fx.vstr[2] * rps * gs)
    tt = add_bot(tt, fx.shf[2] * rps * gc)
    qt = add_bot(qt, fx.evap[2] * rps * gs)
    ttend = ttend + tt
    qtend = m.qtend + qt
    # difice as in ppo_dmflux.f90:114-118
    esbc = pc.EMISFC * tabs.sbc
    difice = ((pc.ALBSEA - pc.ALBICE) * ssrd
              + esbc * (pc.SSTFR ** 4 - tice ** 4)
              + fx.shf[1] + fx.evap[1] * tabs.alhc)
    return ut, vt, ttend, qtend, fx.hfluxn[1] + difice * (1.0 - sice)


def pbl_flux_plain(m, phig, fx, tt_rsw, ssrd, dfabs_lw, tice, sice,
                   tabs: PblTables, fluxes, rsteps: float, delt2: float):
    """The plain version of K12_pbl_flux: column_pbl_plain, then
    flux_accumulate_plain on the step's fluxes and K9's
    precipitation."""
    out = column_pbl_plain(m, phig, fx, tt_rsw, ssrd, dfabs_lw, tice, sice,
                           tabs)
    terms = FluxTerms(hflux_l=fx.hfluxn[0], hflux_s=fx.hfluxn[1],
                      hflux_i=out[4], precnv=m.precnv, precls=m.precls)
    return out + (flux_accumulate_plain(fluxes, terms, rsteps, delt2),)


def operands(m, phig, fx, tt_rsw, ssrd, dfabs_lw, tice, sice,
             tabs: PblTables):
    """Validate the operands of either route: m.se's floating dtype
    (icnv int64), contiguous, on m.se's device.  Returns (K, nlat, nlon,
    the tensors in the kernel's order)."""
    se = m.se
    K, nlat, nlon = kb.level_dims(se, "m.se")
    named = dict(se=se, rh=m.rh, qg=m.qg, qsat=m.qsat, phig=phig,
                 ttend=m.ttend, qtend=m.qtend, tt_rsw=tt_rsw,
                 dfabs_lw=dfabs_lw, icnv=m.icnv, rps=m.rps, ustr=fx.ustr[2],
                 vstr=fx.vstr[2], shf_s=fx.shf[1], shf=fx.shf[2],
                 evap_s=fx.evap[1], evap=fx.evap[2], hflux_s=fx.hfluxn[1],
                 ssrd=ssrd, tice=tice, sice=sice)
    for nm in INPUTS:
        lev = nm in LEVEL_INPUTS
        kb.require(named[nm], nm, torch.int64 if nm == "icnv" else se.dtype,
                   (K, nlat, nlon) if lev else (nlat, nlon), se.device)
    kb.require(tabs.blob, "tabs.blob", se.dtype,
               (N_TABLES * K + N_SCALARS,), se.device)
    return K, nlat, nlon, [named[nm] for nm in INPUTS]


def flux_operands(m, fx, fluxes, shape, dtype, device):
    """Validate pbl_flux's operands after K12's (FluxAccumulator fields
    and planes of K12's dtype and (lat, lon) shape, contiguous, on its
    device).  Returns them in the kernel's order."""
    named = dict(acc_hflux_l=fluxes.hflux_l, acc_hflux_s=fluxes.hflux_s,
                 acc_hflux_i=fluxes.hflux_i, acc_precip=fluxes.precip,
                 hflux_l=fx.hfluxn[0], precnv=m.precnv, precls=m.precls)
    for nm in FLUX_INPUTS:
        kb.require(named[nm], nm, dtype, shape, device)
    return [named[nm] for nm in FLUX_INPUTS]


def _launch(ins, K, nlat, nlon, tabs, flux, rsteps=0.0, delt2=0.0):
    """One launch of K12 (flux 0) or K12_pbl_flux (flux 1) on the validated
    operands; returns its output buffer ((4K + 1 + 4 flux, lat, lon))."""
    se = ins[0]
    out = torch.empty((4 * K + 1 + 4 * flux, nlat, nlon), dtype=se.dtype,
                      device=se.device)
    code = kb.library().column_pbl_launch(
        kb.device_index(se), K, int(se.dtype == torch.float64), flux,
        kb.pointer_array(ins), len(ins), tabs.blob.data_ptr(), nlat * nlon,
        out.data_ptr(), float(rsteps), float(delt2), kb.stream_of(se))
    kb.check(code, "pbl_flux" if flux else "column_pbl")
    return out


def column_pbl(m, phig, fx, tt_rsw, ssrd, dfabs_lw, tice, sice,
               tabs: PblTables):
    """Vertical diffusion and the step's sums, K12 (see the module
    docstring).  Returns (utend, vtend, ttend, qtend, hflux_i)."""
    args = (m, phig, fx, tt_rsw, ssrd, dfabs_lw, tice, sice, tabs)
    K, nlat, nlon, ins = operands(*args)
    if kb.column_route("column_pbl", m.se.device, K, KERNEL_LEVELS) == "cpu":
        return column_pbl_plain(*args)
    out = _launch(ins, K, nlat, nlon, tabs, 0)
    column_pbl.launches += 1
    return unpack(out, K)


def pbl_flux(m, phig, fx, tt_rsw, ssrd, dfabs_lw, tice, sice,
             tabs: PblTables, fluxes, rsteps: float, delt2: float):
    """K12 and the window's flux sums of a leapfrog step in one launch,
    K12_pbl_flux (see the module docstring).  fluxes: the FluxAccumulator
    of the steps before; rsteps = 1/nsteps_day, delt2 (Python numbers).
    Returns (utend, vtend, ttend, qtend, hflux_i, the new accumulator)."""
    args = (m, phig, fx, tt_rsw, ssrd, dfabs_lw, tice, sice, tabs)
    K, nlat, nlon, ins = operands(*args)
    se = m.se
    ins += flux_operands(m, fx, fluxes, (nlat, nlon), se.dtype, se.device)
    if kb.column_route("pbl_flux", se.device, K, KERNEL_LEVELS) == "cpu":
        return pbl_flux_plain(*args, fluxes, rsteps, delt2)
    out = _launch(ins, K, nlat, nlon, tabs, 1, rsteps, delt2)
    pbl_flux.launches += 1
    return unpack(out, K) + (type(fluxes)(*out[4 * K + 1:]),)


def unpack(out, K: int):
    """The kernel's output buffer ((4K + 1, lat, lon), or K12_pbl_flux's
    (4K + 5, lat, lon) whose last four planes are the new sums;
    csrc/column_pbl.cuh column_pbl_at) as views: (utend, vtend, ttend,
    qtend, hflux_i)."""
    return (out[:K], out[K:2 * K], out[2 * K:3 * K], out[3 * K:4 * K],
            out[4 * K])


column_pbl.launches = 0
pbl_flux.launches = 0

"""K9 and K9_moist_shortwave: the moist column physics of one step, with
the clouds and the shortwave on a shortwave step (csrc/column_moist.cu),
and their plain versions.

Input: the grid fields tg, qg, phig (K, lat, lon) and pslg (lat, lon) at
the physics time level.  Per grid column, in the order of the JAX
package's PhysicsModel.compute (physics/driver.py:192-216): psg =
exp(pslg), q clamped at 0, the dry static energy, the saturation
humidity and the relative humidity; the mass-flux convection (convmf);
the large-scale condensation (lscond); and the two schemes' temperature
and humidity tendencies summed.  Output: a MoistColumns.

`column_moist` (K9) is that alone.  `moist_shortwave`
(K9_moist_shortwave) goes on, in the same launch, with the do_sw branch
of PhysicsModel.compute (driver.py:221-238) on K9's columns, given a
ShortwaveForcing (kernels/column_shortwave.py): the clouds and the
shortwave, whose (tau2, stratc, tt_rsw, ssrd, ssr, tsr) are the new
radiation carry's fields.

The vertical tables and the schemes' constants reach the kernel as small
buffers in the model's dtype (MoistTables.blob, ShortwaveTables.blob),
built once from the very Python floats the plain schemes use.  The
kernels are compiled for float32 (the main path) and float64.

On a CPU tensor each wrapper runs its plain version (`column_moist_plain`,
then for moist_shortwave `column_shortwave_plain`); on a CUDA tensor it
launches its kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels import column_shortwave as csw
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics.condensation import (RTLSC, lscond,
                                                      lscond_tables)
from speedy_ml_tpu_torch.physics.convection import (RDPS, cloud_base_flux,
                                                    convmf,
                                                    entrainment_profile)
from speedy_ml_tpu_torch.physics.humidity import qsat_from_t

KERNEL_LEVELS = (5, 7, 8)   # K values compiled in csrc/column_moist.cu
N_LEVEL_FIELDS = 6          # qg, se, qsat, rh, ttend, qtend
N_PLANES = 5                # psg, rps, cbmf, precnv, precls
N_TABLES, N_SCALARS = 8, 11  # the blob: (K,) tables, then scalars


class MoistTables(NamedTuple):
    sig: np.ndarray         # (K,) float64, host
    dsig: np.ndarray
    sig_t: torch.Tensor     # (K,) in the model's dtype, on the device
    wvi2_t: torch.Tensor
    grdsig: torch.Tensor
    grdscp: torch.Tensor
    cp: float
    alhc: float
    p0: float
    grav: float
    blob: torch.Tensor      # the kernel's tables, see moist_tables


class MoistColumns(NamedTuple):
    psg: torch.Tensor       # (lat, lon) p/p0
    rps: torch.Tensor       # 1 / psg
    qg: torch.Tensor        # (K, lat, lon) q clamped at 0
    se: torch.Tensor        # dry static energy
    qsat: torch.Tensor
    rh: torch.Tensor
    itop: torch.Tensor      # (lat, lon) int64, after lscond
    icnv: torch.Tensor      # (lat, lon) int64, K-1 - convmf's itop
    cbmf: torch.Tensor      # (lat, lon) cloud-base mass flux
    precnv: torch.Tensor
    precls: torch.Tensor
    ttend: torch.Tensor     # (K, lat, lon) tt_cnv + tt_lsc
    qtend: torch.Tensor     # qt_cnv + qt_lsc


def blob_scalars(c, dsig) -> list[float]:
    """The scalars that close the blob, as the plain schemes form them
    (Python floats): cp, alhc, fm0, rdps, PSMIN, RHBL, RHIL, SMF, rtlsc,
    tfact, prg.  c holds cp, alhc, p0, grav."""
    return [c.cp, c.alhc, cloud_base_flux(dsig, c.p0, c.grav), RDPS,
            pc.PSMIN, pc.RHBL, pc.RHIL, pc.SMF, RTLSC, c.alhc / c.cp,
            c.p0 / c.grav]


def moist_tables(sig, dsig, sig_t, wvi2_t, grdsig, grdscp,
                 const) -> MoistTables:
    """The tables of both versions.  sig, dsig: (K,) float64 numpy; sig_t,
    wvi2_t, grdsig, grdscp: the model's (K,) tensors, which the plain
    version multiplies with and the blob copies; const: the physical
    constants (cp, alhc, p0, grav).  The blob, in the tensors' dtype, in
    the order csrc/column_moist.cuh reads it: sig, wvi2, entr, grdsig,
    grdscp, rhref, dqmax, dsig (K each), then blob_scalars."""
    dtype, device = sig_t.dtype, sig_t.device
    host = lambda x: torch.tensor([float(v) for v in x],
                                  dtype=torch.float64).to(dtype).to(device)
    rhref, dqmax = lscond_tables(sig)
    blob = torch.cat([sig_t, wvi2_t, host(entrainment_profile(sig)), grdsig,
                      grdscp, host(rhref), host(dqmax), host(dsig),
                      host(blob_scalars(const, dsig))]).contiguous()
    return MoistTables(sig=sig, dsig=dsig, sig_t=sig_t, wvi2_t=wvi2_t,
                       grdsig=grdsig, grdscp=grdscp, cp=const.cp,
                       alhc=const.alhc, p0=const.p0, grav=const.grav,
                       blob=blob)


def column_moist_plain(tg, qg, phig, pslg, tabs: MoistTables) -> MoistColumns:
    """The plain PyTorch version of the kernel."""
    K = tg.shape[0]
    sig, dsig = tabs.sig, tabs.dsig
    psg = torch.exp(pslg)
    rps = 1.0 / psg
    qg = torch.clamp(qg, min=0.0)
    se = tabs.cp * tg + phig
    qsat = qsat_from_t(tg, tabs.sig_t[:, None, None] * psg[None])
    rh = qg / qsat

    itop, cbmf, precnv, dfse, dfqa = convmf(
        psg, se, qg, qsat, sig=sig, dsig=dsig, wvi2=tabs.wvi2_t,
        p0=tabs.p0, grav=tabs.grav, alhc=tabs.alhc)
    tt_cnv = dfse * rps[None] * tabs.grdscp[:, None, None]
    qt_cnv = dfqa * rps[None] * tabs.grdsig[:, None, None]
    icnv = (K - 1) - itop
    itop, precls, tt_lsc, qt_lsc = lscond(
        psg, qg, qsat, itop, sig=sig, dsig=dsig, p0=tabs.p0, grav=tabs.grav,
        cp=tabs.cp, alhc=tabs.alhc)
    return MoistColumns(psg=psg, rps=rps, qg=qg, se=se, qsat=qsat, rh=rh,
                        itop=itop, icnv=icnv, cbmf=cbmf, precnv=precnv,
                        precls=precls, ttend=tt_cnv + tt_lsc,
                        qtend=qt_cnv + qt_lsc)


def moist_shortwave_plain(tg, qg, phig, pslg, tabs: MoistTables,
                          sw: csw.ShortwaveForcing):
    """The plain version of K9_moist_shortwave: column_moist_plain, then
    column_shortwave_plain on its columns."""
    m = column_moist_plain(tg, qg, phig, pslg, tabs)
    return m, csw.column_shortwave_plain(m, phig, sw.fmask, sw.sol,
                                         sw.albsfc, sw.tabs)


def _check(tg, qg, phig, pslg, tabs: MoistTables):
    """Validate the operands of either route: one floating dtype (the
    blob's), (K, lat, lon) level fields, contiguous, on one device.
    Returns (K, nlat, nlon)."""
    K, nlat, nlon = kb.level_dims(tg, "tg")
    dt, dev = tg.dtype, tg.device
    kb.require(tg, "tg", dt, (K, nlat, nlon), dev)
    kb.require(qg, "qg", dt, (K, nlat, nlon), dev)
    kb.require(phig, "phig", dt, (K, nlat, nlon), dev)
    kb.require(pslg, "pslg", dt, (nlat, nlon), dev)
    kb.require(tabs.blob, "tabs.blob", dt, (N_TABLES * K + N_SCALARS,), dev)
    return K, nlat, nlon


def _launch(tg, qg, phig, pslg, tabs: MoistTables, sw_planes=None,
            sw_tabs=None):
    """One launch of K9 (sw_planes None) or K9_moist_shortwave on the
    validated operands.  Returns (out, out_i, the shortwave's buffer or
    None)."""
    K, nlat, nlon = tg.shape
    dev = tg.device
    out = torch.empty((N_LEVEL_FIELDS * K + N_PLANES, nlat, nlon),
                      dtype=tg.dtype, device=dev)
    out_i = torch.empty((2, nlat, nlon), dtype=torch.int64, device=dev)
    sw_out = None if sw_planes is None else torch.empty(
        (5 * K + 5, nlat, nlon), dtype=tg.dtype, device=dev)
    code = kb.library().column_moist_launch(
        kb.device_index(tg), K, int(tg.dtype == torch.float64),
        tg.data_ptr(), qg.data_ptr(), phig.data_ptr(), pslg.data_ptr(),
        tabs.blob.data_ptr(), nlat * nlon, out.data_ptr(), out_i.data_ptr(),
        int(sw_planes is not None),
        None if sw_planes is None else kb.pointer_array(sw_planes),
        0 if sw_planes is None else len(sw_planes),
        None if sw_tabs is None else sw_tabs.blob.data_ptr(),
        None if sw_out is None else sw_out.data_ptr(), kb.stream_of(tg))
    kb.check(code, "column_moist" if sw_planes is None else "moist_shortwave")
    return out, out_i, sw_out


def column_moist(tg, qg, phig, pslg, tabs: MoistTables) -> MoistColumns:
    """The moist column physics of one step, K9 (see the module
    docstring)."""
    K, nlat, nlon = _check(tg, qg, phig, pslg, tabs)
    if kb.column_route("column_moist", tg.device, K, KERNEL_LEVELS) == "cpu":
        return column_moist_plain(tg, qg, phig, pslg, tabs)
    out, out_i, _ = _launch(tg, qg, phig, pslg, tabs)
    column_moist.launches += 1
    return unpack(out, out_i, K)


def moist_shortwave(tg, qg, phig, pslg, tabs: MoistTables,
                    sw: csw.ShortwaveForcing):
    """The moist column physics and the clouds and shortwave of one step
    in one launch, K9_moist_shortwave (see the module docstring).
    Returns (MoistColumns, (tau2, stratc, tt_rsw, ssrd, ssr, tsr))."""
    K, nlat, nlon = _check(tg, qg, phig, pslg, tabs)
    planes = csw.forcing_planes(sw, K, nlat, nlon, tg.dtype, tg.device)
    if kb.column_route("moist_shortwave", tg.device, K,
                       KERNEL_LEVELS) == "cpu":
        return moist_shortwave_plain(tg, qg, phig, pslg, tabs, sw)
    out, out_i, sw_out = _launch(tg, qg, phig, pslg, tabs, planes, sw.tabs)
    moist_shortwave.launches += 1
    return unpack(out, out_i, K), csw.unpack(sw_out, K)


def unpack(out, out_i, K: int) -> MoistColumns:
    """The kernel's two output buffers ((6K + 5, lat, lon) floats and
    (2, lat, lon) int64, csrc/column_moist.cuh column_moist_at) as
    views."""
    lev = lambda i: out[i * K:(i + 1) * K]
    o = N_LEVEL_FIELDS * K
    return MoistColumns(psg=out[o], rps=out[o + 1], qg=lev(0), se=lev(1),
                        qsat=lev(2), rh=lev(3), itop=out_i[0], icnv=out_i[1],
                        cbmf=out[o + 2], precnv=out[o + 3],
                        precls=out[o + 4], ttend=lev(4), qtend=lev(5))


column_moist.launches = 0
moist_shortwave.launches = 0

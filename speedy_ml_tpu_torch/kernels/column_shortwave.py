"""K13's arithmetic: the clouds and the shortwave step, its tables and
its plain version.  On the card it runs inside K9_moist_shortwave
(kernels/column_moist.py `moist_shortwave`, csrc/column_shortwave.cuh),
which forms K9's moist physics and, from them, the clouds and the
shortwave of the same columns in one launch on the shortwave steps.

`column_shortwave_plain` is, per grid column, the do_sw branch of the JAX
package's PhysicsModel.compute (physics/driver.py:221-238): the static
stability gse of the lowest layer, physics/radiation.py:165 cloud (cover,
top, stratiform cloud), :201 radsw (the two-band shortwave fluxes down
and up, the longwave transmissivities tau2 and stratc) and the heating
tt_rsw = dfabs * rps * grdscp.  In: K9's MoistColumns, phig, and a
ShortwaveForcing's land fraction, daily SolarForcing and surface albedo.
Out: (tau2, stratc, tt_rsw, ssrd, ssr, tsr), the fields of the radiation
carry.

The vertical tables and the constants reach the kernel as one small
buffer in the model's dtype (ShortwaveTables.blob), built once from the
very Python floats the plain version uses.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics import radiation as rad

N_TABLES, N_SCALARS = 3, 27  # the blob: (K,) tables, then scalars
# what K9_moist_shortwave reads beyond K9's operands, in the order of SwIO
SW_PLANES = ("fmask", "fsol", "ozupp", "ozone", "zenit", "stratz", "albsfc")


class ShortwaveTables(NamedTuple):
    sig: np.ndarray         # (K,) float64, host
    dsig: np.ndarray
    grdscp: torch.Tensor    # (K,) in the model's dtype, on the device
    blob: torch.Tensor      # the kernel's tables, see shortwave_tables


class ShortwaveForcing(NamedTuple):
    """What the shortwave reads beyond K9's outputs and phig: the land
    fraction, the daily solar fields, the surface albedo ((lat, lon)
    each) and the tables."""
    fmask: torch.Tensor
    sol: rad.SolarForcing
    albsfc: torch.Tensor
    tabs: ShortwaveTables


def blob_scalars(dsig) -> list[float]:
    """The scalars that close the blob, as cloud and radsw form them
    (Python floats)."""
    return [pc.RHCL1, 1.0 / (pc.RHCL2 - pc.RHCL1), pc.QACL, 86.4, pc.PMAXCL,
            pc.WPCL, 1.0 / (pc.GSE_S1 - pc.GSE_S0), pc.GSE_S0, pc.CLSMAX,
            1.2, pc.CLSMINL, pc.ALBCL, pc.ALBCLS, pc.ABSCL1, pc.ABSCL2,
            pc.ABSDRY, pc.ABSWV1, pc.ABSWV2, 1.0 - 0.05, 0.05, pc.ABLCL2,
            pc.ABLWIN, pc.ABLCO2, pc.ABLWV1, pc.ABLWV2, pc.ABLCL1,
            pc.EPSLW / float(dsig[0] + dsig[1])]


def shortwave_tables(sig, dsig, grdscp) -> ShortwaveTables:
    """The tables of both versions.  sig, dsig: (K,) float64 numpy;
    grdscp: the model's (K,) tensor, which the plain version multiplies
    with and the blob copies.  The blob, in grdscp's dtype, in the order
    csrc/column_shortwave.cuh reads it: dsig, abs1 = ABSDRY + ABSAER
    sig^2 (as radsw forms it; entry 0 unused), grdscp (K each), then
    blob_scalars."""
    dtype, device = grdscp.dtype, grdscp.device
    host = lambda x: torch.tensor([float(v) for v in x],
                                  dtype=torch.float64).to(dtype).to(device)
    abs1 = [pc.ABSDRY + pc.ABSAER * float(s) ** 2 for s in sig]
    blob = torch.cat([host(dsig), host(abs1), grdscp,
                      host(blob_scalars(dsig))]).contiguous()
    return ShortwaveTables(sig=sig, dsig=dsig, grdscp=grdscp, blob=blob)


def column_shortwave_plain(m, phig, fmask, sol: rad.SolarForcing, albsfc,
                           tabs: ShortwaveTables):
    """The plain PyTorch version of the kernel: gse, cloud, radsw and the
    heating, as the JAX package's do_sw."""
    K = m.se.shape[0]
    gse = (m.se[K - 2] - m.se[K - 1]) / (phig[K - 2] - phig[K - 1])
    icltop, cloudc, clstr, qcloud = rad.cloud(
        m.qg, m.rh, m.precnv, m.precls, m.itop, gse, fmask)
    ssrd, ssr, tsr, dfabs_sw, tau2, stratc = rad.radsw(
        m.psg, m.qg, icltop, cloudc, clstr, qcloud, sol, albsfc,
        sig=tabs.sig, dsig=tabs.dsig)
    tt_rsw = dfabs_sw * m.rps[None] * tabs.grdscp[:, None, None]
    return tau2, stratc, tt_rsw, ssrd, ssr, tsr


def forcing_planes(sw: ShortwaveForcing, K: int, nlat: int, nlon: int,
                   dtype, device):
    """Validate a ShortwaveForcing for K9_moist_shortwave: planes of the
    (lat, lon) shape and the dtype of K9's operands, contiguous, on their
    device, and its tables.  Returns the planes in SwIO's order."""
    named = dict(fmask=sw.fmask, albsfc=sw.albsfc, **sw.sol._asdict())
    for nm in SW_PLANES:
        kb.require(named[nm], nm, dtype, (nlat, nlon), device)
    kb.require(sw.tabs.blob, "sw.tabs.blob", dtype,
               (N_TABLES * K + N_SCALARS,), device)
    return [named[nm] for nm in SW_PLANES]


def unpack(out, K: int):
    """The shortwave's output buffer ((5K + 5, lat, lon),
    csrc/column_shortwave.cuh sw_store_column) as views: (tau2
    (K, 4, lat, lon), stratc (2, lat, lon), tt_rsw (K, lat, lon), ssrd,
    ssr, tsr)."""
    nlat, nlon = out.shape[1:]
    o = 4 * K
    return (out[:o].view(K, 4, nlat, nlon), out[o:o + 2],
            out[o + 2:o + 2 + K], out[o + K + 2], out[o + K + 3],
            out[o + K + 4])


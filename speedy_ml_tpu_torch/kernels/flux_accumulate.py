"""The window's flux sums of a leapfrog step: their plain version.

The JAX package's GCM.leapfrog (gcm.py:273-280) adds the step's surface
heat fluxes, times 1/nsteps_day, and its precipitation, times delt2/2,
to the window's FluxAccumulator:
  hflux_x + diag.hflux_x * rsteps            for x = l, s, i
  precip + (diag.precnv + diag.precls) * delt2 / 2.
On the card the sums are a phase of K12_pbl_flux
(kernels/column_pbl.py `pbl_flux`, csrc/flux_accumulate.cuh), which forms
the step's sea-ice flux hflux_i and the four sums in one launch with the
vertical diffusion; `flux_accumulate_plain` is its plain version of the
sums, which the CPU route of `pbl_flux` runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FluxTerms(NamedTuple):
    """A step's terms of the sums (the FluxDiag fields of those names)."""
    hflux_l: torch.Tensor
    hflux_s: torch.Tensor
    hflux_i: torch.Tensor
    precnv: torch.Tensor
    precls: torch.Tensor


def flux_accumulate_plain(fx, diag, rsteps: float, delt2: float):
    """fx: the accumulator (hflux_l, hflux_s, hflux_i, precip); diag: the
    step's terms (hflux_l, hflux_s, hflux_i, precnv, precls), all (lat,
    lon).  Returns the new accumulator, of fx's type (fx is left as it
    is)."""
    return type(fx)(
        hflux_l=fx.hflux_l + diag.hflux_l * rsteps,
        hflux_s=fx.hflux_s + diag.hflux_s * rsteps,
        hflux_i=fx.hflux_i + diag.hflux_i * rsteps,
        precip=fx.precip + (diag.precnv + diag.precls) * delt2 / 2.0)

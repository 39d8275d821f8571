"""Radiation: the solar forcing the ESN inputs need.

Reference: phy_radiat.f90 (solar).  Only the daily-mean insolation is
ported so far (the TISR input of the hybrid cycle); clouds and the SW/LW
schemes come with the SPEEDY slice.
"""

from __future__ import annotations

import math

import torch


def solar_flux_traced(tyear, csol: float, slat: torch.Tensor,
                      clat: torch.Tensor) -> torch.Tensor:
    """Daily-mean TOA insolation, Hartmann (1994) (phy_radiat.f90:77-121).

    tyear is a 0-d tensor (or float) on the device of slat/clat; the
    arithmetic runs in slat's dtype, as the JAX version does."""
    tyear = torch.as_tensor(tyear, dtype=slat.dtype, device=slat.device)
    alpha = 2.0 * math.pi * tyear
    ca1, sa1 = torch.cos(alpha), torch.sin(alpha)
    ca2, sa2 = ca1 * ca1 - sa1 * sa1, 2 * sa1 * ca1
    ca3, sa3 = ca1 * ca2 - sa1 * sa2, sa1 * ca2 + sa2 * ca1
    decl = (0.006918 - 0.399912 * ca1 + 0.070257 * sa1 - 0.006758 * ca2
            + 0.000907 * sa2 - 0.002697 * ca3 + 0.001480 * sa3)
    fdis = 1.000110 + 0.034221 * ca1 + 0.001280 * sa1 + 0.000719 * ca2 \
        + 0.000077 * sa2
    cdecl, sdecl = torch.cos(decl), torch.sin(decl)
    tdecl = sdecl / cdecl
    csolp = csol / math.pi
    ch0 = torch.clamp(-tdecl * slat / clat, -1.0, 1.0)
    h0 = torch.arccos(ch0)
    sh0 = torch.sin(h0)
    return csolp * fdis * (h0 * slat * sdecl + sh0 * clat * cdecl)

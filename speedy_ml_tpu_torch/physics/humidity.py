"""Humidity utilities (reference: phy_shtorh.f90).

Counterpart of the JAX package's physics/humidity.py.  Elementwise over
any leading shape; pressures normalized (p/p0), humidities in g/kg.
"""

from __future__ import annotations

import torch


def qsat_from_t(ta: torch.Tensor, p_norm) -> torch.Tensor:
    """Saturation specific humidity [g/kg] at temperature ta and pressure
    p_norm (sig*ps for a model level, ps for the surface); the two-branch
    vapour pressure over water/ice (phy_shtorh.f90:28-53)."""
    e0, c1, c2 = 6.108e-3, 17.269, 21.875
    t0, t1, t2 = 273.16, 35.86, 7.66
    es = torch.where(ta >= t0,
                     e0 * torch.exp(c1 * (ta - t0) / (ta - t1)),
                     e0 * torch.exp(c2 * (ta - t0) / (ta - t2)))
    return 622.0 * es / (p_norm - 0.378 * es)


def spec_hum_to_rh(ta, ps, sig: float, qa):
    """(T, ps, sigma, q) -> (rh, qsat); sig <= 0 means p_norm = ps."""
    qsat = qsat_from_t(ta, ps * sig if sig > 0 else ps)
    return qa / qsat, qsat


def rh_to_spec_hum(ta, ps, sig: float, rh):
    """(T, ps, sigma, rh) -> (q, qsat)."""
    qsat = qsat_from_t(ta, ps * sig if sig > 0 else ps)
    return rh * qsat, qsat

"""Diagnostics and verification utilities.

- global integration diagnostics + physical-range trap (ppo_diagns.f90);
- latitude-weighted RMS / bias / climatology verification (the math of
  the reference's offline analysis, scripts/hybrid_climo.py:28-40);
- sigma -> pressure interpolation for comparison on pressure levels.

A copy of the JAX package's diagnostics.py: the two functions of model
state take torch tensors (the spectral state's complex tensors, the grid
fields), the rest is the same numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def global_diagnostics(state, sht) -> dict:
    """Mean spectral amplitudes of the prognostic fields (diagns): 0-d
    tensors on the state's device."""
    out = {}
    for name, arr in (("vor", state.vor[1]), ("div", state.div[1]),
                      ("t", state.t[1])):
        out[f"rms_{name}"] = torch.sqrt(torch.mean(torch.abs(arr) ** 2))
    out["t_mean"] = torch.real(state.t[1, :, 0, 0]).mean() / np.sqrt(2.0)
    out["ps_mean"] = torch.real(state.ps[1, 0, 0]) / np.sqrt(2.0)
    return out


def state_in_physical_range(tg, ug, vg, qg) -> torch.Tensor:
    """The safety-gate predicate (ppo_iogrid.f90:563-577): a 0-d bool
    tensor."""
    return ((ug.min() >= -150.0) & (ug.max() <= 150.0)
            & (vg.min() >= -120.0) & (vg.max() <= 120.0)
            & (tg.min() >= 160.0) & (tg.max() <= 330.0)
            & (qg.min() >= -6.0) & (qg.max() <= 30.0))


def lat_weights(geom) -> np.ndarray:
    """cos(lat) area weights, normalized."""
    w = np.cos(geom.lat_radians)
    return w / w.sum()


def weighted_rms(a: np.ndarray, b: np.ndarray, geom) -> float:
    """Latitude-weighted RMS difference over (..., lat, lon) fields
    (hybrid_climo.py rms)."""
    w = lat_weights(geom)[:, None]
    d2 = (np.asarray(a) - np.asarray(b)) ** 2
    return float(np.sqrt(np.average(
        d2.reshape(-1, geom.nlat, geom.nlon).mean(axis=0),
        weights=np.broadcast_to(w, (geom.nlat, geom.nlon)))))


def weighted_bias(a: np.ndarray, b: np.ndarray, geom) -> float:
    w = lat_weights(geom)[:, None]
    d = np.asarray(a) - np.asarray(b)
    return float(np.average(d.reshape(-1, geom.nlat, geom.nlon).mean(axis=0),
                            weights=np.broadcast_to(w, (geom.nlat, geom.nlon))))


def sigma_to_pressure(field_sigma: np.ndarray, ps_norm: np.ndarray,
                      full_sigma: np.ndarray, p_levels: np.ndarray
                      ) -> np.ndarray:
    """Interpolate (K, lat, lon) sigma-level data to pressure levels [hPa].

    Linear in log-p, constant extrapolation (the numba setvin/verint
    equivalent of the reference analysis, hybrid_climo.py)."""
    K, nlat, nlon = field_sigma.shape
    p_sig = full_sigma[:, None, None] * ps_norm[None] * 1000.0   # hPa
    out = np.zeros((len(p_levels), nlat, nlon))
    logp_sig = np.log(p_sig)
    for li, pl in enumerate(p_levels):
        lp = np.log(pl)
        below = (logp_sig <= lp).sum(axis=0)         # first index below
        k_hi = np.clip(below, 1, K - 1)
        k_lo = k_hi - 1
        iy, ix = np.meshgrid(np.arange(nlat), np.arange(nlon), indexing="ij")
        l_lo = logp_sig[k_lo, iy, ix]
        l_hi = logp_sig[k_hi, iy, ix]
        f_lo = field_sigma[k_lo, iy, ix]
        f_hi = field_sigma[k_hi, iy, ix]
        t = np.clip((lp - l_lo) / np.maximum(l_hi - l_lo, 1e-10), 0.0, 1.0)
        out[li] = f_lo + t * (f_hi - f_lo)
    return out


def climatology(series: np.ndarray) -> np.ndarray:
    """Time-mean climatology of a (T, ...) series."""
    return np.asarray(series).mean(axis=0)


def anomaly_correlation(a: np.ndarray, b: np.ndarray, clim: np.ndarray,
                        geom) -> float:
    """Centered anomaly correlation coefficient (forecast verification)."""
    w = np.broadcast_to(lat_weights(geom)[:, None], (geom.nlat, geom.nlon))
    fa = (np.asarray(a) - clim).reshape(-1, geom.nlat, geom.nlon)
    fb = (np.asarray(b) - clim).reshape(-1, geom.nlat, geom.nlon)
    num = (w * fa * fb).sum()
    den = np.sqrt((w * fa**2).sum() * (w * fb**2).sum())
    return float(num / max(den, 1e-30))

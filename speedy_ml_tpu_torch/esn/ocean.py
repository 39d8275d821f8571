"""Slab-ocean (SST) reservoirs: their input map, target and settings.

Reference: mod_slab_ocean_reservoir.f90 — a second, slower set of
per-region ESNs predicting SST on a 7-day step (timestep_slab = 168 h =
28 atmosphere cycles, mod_reservoir.f90:37).  ml_only readout (no
imperfect-model input, initialize_slab_ocean_model:26).

Inputs per region (initialize_slab_ocean_model:88-127): the LOWEST-level
atmospheric state over the input window [4 vars + logp + precip], plus
SST and TISR — all taken as sub-blocks of the bottom atmosphere
reservoir's input vector (atmo_training_data_idx,
get_training_data_from_atmo), here a static index map.  Atmosphere
inputs are 7-day means (rolling buffer, mpires.f90:753-757).

A copy of the JAX package's esn/ocean.py in PyTorch, with the same
arithmetic (rolling_mean's cumulative-sum formula included).
"""

from __future__ import annotations

import numpy as np
import torch

from speedy_ml_tpu_torch.esn.domain import RegionClass, build_layout
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper

NVAR = 4

OCEAN_HYPER = ESNHyper(m=4000, deg=6, sigma=0.6, beta_res=1e-4,
                       beta_model=1.0, noise_mag=0.10, using_prior=False)


def ocean_index_map(cls: RegionClass, nz: int) -> np.ndarray:
    """Indices into the atmo input vector forming the ocean input vector.

    Order: [atmo bottom-level vars (patch), logp, precip, sst, tisr]
    matching the reference's atmo_training_data_idx construction."""
    xi, yi = cls.input_shape
    lay = build_layout(xi, yi, NVAR, nz, logp=True, precip=True, sst=True,
                       tisr=True)
    # atmo block flat layout: (z, y, x, v) C-order
    idx4 = np.arange(NVAR * xi * yi * nz).reshape(nz, yi, xi, NVAR)
    bottom = idx4[nz - 1].reshape(-1)          # (y, x, v) C-order, v fastest
    blocks = [bottom]
    for name in ("logp", "precip", "sst", "tisr"):
        sl = getattr(lay, name)
        blocks.append(np.arange(sl[0], sl[1]))
    return np.concatenate(blocks).astype(np.int32)


def ocean_target_slice(cls: RegionClass, nz: int) -> tuple:
    """The SST block slice of the atmo INPUT vector (the target's source)."""
    xi, yi = cls.input_shape
    lay = build_layout(xi, yi, NVAR, nz, logp=True, precip=True, sst=True,
                       tisr=True)
    return lay.sst


def sst_core_from_input(cls: RegionClass, vec_sst_block: torch.Tensor
                        ) -> torch.Tensor:
    """(Rc, xi*yi) sst input block -> (Rc, xc*yc) core values."""
    xi, yi = cls.input_shape
    dev = vec_sst_block.device
    f = vec_sst_block.reshape(vec_sst_block.shape[0], yi, xi)
    cy = torch.as_tensor(cls.core_in_input_y, dtype=torch.long, device=dev)
    cx = torch.as_tensor(cls.core_in_input_x, dtype=torch.long, device=dev)
    f = f[:, cy][:, :, cx]
    return f.reshape(vec_sst_block.shape[0], -1)


def rolling_mean(series: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing rolling mean over the leading (time) axis, same length.

    Mirrors rolling_average_over_a_period (mod_utilities.f90:1724-1804)."""
    T = series.shape[0]
    cs = torch.cumsum(series, dim=0)
    cs = torch.cat([torch.zeros_like(cs[:1]), cs], dim=0)
    idx = torch.arange(T, device=series.device)
    lo = torch.clamp(idx + 1 - window, min=0)
    count = (idx + 1 - lo).to(series.dtype)
    out = cs[idx + 1] - cs[lo]
    return out / count.reshape((T,) + (1,) * (series.ndim - 1))

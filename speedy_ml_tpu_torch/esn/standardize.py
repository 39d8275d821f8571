"""Per-region standardization of packed state vectors.

Reference: the standardize_* overloads of mod_utilities.f90 and
res_domain.f90:1189-1540.  Scalars are per (variable, level) per region —
mean/std layout [v0_z0..v0_zK, v1_z0.., ..., logp, precip, sst, tisr]
(input_grid_to_input_statevec_and_standardization,
res_domain.f90:1209-1246) — here pre-expanded to per-element vectors so
application is a fused multiply-add on the packed vector.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from speedy_ml_tpu_torch.esn.domain import build_layout


@dataclasses.dataclass(frozen=True)
class Standardizer:
    """Per-region component scalars + expanded per-element vectors."""
    comp_mean: torch.Tensor   # (R, C) per-component scalars
    comp_std: torch.Tensor
    in_mean: torch.Tensor     # (R, I) expanded over the input vector
    in_std: torch.Tensor
    out_mean: torch.Tensor    # (R, O) expanded over the target vector
    out_std: torch.Tensor

    def standardize_input(self, vec: torch.Tensor) -> torch.Tensor:
        return (vec - self.in_mean) / self.in_std

    def unstandardize_input(self, vec: torch.Tensor) -> torch.Tensor:
        return vec * self.in_std + self.in_mean

    def standardize_output(self, vec: torch.Tensor) -> torch.Tensor:
        return (vec - self.out_mean) / self.out_std

    def unstandardize_output(self, vec: torch.Tensor) -> torch.Tensor:
        return vec * self.out_std + self.out_mean


def component_expansion(nx: int, ny: int, nvar: int, nz: int, *, logp: bool,
                        precip: bool, sst: bool, tisr: bool) -> np.ndarray:
    """Map each element of a packed vector to its component index.

    Component order: (v, z) pairs with z fastest (l = v*nz + z, matching
    the l counter of the reference), then logp, precip, sst, tisr."""
    lay = build_layout(nx, ny, nvar, nz, logp=logp, precip=precip,
                       sst=sst, tisr=tisr)
    comp = np.zeros(lay.total, dtype=np.int32)
    # atmo block is flattened from (z, y, x, v) C-order
    idx = np.arange(nvar * nx * ny * nz).reshape(nz, ny, nx, nvar)
    v = np.broadcast_to(np.arange(nvar)[None, None, None, :], idx.shape)
    z = np.broadcast_to(np.arange(nz)[:, None, None, None], idx.shape)
    comp[idx.ravel()] = (v * nz + z).ravel()
    c = nvar * nz
    for name in ("logp", "precip", "sst", "tisr"):
        sl = getattr(lay, name)
        if sl is not None:
            comp[sl[0]:sl[1]] = c
            c += 1
    return comp


def n_components(nvar: int, nz: int, *, logp: bool, precip: bool, sst: bool,
                 tisr: bool) -> int:
    return nvar * nz + sum([logp, precip, sst, tisr])


def core_component_map(nx: int, ny: int, nvar: int, nz_in: int,
                       nz_core: int, z_off: int, *, logp: bool,
                       precip: bool) -> np.ndarray:
    """Component ids of a packed CORE vector, expressed in the INPUT
    vector's component numbering.

    Needed for vertical localization: the core owns levels
    [z_off, z_off+nz_core) of the input window, so core (v, z) shares the
    input component v*nz_in + z + z_off (standardize/unstandardize of
    targets reuse the input statistics, res_domain.f90:1189-1540)."""
    comp = component_expansion(nx, ny, nvar, nz_core, logp=logp,
                               precip=precip, sst=False, tisr=False)
    a_small = nvar * nz_core
    v = comp // nz_core
    z = comp % nz_core
    out = np.where(comp < a_small, v * nz_in + z + z_off,
                   comp - a_small + nvar * nz_in)
    return out.astype(np.int32)

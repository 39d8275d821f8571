"""Prognostic spectral state: two leapfrog time levels, complex tensors.

Counterpart of the JAX package's dycore/state.py (the reference's
mod_dynvar.f90).  The state is treated as immutable: a step returns new
tensors.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SpectralState:
    """Spectral prognostic variables (complex), two leapfrog time levels.

    Shapes (T = 2 time levels, K = nlev, M = mx, N = nx, R = ntracers):
      vor, div, t: (T, K, M, N); ps: (T, M, N) log(p_s / p0);
      tr: (T, R, K, M, N), tracer 0 = specific humidity [g/kg].
    """

    vor: torch.Tensor
    div: torch.Tensor
    t: torch.Tensor
    ps: torch.Tensor
    tr: torch.Tensor

    FIELDS = ("vor", "div", "t", "ps", "tr")

    @staticmethod
    def zeros(geom, cdtype=torch.complex64, device=None) -> "SpectralState":
        K, M, N, R = geom.nlev, geom.mx, geom.nx, geom.ntracers
        z = lambda *s: torch.zeros(s, dtype=cdtype, device=device)
        return SpectralState(vor=z(2, K, M, N), div=z(2, K, M, N),
                             t=z(2, K, M, N), ps=z(2, M, N),
                             tr=z(2, R, K, M, N))

    def at_level(self, j: int) -> tuple:
        """(vor, div, t, ps, tr) at leapfrog level j (0 or 1)."""
        return (self.vor[j], self.div[j], self.t[j], self.ps[j], self.tr[j])

    def map(self, fn) -> "SpectralState":
        return SpectralState(**{k: fn(getattr(self, k)) for k in self.FIELDS})

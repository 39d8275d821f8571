"""Stochastically Perturbed Parametrization Tendencies (SPPT).

Counterpart of the JAX package's physics/sppt.py (mod_sppt.f90, ECMWF
Tech. Memo. #598): a spectral AR(1) pattern with a 6-h decorrelation time
and a 500-km correlation length, sigma = 0.33 in grid space, applied as
multiplicative noise on the physics tendencies (phy_phypar.f90:218-228).
Off by default (sppt_on=.false., mod_tsteps.f90:68).

The JAX package draws its noise with jax.random keys, which torch cannot
reproduce; here the draw is a tensor argument (`step(state, eta)`), and
`noise(gen)` draws it from a torch.Generator on the pattern's device.
The AR(1) update and the perturbation of the tendencies are the two forms
of one kernel, kernels/sppt.py (K24); the pattern's synthesis to the grid
is the transform's K6.
"""

from __future__ import annotations

import numpy as np
import torch

from speedy_ml_tpu_torch.kernels.sppt import sppt_ar1

TIME_DECORR = 6.0        # hours
LEN_DECORR = 500000.0    # metres
STDDEV = 0.33
MU_DEFAULT = 1.0         # vertical taper (all ones in the reference)
NOISE_CLIP = 10.0        # the draws' parts are clipped to +-NOISE_CLIP


class SPPT:
    def __init__(self, sht, nlev: int, nsteps_day: int = 96):
        self.sht = sht
        self.nlev = nlev
        geom = sht.geom
        self.phi = float(np.exp(-(24.0 / nsteps_day) / TIME_DECORR))

        a = sht.radius
        n = np.arange(1, geom.trunc + 1)
        f0 = np.sum((2 * n + 1) * np.exp(-0.5 * (LEN_DECORR / a) ** 2
                                         * n * (n + 1)))
        f0 = np.sqrt((STDDEV ** 2 * (1 - self.phi ** 2)) / (2 * f0))
        np_dt = np.float64 if sht.dtype == torch.float64 else np.float32
        el2 = sht.el2.detach().cpu().numpy().astype(np_dt)
        sigma = np.asarray(f0 * np.exp(-0.25 * LEN_DECORR ** 2 * el2),
                           dtype=np_dt)
        # the stationary first draw's scale, (1 - phi^2)^-1/2 sigma, formed
        # as the JAX init_state forms it (the Python factor times sigma)
        sigma0 = np.asarray((1 - self.phi ** 2) ** (-0.5) * sigma, dtype=np_dt)
        t = lambda x: torch.as_tensor(x, device=sht.device)
        self.sigma, self.sigma0 = t(sigma), t(sigma0)
        self.mu = torch.full((nlev,), MU_DEFAULT, dtype=sht.dtype,
                             device=sht.device)

    def noise(self, gen: torch.Generator) -> torch.Tensor:
        """One draw (K, mx, nx) complex: standard normal real and imaginary
        parts from `gen` (on the pattern's device), unclipped (step and
        init_state clip them to +-NOISE_CLIP, as the JAX _noise does)."""
        g = self.sht.geom
        raw = torch.randn((self.nlev, g.mx, g.nx, 2), generator=gen,
                          dtype=self.sht.dtype, device=self.sht.device)
        return torch.view_as_complex(raw)

    def init_state(self, eta: torch.Tensor) -> torch.Tensor:
        """First AR(1) draw (the stationary distribution) from the draw
        eta: (1 - phi^2)^-1/2 sigma eta."""
        return sppt_ar1(torch.zeros_like(eta), eta, self.sigma0, 0.0)

    def step(self, state: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
        """Advance the AR(1) spectral pattern one model step with the draw
        eta (K, mx, nx) complex: phi state + sigma eta."""
        return sppt_ar1(state, eta, self.sigma, self.phi)

    def grid_pattern(self, state: torch.Tensor) -> torch.Tensor:
        """Grid-space pattern (K, lat, lon), clipped to +-1 (the leapfrog
        step hands K24 the unclipped synthesis, which it clips)."""
        return torch.clamp(self.sht.spec_to_grid(state), -1.0, 1.0)

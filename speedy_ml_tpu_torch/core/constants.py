"""Physical constants of the atmospheric model.

Values follow the reference GCM (see the reference's mod_dyncon1.f90:13-20
and mod_physcon.f90:11-30) so that trained hybrid weights remain transferable.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PhysicalConstants:
    rearth: float = 6.371e6        # Earth radius [m]
    omega: float = 7.292e-5        # rotation rate [1/s]
    grav: float = 9.81             # gravity [m/s^2]
    akap: float = 2.0 / 7.0        # R/cp
    cp: float = 1004.0             # specific heat of dry air [J/kg/K]
    p0: float = 1.0e5              # reference pressure [Pa]
    alhc: float = 2501.0           # latent heat of condensation [J/g]
    alhs: float = 2801.0           # latent heat of sublimation [J/g]
    sbc: float = 5.67e-8           # Stefan-Boltzmann [W/m^2/K^4]

    @property
    def rgas(self) -> float:
        return self.akap * self.cp


# Reference-atmosphere / diffusion constants (mod_dyncon0.f90)
GAMMA_LAPSE = 6.0      # reference lapse rate [K/km]
HSCALE = 7.5           # pressure scale height [km]
HSHUM = 2.5            # humidity scale height [km]
REFRH1 = 0.7           # reference near-surface relative humidity
THD = 2.4              # del^8 diffusion damping time, T and vor [h]
THDD = 2.4             # del^8 diffusion damping time, divergence [h]
THDS = 12.0            # stratospheric del^2 extra diffusion [h]
TDRS = 24.0 * 30.0     # stratospheric zonal-wind drag [h]

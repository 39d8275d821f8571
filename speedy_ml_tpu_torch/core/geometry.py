"""Model geometry: spectral truncation, Gaussian grid, sigma levels.

Ground-truth values match the reference T30L8 configuration
(the reference's mod_atparam.f90:9-14, ini_indyns.f90:38-63).
All tables are built in float64 NumPy at construction time; device dtype
is chosen by the consumer.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


def gauss_legendre(m: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes (sin(lat), pole→equator) and weights.

    Returns (x, w) for the m latitudes in one hemisphere of a 2m-point
    Gaussian grid, ordered from pole to equator, with sum(w) over both
    hemispheres = 2.  Mirrors the Newton iteration of the reference
    (spe_spectral.f90:2-43) to machine precision.
    """
    n = 2 * m
    x = np.zeros(m)
    w = np.zeros(m)
    for i in range(1, m + 1):
        z = np.cos(np.pi * (i - 0.25) / (n + 0.5))
        z1 = 2.0
        while abs(z - z1) > 3e-14:
            p1, p2 = 1.0, 0.0
            for j in range(1, n + 1):
                p3 = p2
                p2 = p1
                p1 = ((2.0 * j - 1.0) * z * p2 - (j - 1.0) * p3) / j
            pp = n * (z * p1 - p2) / (z * z - 1.0)
            z1 = z
            z = z1 - p1 / pp
        x[i - 1] = z
        w[i - 1] = 2.0 / ((1.0 - z * z) * pp * pp)
    return x, w


# Half sigma levels for the supported vertical resolutions
# (ini_indyns.f90:38-44)
_HALF_SIGMA = {
    5: [0.000, 0.150, 0.350, 0.650, 0.900, 1.000],
    7: [0.020, 0.140, 0.260, 0.420, 0.600, 0.770, 0.900, 1.000],
    8: [0.000, 0.050, 0.140, 0.260, 0.420, 0.600, 0.770, 0.900, 1.000],
}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static grid geometry. Frozen + hashable → usable as a jit static arg."""

    trunc: int = 30          # triangular truncation (ntrun = mtrun)
    nlon: int = 96           # ix
    nlat: int = 48           # il (both hemispheres)
    nlev: int = 8            # kx
    ntracers: int = 1        # ntr (tracer 1 = specific humidity, g/kg)

    @property
    def nlat_half(self) -> int:      # iy
        return self.nlat // 2

    @property
    def mx(self) -> int:             # zonal wavenumbers 0..trunc
        return self.trunc + 1

    @property
    def nx(self) -> int:             # meridional index count (trunc+2)
        return self.trunc + 2

    @property
    def ntrun1(self) -> int:
        return self.trunc + 1

    @property
    def lmax(self) -> int:           # max total wavenumber appearing in tables
        return self.mx + self.nx - 2

    @property
    def nlevp(self) -> int:
        return self.nlev + 1

    # ---- derived latitude tables (numpy, float64) ----

    @functools.cached_property
    def _gauss(self) -> tuple[np.ndarray, np.ndarray]:
        return gauss_legendre(self.nlat_half)

    @property
    def sia(self) -> np.ndarray:
        """sin(lat) at the nlat_half points, pole→equator (northern values)."""
        return self._gauss[0]

    @property
    def wt(self) -> np.ndarray:
        """Gaussian quadrature weights, pole→equator half grid."""
        return self._gauss[1]

    @property
    def coa(self) -> np.ndarray:
        return np.sqrt(1.0 - self.sia**2)

    @property
    def sin_lat(self) -> np.ndarray:
        """sin(latitude) on the full grid, south→north (index 0 = S pole side)."""
        half = self.sia
        return np.concatenate([-half, half[::-1]])

    @property
    def cos_lat(self) -> np.ndarray:
        half = self.coa
        return np.concatenate([half, half[::-1]])

    @property
    def lat_radians(self) -> np.ndarray:
        return np.arcsin(self.sin_lat)

    @property
    def lon_radians(self) -> np.ndarray:
        return 2.0 * np.pi * np.arange(self.nlon) / self.nlon

    # ---- sigma coordinates ----

    @property
    def half_sigma(self) -> np.ndarray:
        return np.asarray(_HALF_SIGMA[self.nlev])

    @property
    def dhs(self) -> np.ndarray:
        """Layer thickness in sigma."""
        hsg = self.half_sigma
        return hsg[1:] - hsg[:-1]

    @property
    def full_sigma(self) -> np.ndarray:
        hsg = self.half_sigma
        return 0.5 * (hsg[1:] + hsg[:-1])

    @property
    def dhsr(self) -> np.ndarray:
        return 0.5 / self.dhs

    def fsgr(self, akap: float) -> np.ndarray:
        return akap / (2.0 * self.full_sigma)

"""Random diabatic forcing (RDF).

Counterpart of the JAX package's physics/randfor.py (ini_inirdf.f90, the
xs_rdf/setrdf pair of phy_phypar.f90:202-313, mod_randfor.f90).  Off by
default in the reference (nstrdf=0); enable with
``PhysicsModel(..., randfh=init_randfh(...))``.

The horizontal patterns ``randfh`` are built once on the host (numpy, the
JAX package's explicit Philox stream, so both packages draw the same
values): normal values on a 19-row reduced lat-lon grid, bilinearly
interpolated to the Gaussian grid, then truncated at T18 through the
port's SpectralTransform.  The vertical/zonal modulation ``randfv`` (2,
nlat, K) lives in the radiation carry; on shortwave steps it is formed
from the step's diabatic heating (xs_rdf), and every step the forcing
setrdf(randfh, randfv) is added to the temperature tendency.  Both run in
one launch a step, kernels/rdf.py (K25); xs_rdf and setrdf here are the
plain formulas of the JAX package, for callers and tests.
"""

from __future__ import annotations

import numpy as np
import torch

from speedy_ml_tpu_torch.kernels.rdf import smooth_lat

# number of longitudes per row of the reduced random grid
# (ini_inirdf.f90:22-23)
NLONRG = np.array([1, 6, 12, 18, 24, 28, 32, 34, 36, 36,
                   36, 34, 32, 28, 24, 18, 12, 6, 1])


def init_randfh(seed: int, geom, sht, ampl: float = 0.5,
                ntrfor: int = 18, freq0: float = 0.0) -> np.ndarray:
    """Build the two horizontal random-forcing patterns (inirdf).

    Returns (2, nlat, nlon) float32 numpy.  ``ampl`` is the RMS amplitude
    of the perturbation (a negative seed flips the sign, as `indrdf < 0`
    does in the reference); ``ntrfor`` the spectral truncation of the
    forcing.  The truncation runs through `sht` (its dtype and device)."""
    nlat, nlon = geom.nlat, geom.nlon
    rng = np.random.Generator(np.random.Philox(key=[abs(int(seed)), 0x4DF]))
    if seed < 0:
        ampl = -ampl

    # colatitude coordinate of each Gaussian latitude on the 0..18 reduced
    # rows: colat = 9/asin(1) * asin(sin lat) + 9  (ini_inirdf.f90:46-49)
    rdeg = 9.0 / np.arcsin(1.0)
    colat = rdeg * np.arcsin(geom.sin_lat) + 9.0
    ll = np.add.outer(np.arange(geom.mx), np.arange(geom.nx))
    mask = torch.as_tensor((ll <= ntrfor).astype(np.float64),
                           device=sht.device).to(sht.dtype)

    rnlon = NLONRG / float(nlon)
    randfh = np.zeros((2, nlat, nlon), dtype=np.float64)
    for nf in range(2):
        # reduced grid with a periodic guard column at index 0
        # (redgrd(0,jlat) = redgrd(nlonrg,jlat), ini_inirdf.f90:64)
        redgrd = np.zeros((19, NLONRG.max() + 2))
        for jlat in range(19):
            vals = rng.normal(0.0, abs(ampl), NLONRG[jlat]) * np.sign(ampl)
            if freq0 > 0.0:
                vals[rng.uniform(size=NLONRG[jlat]) < freq0] = 0.0
            redgrd[jlat, 1:NLONRG[jlat] + 1] = vals
            redgrd[jlat, 0] = vals[-1]
            # guard beyond the row end for the interpolation's jlon+1 access
            redgrd[jlat, NLONRG[jlat] + 1] = vals[0]

        # bilinear interpolation to the Gaussian grid (ini_inirdf.f90:66-85)
        field = np.zeros((nlat, nlon))
        for j in range(nlat):
            jlat1 = int(colat[j])
            jlat2 = min(jlat1 + 1, 18)
            i = np.arange(nlon)
            out = np.zeros((2, nlon))
            for s, jl in enumerate((jlat1, jlat2)):
                rlon = i * rnlon[jl]
                jlon = rlon.astype(int)
                frac = rlon - jlon
                row = redgrd[jl]
                out[s] = row[jlon] + frac * (row[jlon + 1] - row[jlon])
            field[j] = out[0] + (colat[j] - jlat1) * (out[1] - out[0])

        # spectral truncation at ntrfor (truncg equivalent)
        spec = sht.grid_to_spec(torch.as_tensor(field, device=sht.device))
        grid = sht.spec_to_grid(spec * mask)
        randfh[nf] = grid.detach().cpu().double().numpy()
    return randfh.astype(np.float32)


def rdf_weights(sig, nlon: int, dtype, device=None) -> torch.Tensor:
    """(2, K): the vertical weights of xs_rdf's two modes times 1/nlon,
    mode 0 uniform, mode 1 sin(2 pi sig), as the JAX xs_rdf forms them
    (the weight in the dtype, then times the Python 1/nlon)."""
    rnsig = 1.0 / nlon
    sig = np.asarray(sig, dtype=np.float64)
    w = [torch.as_tensor(np.ones_like(sig) if ivm == 0
                         else np.sin(2.0 * np.pi * sig),
                         device=device).to(dtype) * rnsig
         for ivm in (0, 1)]
    return torch.stack(w).contiguous()


def xs_rdf(tt1: torch.Tensor, tt2: torch.Tensor, sig, ivm: int
           ) -> torch.Tensor:
    """Zonal-mean cross-section of diabatic forcing (phy_phypar.f90:
    231-295).  tt1/tt2: (K, nlat, nlon) heating tendencies.  Returns (nlat,
    K).  ivm selects the vertical weighting: 0 uniform, 1 sin(2 pi sig)."""
    w = rdf_weights(sig, tt1.shape[-1], tt1.dtype, tt1.device)[ivm]
    v = ((tt1 + tt2).sum(dim=-1) * w[:, None]).T       # (nlat, K)
    return smooth_lat(v)


def setrdf(randfh: torch.Tensor, randfv: torch.Tensor) -> torch.Tensor:
    """3-D random diabatic forcing pattern (phy_phypar.f90:289-313).
    randfh (2, nlat, nlon), randfv (2, nlat, K) -> (K, nlat, nlon)."""
    return torch.einsum("fjl,fjk->kjl", randfh, randfv)

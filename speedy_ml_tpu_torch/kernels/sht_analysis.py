"""K5: the spherical-harmonic analysis kernel (csrc/sht_analysis.cu) and
its plain version.

For every field b of a (B, nlat, nlon) real stack: the zonal DFT kept to
mx wavenumbers (grid times dft_fwd, the JAX package's zonal="dft"), the
hemispheric fold (north + south, north - south) weighted by the Gaussian
weights wt, and the Legendre contraction with cpol_even_s (even n, on the
sum) and cpol_odd_s (odd n, on the difference).  Fields from index n0 on
are first multiplied by pre[lat] (vdspec's 1/cos or 1/cos^2).  Output
(B, mx, nx) complex.

On a CPU tensor `sht_analysis` runs `sht_analysis_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.kernels import build as kb


def sht_analysis_plain(grid, dft_fwd, wt, cpol_even_s, cpol_odd_s,
                       pre=None, n0=None) -> torch.Tensor:
    """The plain PyTorch version (the JAX package's _specx + _specy)."""
    if pre is not None and n0 < grid.shape[0]:
        grid = torch.cat([grid[:n0], grid[n0:] * pre[:, None]])
    cd = dft_fwd.dtype
    fm = torch.einsum("bij,jm->bim", grid.to(cd), dft_fwd)
    iy = fm.shape[1] // 2
    south = fm[:, :iy]
    north = torch.flip(fm[:, iy:], dims=(1,))
    sv = (north + south) * wt[:, None]
    dv = (north - south) * wt[:, None]
    even = torch.einsum("jmn,bjm->bmn", cpol_even_s.to(cd), sv)
    odd = torch.einsum("jmn,bjm->bmn", cpol_odd_s.to(cd), dv)
    return even + odd


def sht_analysis(grid, dft_fwd, wt, cpol_even_s, cpol_odd_s, cpol_s,
                 pre=None, n0=None) -> torch.Tensor:
    """grid_to_spec of every field of grid (B, nlat, nlon); cpol_s is
    cpol_even_s + cpol_odd_s (the kernel picks the parity by n)."""
    B, nlat, nlon = grid.shape
    n0 = B if n0 is None else n0
    if grid.device.type == "cpu":
        return sht_analysis_plain(grid, dft_fwd, wt, cpol_even_s,
                                  cpol_odd_s, pre, n0)
    if grid.device.type != "cuda":
        raise ValueError(f"sht_analysis: no kernel for device {grid.device}")
    iy, mx, nx = cpol_s.shape
    dev = grid.device
    f32 = torch.float32
    if nlat != 2 * iy:
        raise ValueError(f"sht_analysis: {nlat} latitudes, tables for "
                         f"{2 * iy}")
    kb.require(grid, "grid", f32, (B, nlat, nlon), dev)
    kb.require(dft_fwd, "dft_fwd", torch.complex64, (nlon, mx), dev)
    kb.require(wt, "wt", f32, (iy,), dev)
    kb.require(cpol_s, "cpol_s", f32, (iy, mx, nx), dev)
    if pre is not None:
        kb.require(pre, "pre", f32, (nlat,), dev)
    if not 0 <= n0 <= B:
        raise ValueError(f"sht_analysis: n0 {n0} outside [0, {B}]")
    if nlon > 1024 or nlat > 1024 or nx > 1024:
        raise ValueError("sht_analysis: grid too large for one block")
    out = torch.empty((B, mx, nx), dtype=torch.complex64, device=dev)
    if B == 0:
        return out
    code = kb.library().sht_analysis_launch(
        kb.device_index(grid), grid.data_ptr(), dft_fwd.data_ptr(),
        wt.data_ptr(), cpol_s.data_ptr(),
        None if pre is None else pre.data_ptr(), n0 if pre is not None else B,
        B, nlat, nlon, mx, nx, out.data_ptr(), kb.stream_of(grid))
    kb.check(code, "sht_analysis")
    sht_analysis.launches += 1
    return out


sht_analysis.launches = 0

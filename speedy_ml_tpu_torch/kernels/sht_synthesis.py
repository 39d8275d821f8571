"""K6: the spherical-harmonic synthesis kernel (csrc/sht_synthesis.cu)
and its plain version.

For every field b of a (B, mx, nx) complex stack: the even/odd Legendre
sums with cpol_even_g / cpol_odd_g (masks folded in), unfolded into the
south (even - odd) and north (even + odd) rows, and the inverse zonal DFT
over the mx kept wavenumbers (dft_inv, factor 2 for m >= 1), real part.
Fields from index ncos on are multiplied by cosgr[lat] (kcos=2).  Output
(B, nlat, nlon) real.

On a CPU tensor `sht_synthesis` runs `sht_synthesis_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.kernels import build as kb


def sht_synthesis_plain(spec, dft_inv, cpol_even_g, cpol_odd_g, cosgr,
                        ncos=None) -> torch.Tensor:
    """The plain PyTorch version (the JAX package's _gridy + _gridx)."""
    cd = spec.dtype
    even = torch.einsum("jmn,bmn->bjm", cpol_even_g.to(cd), spec)
    odd = torch.einsum("jmn,bmn->bjm", cpol_odd_g.to(cd), spec)
    fm = torch.cat([even - odd, torch.flip(even + odd, dims=(1,))], dim=1)
    g = torch.einsum("bjm,mx->bjx", fm, dft_inv).real
    B = spec.shape[0]
    if ncos is not None and ncos < B:
        g = torch.cat([g[:ncos], g[ncos:] * cosgr[:, None]])
    return g


def sht_synthesis(spec, dft_inv, cpol_even_g, cpol_odd_g, cpol_g, cosgr,
                  ncos=None) -> torch.Tensor:
    """spec_to_grid of every field of spec (B, mx, nx); cpol_g is
    cpol_even_g + cpol_odd_g (the kernel picks the parity by n)."""
    B, mx, nx = spec.shape
    ncos = B if ncos is None else ncos
    if spec.device.type == "cpu":
        return sht_synthesis_plain(spec, dft_inv, cpol_even_g, cpol_odd_g,
                                   cosgr, ncos)
    if spec.device.type != "cuda":
        raise ValueError(f"sht_synthesis: no kernel for device {spec.device}")
    iy = cpol_g.shape[0]
    nlat, nlon = 2 * iy, dft_inv.shape[1]
    dev = spec.device
    kb.require(spec, "spec", torch.complex64, (B, mx, nx), dev)
    kb.require(dft_inv, "dft_inv", torch.complex64, (mx, nlon), dev)
    kb.require(cpol_g, "cpol_g", torch.float32, (iy, mx, nx), dev)
    kb.require(cosgr, "cosgr", torch.float32, (nlat,), dev)
    if not 0 <= ncos <= B:
        raise ValueError(f"sht_synthesis: ncos {ncos} outside [0, {B}]")
    if nlon > 1024 or mx > 1024:
        raise ValueError("sht_synthesis: grid too large for one block")
    out = torch.empty((B, nlat, nlon), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    code = kb.library().sht_synthesis_launch(
        kb.device_index(spec), spec.data_ptr(), dft_inv.data_ptr(),
        cpol_g.data_ptr(), cosgr.data_ptr(), ncos, B, nlat, nlon, mx, nx,
        out.data_ptr(), kb.stream_of(spec))
    kb.check(code, "sht_synthesis")
    sht_synthesis.launches += 1
    return out


sht_synthesis.launches = 0

"""K24: SPPT, the stochastic perturbation of the physics tendencies
(csrc/sppt.cu), in two forms, and their plain versions.

The JAX package (physics/sppt.py:54-68, physics/driver.py:290-296,
gcm.py:252-268) advances a spectral AR(1) pattern every leapfrog step,
synthesizes it to the grid, clips it to +-1, tapers it by mu per level
and multiplies the four physics tendencies by (1 + r):
- `sppt_ar1(state, eta, sigma, phi)`: phi * state + sigma * eta on the
  spectral pattern (K, mx, nx) complex, the draw's real and imaginary parts
  clipped to +-10 first (the JAX _noise clips its draws; a clipped draw
  passes unchanged).  With phi = 0 and the stationary scale it is
  SPPT.init_state.
- `sppt_perturb(tends, pattern, mu)`: r = clip(pattern, -1, 1) * mu[k]
  (pattern the synthesized grid, K6's output) or, with mu None, r =
  pattern (the JAX compute's sppt_pattern, already tapered); each of the
  tendencies (ut, vt, tt, qt), (K, lat, lon), times (1 + r), in place on
  the card.
One thread a spectral coefficient and level, or a grid point and level.

On a CPU tensor each runs its plain version; on a CUDA tensor it launches
the kernel (float32 or float64) or raises.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.kernels import build as kb

NOISE_CLIP = 10.0


def sppt_ar1_plain(state: torch.Tensor, eta: torch.Tensor,
                   sigma: torch.Tensor, phi: float) -> torch.Tensor:
    """The plain version of the AR(1) form, on the real and imaginary
    parts: phi * s + sigma * clip(eta)."""
    s, e = torch.view_as_real(state), torch.view_as_real(eta)
    e = torch.clamp(e, -NOISE_CLIP, NOISE_CLIP)
    out = phi * s + sigma[..., None] * e
    return torch.view_as_complex(out.contiguous())


def sppt_perturb_plain(tends, pattern: torch.Tensor, mu) -> tuple:
    """The plain version of the perturbation: (1 + r) * t for each
    tendency, r = clip(pattern, -1, 1) * mu[k], or pattern if mu is
    None."""
    r = pattern if mu is None else \
        torch.clamp(pattern, -1.0, 1.0) * mu[:, None, None]
    fac = 1.0 + r
    return tuple(fac * t for t in tends)


def sppt_plain(form: str, *args):
    """The plain version of either form: "ar1" (state, eta, sigma, phi) or
    "perturb" (tends, pattern, mu)."""
    return {"ar1": sppt_ar1_plain, "perturb": sppt_perturb_plain}[form](
        *args)


def _route(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type


def sppt_ar1(state: torch.Tensor, eta: torch.Tensor, sigma: torch.Tensor,
             phi: float) -> torch.Tensor:
    """state, eta: (K, mx, nx) complex64 or complex128; sigma (mx, nx) of
    the real type; phi a host number.  Returns the new pattern (a tensor
    of its own)."""
    if _route("sppt_ar1", state) == "cpu":
        return sppt_ar1_plain(state, eta, sigma, phi)
    dev, ct = state.device, state.dtype
    if ct not in (torch.complex64, torch.complex128):
        raise TypeError(f"sppt_ar1: dtype {ct}, the kernel takes complex64 "
                        "or complex128")
    rt = torch.float64 if ct == torch.complex128 else torch.float32
    K, mx, nx = state.shape
    kb.require(state, "state", ct, (K, mx, nx), dev)
    kb.require(eta, "eta", ct, (K, mx, nx), dev)
    kb.require(sigma, "sigma", rt, (mx, nx), dev)
    out = torch.empty_like(state)
    code = kb.library().sppt_ar1_launch(
        kb.device_index(state), int(rt == torch.float64), K, mx * nx,
        state.data_ptr(), eta.data_ptr(), sigma.data_ptr(), float(phi),
        NOISE_CLIP, out.data_ptr(), kb.stream_of(state))
    kb.check(code, "sppt_ar1")
    sppt_ar1.launches += 1
    return out


def sppt_perturb(tends, pattern: torch.Tensor, mu=None) -> tuple:
    """tends: four (K, lat, lon) tendencies (ut, vt, tt, qt), float32 or
    float64; pattern (K, lat, lon) of the same type; mu (K,) or None.
    Returns the perturbed tendencies (on the card the same tensors,
    written in place)."""
    tends = tuple(tends)
    if _route("sppt_perturb", pattern) == "cpu":
        return sppt_perturb_plain(tends, pattern, mu)
    dev, dt = pattern.device, pattern.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"sppt_perturb: dtype {dt}, the kernel takes "
                        "float32 or float64")
    K = pattern.shape[0]
    kb.require(pattern, "pattern", dt, None, dev)
    if len(tends) != 4:
        raise ValueError("sppt_perturb: four tendencies (ut, vt, tt, qt)")
    for i, t in enumerate(tends):
        kb.require(t, f"tends[{i}]", dt, tuple(pattern.shape), dev)
    if mu is not None:
        kb.require(mu, "mu", dt, (K,), dev)
    G = pattern.numel() // K
    code = kb.library().sppt_perturb_launch(
        kb.device_index(pattern), int(dt == torch.float64), K, G,
        pattern.data_ptr(), 0 if mu is None else mu.data_ptr(),
        kb.pointer_array(tends), kb.stream_of(pattern))
    kb.check(code, "sppt_perturb")
    sppt_perturb.launches += 1
    return tends


sppt_ar1.launches = 0
sppt_perturb.launches = 0


class _Launches:
    """K24's launches, both forms, as one counter: reading sums them,
    setting 0 resets both."""

    @property
    def launches(self) -> int:
        return sppt_ar1.launches + sppt_perturb.launches

    @launches.setter
    def launches(self, value: int):
        if value != 0:
            raise ValueError("K24's counter is only reset to 0")
        sppt_ar1.launches = sppt_perturb.launches = 0


counter = _Launches()

"""K16: the window's flux sums of a leapfrog step
(csrc/flux_accumulate.cu) and its plain version.

The JAX package's GCM.leapfrog (gcm.py:273-280) adds the step's surface
heat fluxes, times 1/nsteps_day, and its precipitation, times delt2/2,
to the window's FluxAccumulator.  `flux_accumulate` returns the new
accumulator (same type as the one given; the old one is left as it is):
  hflux_x + diag.hflux_x * rsteps            for x = l, s, i
  precip + (diag.precnv + diag.precls) * delt2 / 2.

On a CPU tensor it runs `flux_accumulate_plain`; on a CUDA tensor it
launches the kernel (float32) or raises.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.kernels import build as kb

ACC = ("hflux_l", "hflux_s", "hflux_i", "precip")
DIAG = ("hflux_l", "hflux_s", "hflux_i", "precnv", "precls")


def flux_accumulate_plain(fx, diag, rsteps: float, delt2: float):
    """The plain PyTorch version."""
    return type(fx)(
        hflux_l=fx.hflux_l + diag.hflux_l * rsteps,
        hflux_s=fx.hflux_s + diag.hflux_s * rsteps,
        hflux_i=fx.hflux_i + diag.hflux_i * rsteps,
        precip=fx.precip + (diag.precnv + diag.precls) * delt2 / 2.0)


def flux_accumulate(fx, diag, rsteps: float, delt2: float):
    """fx: the accumulator (hflux_l, hflux_s, hflux_i, precip); diag: the
    step's physics diagnostics (hflux_l, hflux_s, hflux_i, precnv,
    precls), all (lat, lon)."""
    dev = fx.precip.device
    if dev.type == "cpu":
        return flux_accumulate_plain(fx, diag, rsteps, delt2)
    if dev.type != "cuda":
        raise ValueError(f"flux_accumulate: no kernel for device {dev}")
    shape = tuple(fx.precip.shape)
    acc = [getattr(fx, nm) for nm in ACC]
    dg = [getattr(diag, nm) for nm in DIAG]
    for nm, t in zip([f"fx.{n}" for n in ACC] + [f"diag.{n}" for n in DIAG],
                     acc + dg):
        kb.require(t, nm, torch.float32, shape, dev)
    out = [torch.empty_like(a) for a in acc]
    code = kb.library().flux_accumulate_launch(
        kb.device_index(fx.precip), fx.precip.numel(), kb.pointer_array(acc),
        kb.pointer_array(dg), kb.pointer_array(out), float(rsteps),
        float(delt2), kb.stream_of(fx.precip))
    kb.check(code, "flux_accumulate")
    flux_accumulate.launches += 1
    return type(fx)(**dict(zip(ACC, out)))


flux_accumulate.launches = 0

"""The T10 aquaplanet at 8 steps a day: a limit of the model, not of the
port.

The T10 nature run of tests/test_torch_experiments.py runs 16 steps a
day because at 8 it goes non-finite within its spin-up.  Here the JAX
package's GCM and the port's run from the same T10 aquaplanet state
(init_state at 1990-01-01, stepone), step by step as the spin-up's day
loop runs them (the day's forcing, the sums zeroed, the leapfrog steps,
the coupler at the day's end), in float64 on the CPU, until the first
non-finite field or the end of a 5-day spin-up.  While both are finite
their spectral states agree within 1e-9 of each field's scale, and both
go non-finite at the same step: the step of 1,800 s is past the T10
aquaplanet's CFL limit in both packages.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.data.calendar import ModelDate as JModelDate
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.gcm import FluxAccumulator as JFluxAccumulator
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu_torch.convert import boundary_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.gcm import GCM, FluxAccumulator
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
NSD, SPINUP_DAYS = 8, 5
FIELDS = ("vor", "div", "t", "ps", "tr")


def _finite_and_error(js, ts):
    """(JAX state finite, port state finite, the largest |port - JAX|
    over each field's scale where both are finite)."""
    fin_j = fin_t = True
    worst = 0.0
    for k in FIELDS:
        a = np.asarray(getattr(js.spectral, k))
        b = getattr(ts.spectral, k).numpy()
        fa, fb = bool(np.isfinite(a).all()), bool(np.isfinite(b).all())
        fin_j, fin_t = fin_j and fa, fin_t and fb
        if fa and fb:
            worst = max(worst, float(np.abs(a - b).max())
                        / max(float(np.abs(a).max()), 1e-300))
    return fin_j, fin_t, worst


def test_t10_aquaplanet_at_8_steps_a_day_blows_up_in_both_packages():
    jg = JGeometry(**GEOM)
    jgcm = JGCM(jg, dtype=jnp.float64, nsteps_day=NSD,
                bd=jsynthetic(jg, JST(jg, dtype=jnp.float64)))
    g = Geometry(**GEOM)
    tgcm = GCM(g, dtype=torch.float64, nsteps_day=NSD, device="cpu",
               bd=boundary_from_numpy(jgcm.bd, device="cpu",
                                      dtype=torch.float64))
    jdate, tdate = JModelDate(1990, 1, 1), ModelDate(1990, 1, 1)
    js, _ = jgcm.init_state(jdate)
    ts, _ = tgcm.init_state(tdate)
    js = jgcm.stepone(js, jgcm.forcing_for(js.sfc, jdate.tyear))
    ts = tgcm.stepone(ts, tgcm.forcing_for(ts.sfc, tdate.tyear))
    assert _finite_and_error(js, ts)[2] <= 1e-9
    step, blew_up = 0, None
    for _ in range(SPINUP_DAYS):
        jf = jgcm.forcing_for(js.sfc, jdate.tyear)
        tf = tgcm.forcing_for(ts.sfc, tdate.tyear)
        js = dataclasses.replace(js, fluxes=JFluxAccumulator.zeros(
            g.nlat, g.nlon, jnp.float64))
        ts = dataclasses.replace(ts, fluxes=FluxAccumulator.zeros(
            g.nlat, g.nlon, torch.float64, "cpu"))
        for _ in range(NSD):
            js = jgcm.run_window(js, jf, 1)
            ts = tgcm.run_window(ts, tf, 1)
            step += 1
            fin_j, fin_t, err = _finite_and_error(js, ts)
            assert fin_j == fin_t, (
                f"step {step}: JAX finite {fin_j}, port finite {fin_t}")
            if not fin_j:
                blew_up = step
                break
            assert err <= 1e-9, f"step {step}: {err:.3e}"
        if blew_up is not None:
            break
        # the coupler at the day's end (run_days)
        jdate, tdate = jdate.advance_day(), tdate.advance_day()
        js = dataclasses.replace(js, sfc=jgcm._couple_jit(
            js.sfc, dict(hflux_l=js.fluxes.hflux_l,
                         hflux_s=js.fluxes.hflux_s,
                         hflux_i=js.fluxes.hflux_i),
            jnp.asarray(jdate.month - 1),
            jnp.asarray(jdate.tmonth, dtype=jnp.float64),
            jgcm.sstan_for(jdate)))
        months = tgcm.sstan_months(tdate)
        sfc, _ = tgcm.couple(ts.sfc, ts.fluxes, tdate.month - 1,
                             tdate.tmonth, sstan=None if months is None
                             else (months, tdate.tmonth))
        ts = dataclasses.replace(ts, sfc=sfc)
    # both go non-finite at the same step, within the spin-up
    assert blew_up is not None and blew_up <= SPINUP_DAYS * NSD, blew_up

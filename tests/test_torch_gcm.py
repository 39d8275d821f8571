"""Port parity of the GCM (gcm.py): init_state, stepone and leapfrog steps
with physics, at T10 in float64 on the CPU.

The JAX package's GCM (its default zonal="dft") and the port's take the
same synthetic boundary data (aquaplanet and uniform land); the port's
steps run the plain versions of K5-K8 and the plain physics.  The state
after init_state + stepone + 4 leapfrog steps (across the shortwave
cadence: steps 0 and 3 run the shortwave) is held at 1e-9 of each field
level's signal, floored at 1e-3 of the whole array's magnitude (the
humidity of the top levels is rounding noise).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.data.calendar import ModelDate as JModelDate
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu_torch.convert import (boundary_from_numpy,
                                         gcm_state_from_numpy)
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.gcm import GCM, FluxAccumulator
from speedy_ml_tpu_torch.physics.land_sea import (couple_daily,
                                                  interp_climatology)
from speedy_ml_tpu_torch.physics.boundaries import synthetic_boundary_data
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
RTOL = 1e-9
FIELDS = ("vor", "div", "t", "ps", "tr")


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    r = ref.reshape(-1, *ref.shape[-2:]) if ref.ndim > 2 else ref[None]
    g = got.reshape(r.shape)
    floor = 1e-3 * np.abs(r).max()
    for a, b in zip(g, r):
        scale = max(np.abs(b - b.mean()).max(), floor, 1e-300)
        assert np.abs(a - b).max() <= rtol * scale, (
            f"err {np.abs(a - b).max():.3e}, scale {scale:.3e}")


def _close_gcm_state(got, ref):
    for k in FIELDS:
        _close(getattr(got.spectral, k), getattr(ref.spectral, k))
    for k in ("hflux_l", "hflux_s", "hflux_i", "precip"):
        _close(getattr(got.fluxes, k), getattr(ref.fluxes, k))
    for k in ("tau2", "stratc", "tt_rsw", "ssrd", "ssr", "tsr"):
        _close(getattr(got.radiation, k), getattr(ref.radiation, k))
    assert got.istep == int(ref.istep)


@pytest.fixture(scope="module", params=["aquaplanet", "land"])
def pair(request):
    land = request.param == "land"
    jg = JGeometry(**GEOM)
    jbd = jsynthetic(jg, JST(jg, dtype=jnp.float64), land=land)
    jgcm = JGCM(jg, dtype=jnp.float64, nsteps_day=36, bd=jbd)
    g = Geometry(**GEOM)
    tgcm = GCM(g, dtype=torch.float64, nsteps_day=36,
               bd=synthetic_boundary_data(g, land=land, dtype=torch.float64),
               device="cpu")
    return jgcm, tgcm


def test_init_stepone_and_leapfrog_match(pair):
    jgcm, tgcm = pair
    js, jf = jgcm.init_state(JModelDate(1990, 7, 1))
    ts, tf = tgcm.init_state(ModelDate(1990, 7, 1))
    _close_gcm_state(ts, js)
    for k in tf.__dataclass_fields__:
        _close(getattr(tf, k), getattr(jf, k))
    js, ts = jgcm.stepone(js, jf), tgcm.stepone(ts, tf)
    _close_gcm_state(ts, js)
    js, ts = jgcm.run_window(js, jf, 4), tgcm.run_window(ts, tf, 4)
    assert ts.istep == 4
    _close_gcm_state(ts, js)
    # a converted JAX state continues like the port's own
    conv = gcm_state_from_numpy(js, device="cpu", dtype=torch.float64)
    a, b = tgcm.leapfrog(conv, tf), tgcm.leapfrog(ts, tf)
    _close_gcm_state(a, b)


def test_boundary_conversion_and_unported_options(pair, monkeypatch):
    jgcm, tgcm = pair
    bd = boundary_from_numpy(jgcm.bd, device="cpu", dtype=torch.float64)
    for k in bd.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(bd, k).numpy(),
                                      getattr(tgcm.bd, k).numpy(), k)
    _close(tgcm.phis, jgcm.phis, 1e-12)
    g = tgcm.geom
    # without bd the GCM reads the boundary files: from bc_path or
    # $SPEEDY_ML_BC_PATH (tests/test_torch_boundaries.py), else it raises
    monkeypatch.delenv("SPEEDY_ML_BC_PATH", raising=False)
    with pytest.raises(FileNotFoundError, match="boundary files"):
        GCM(g, dtype=torch.float64, device="cpu")
    # SPPT and cgrate are ported (tests/test_torch_optional_physics.py);
    # off by default, as in the JAX package
    assert tgcm.sppt is None and not tgcm.dyn.cgrate_on
    on = GCM(g, bd=tgcm.bd, sppt_on=True, cgrate_on=True, device="cpu",
             dtype=torch.float64)
    assert on.sppt is not None and on.dyn.cgrate_on
    # GCM.set_mesh is ported (tests/test_torch_sharded_gcm.py), with the
    # cgrate limiter on the m ranges (tests/test_torch_mesh_loop.py)
    from speedy_ml_tpu_torch.parallel.mesh import Mesh
    assert on.mesh is None
    on.set_mesh(Mesh(["cpu"] * 2))
    assert on.mesh is not None and on.sdyn.dyn.cgrate_on


def test_run_days_runs_the_day_and_the_coupler(pair):
    """GCM.run_days for one day (JAX parity with the flags and anomalies:
    tests/test_torch_land_sea.py) is fordate, the sums zeroed, stepone
    first, 36 steps and couple_daily at the new date, bit for bit; on the
    land planet the slab land model moves stl_lm off the climatology, on
    the aquaplanet it stays there."""
    _, tgcm = pair
    date = ModelDate(1990, 7, 1)
    ts, tf = tgcm.init_state(date)
    got, day2 = tgcm.run_days(ts, date, 1, stepone_first=True)
    assert (day2.month, day2.day) == (7, 2) and got.istep == 36
    g = tgcm.geom
    ref = dataclasses.replace(ts, fluxes=FluxAccumulator.zeros(
        g.nlat, g.nlon, torch.float64, "cpu"))
    forcing = tgcm.forcing_for(ts.sfc, date.tyear)
    ref = tgcm.run_window(tgcm.stepone(ref, forcing), forcing, 36)
    sfc = couple_daily(ref.sfc, tgcm.slab, tgcm.bd, ref.fluxes,
                       day2.month - 1, day2.tmonth, flags=tgcm.cpl)
    for k in FIELDS:
        assert torch.equal(getattr(got.spectral, k),
                           getattr(ref.spectral, k)), k
    for k in sfc.__dataclass_fields__:
        assert torch.equal(getattr(got.sfc, k), getattr(sfc, k)), k
    stlcl = interp_climatology(tgcm.bd, day2.month - 1,
                               day2.tmonth)["stlcl"]
    moved = float((got.sfc.stl_lm - stlcl).abs().max())
    assert (moved > 1e-6) == bool(tgcm.bd.fmask_l.max() > 0.5), moved

"""Port parity of the dry dynamical core (dycore/, K5-K8 plain).

The JAX package's DycoreModel (zonal="dft", float64) and the port's
(float64 on the CPU, where the step runs the plain versions of K5, K6,
K7 and K8) start from the same state: the rest atmosphere over a
Gaussian mountain plus a small red perturbation made with numpy from a
seed.  Tolerances: the implicit tables 1e-13 relative; every tendency,
step and the 20-step integration 1e-10 of each field level's signal
(its largest departure from its mean), floored at 1e-3 of the whole
array's magnitude (levels that hold only rounding noise, as the
humidity of the top levels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.dycore.init import rest_state as jrest
from speedy_ml_tpu.dycore.model import DycoreModel as JDycore
from speedy_ml_tpu.dycore.state import SpectralState as JState
from speedy_ml_tpu_torch.convert import spectral_state_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.dycore.init import rest_state
from speedy_ml_tpu_torch.dycore.model import DycoreModel
from speedy_ml_tpu_torch.dycore.state import SpectralState
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
RTOL = 1e-10
FIELDS = ("vor", "div", "t", "ps", "tr")


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    r = ref.reshape(-1, *ref.shape[-2:]) if ref.ndim > 2 else ref[None]
    g = got.reshape(r.shape)
    floor = 1e-3 * np.abs(r).max()
    for a, b in zip(g, r):
        scale = max(np.abs(b - b.mean()).max(), floor)
        assert np.abs(a - b).max() <= rtol * scale + 1e-300, (
            f"err {np.abs(a - b).max():.3e}, scale {scale:.3e}")


def _close_state(got, ref, rtol=RTOL):
    for k in FIELDS:
        _close(getattr(got, k), getattr(ref, k), rtol)


@pytest.fixture(scope="module")
def models():
    jd = JDycore(JGeometry(**GEOM), dtype=jnp.float64, zonal="dft")
    td = DycoreModel(Geometry(**GEOM), dtype=torch.float64, device="cpu")
    g = td.geom
    lat, lon = g.lat_radians[:, None], g.lon_radians[None, :]
    orog = 9.81 * 1500.0 * np.exp(-((lat - 0.6) ** 2 + (lon - 2.0) ** 2)
                                  / 0.2)
    js, jphis = jrest(jd, jnp.asarray(orog))
    # a small red perturbation, real at m = 0
    rng = np.random.default_rng(0)
    ll = np.add.outer(np.arange(g.mx), np.arange(g.nx))
    red = (ll <= g.trunc) / (1.0 + ll)
    scale = dict(vor=2e-6, div=5e-7, t=0.3, ps=1e-3, tr=0.05)
    pert = {}
    for k in FIELDS:
        a = np.asarray(getattr(js, k))
        z = (rng.normal(size=a.shape) + 1j * rng.normal(size=a.shape)) * red
        z[..., 0, :] = z[..., 0, :].real
        z = np.broadcast_to(z[:1], a.shape)   # same on both levels
        pert[k] = a + scale[k] * z
    js = JState(**{k: jnp.asarray(v) for k, v in pert.items()})
    ts = spectral_state_from_numpy(js, device="cpu", dtype=torch.float64)
    return jd, td, js, ts, jphis, torch.as_tensor(np.array(jphis))


def test_rest_state_matches(models):
    jd, td, *_ = models
    g = td.geom
    orog = np.random.default_rng(1).uniform(0.0, 2e4, (g.nlat, g.nlon))
    js, jphis = jrest(jd, jnp.asarray(orog))
    ts, tphis = rest_state(td, torch.as_tensor(orog))
    _close_state(ts, js, 1e-12)
    _close(tphis, jphis, 1e-12)


def test_implicit_tables_match(models):
    jd, td, *_ = models
    for name in ("imp_half", "imp_full", "imp_double"):
        j, t = getattr(jd, name), getattr(td, name)
        for f in j._fields:
            np.testing.assert_allclose(
                getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                rtol=1e-13, atol=1e-13 * np.abs(getattr(j, f)).max(),
                err_msg=f"{name}.{f}")
        assert t.blob is None   # float64: no kernel blob


def test_geopotential_matches(models):
    jd, td, js, ts, jphis, tphis = models
    _close(td.geopotential(ts.t[0], tphis), jd.geopotential(js.t[0], jphis))


@pytest.mark.parametrize("j2", [1, 2])
def test_grid_and_spectral_tendencies_match(models, j2):
    jd, td, js, ts, *_ = models
    (jt, jgf) = jd.grid_tendencies(js, j2 - 1, jd.imp_double)
    (tt, tgf) = td.grid_tendencies(ts, j2 - 1, td.imp_double)
    for a, b in zip(tt, jt):
        _close(a, b)
    for k in ("sigdt", "puv", "umean", "dmean"):
        _close(tgf[k], jgf[k])
    for a, b in zip(td.to_spectral_tendencies(*tt[:4], tgf),
                    jd.to_spectral_tendencies(*jt[:4], jgf)):
        _close(a, b)


def test_sptend_and_implicit_correction_match(models):
    jd, td, js, ts, jphis, tphis = models
    (jt, jgf) = jd.grid_tendencies(js, 1, jd.imp_double)
    _, jdiv, jtdt, _ = jd.to_spectral_tendencies(*jt[:4], jgf)
    (tt, tgf) = td.grid_tendencies(ts, 1, td.imp_double)
    _, tdiv, ttdt, _ = td.to_spectral_tendencies(*tt[:4], tgf)
    jout = jd.sptend(js, 0, jd.imp_double, jphis, jdiv, jtdt, jt[4])
    tout = td.sptend(ts, 0, td.imp_double, tphis, tdiv, ttdt, tt[4])
    for a, b in zip(tout, jout):
        _close(a, b)
    for a, b in zip(td.implicit_correction(td.imp_double, *tout),
                    jd.implicit_correction(jd.imp_double, *jout)):
        _close(a, b)


@pytest.mark.parametrize("j1,j2", [(1, 1), (1, 2), (2, 2)])
def test_dry_step_matches(models, j1, j2):
    jd, td, js, ts, jphis, tphis = models
    key = {(1, 1): ("imp_half", 0.5 * jd.delt), (1, 2): ("imp_full", jd.delt),
           (2, 2): ("imp_double", jd.delt2)}[(j1, j2)]
    a, _ = jd.step(js, jphis, j1, j2, key[1], getattr(jd, key[0]))
    b, _ = td.step(ts, tphis, j1, j2, key[1], getattr(td, key[0]))
    _close_state(b, a)


def test_twenty_dry_steps_match(models):
    jd, td, js, ts, jphis, tphis = models
    a, _ = jd.stepone(js, jphis)
    b, _ = td.stepone(ts, tphis)
    for _ in range(20):
        a, _ = jd.leapfrog_step(a, jphis)
        b, _ = td.leapfrog_step(b, tphis)
    assert np.isfinite(np.asarray(a.t)).all()
    # the run is not trivial: the flow grew from the perturbation
    assert float(np.abs(np.asarray(a.div[0])).max()) > 1e-7
    _close_state(b, a)


def test_cgrate_and_state_helpers():
    g = Geometry(**GEOM)
    # the limiter is ported (tests/test_torch_optional_physics.py)
    assert DycoreModel(g, dtype=torch.float64, cgrate_on=True,
                       device="cpu").cgrate_on
    assert not DycoreModel(g, dtype=torch.float64, device="cpu").cgrate_on
    z = SpectralState.zeros(g, torch.complex128)
    assert z.tr.shape == (2, 1, 8, g.mx, g.nx)
    assert [a.shape for a in z.at_level(1)][3] == (g.mx, g.nx)

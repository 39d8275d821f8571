"""Port parity of the optional physics (A15): SPPT, random diabatic forcing
(RDF) and the cgrate limiter, against the JAX package at T10 in float64
on the CPU, and the arithmetic of their kernels K24-K26 without a card.

- init_randfh: the same Philox stream, exactly;
- xs_rdf, setrdf and rdf_plain (K25's plain version), and a physics step
  with RDF on a shortwave step and on another step: 1e-12;
- SPPT.init_state, step and grid_pattern with the same draws: the JAX
  instance's _noise is replaced, inside the test, by one that returns
  the draw (jax.random cannot be reproduced in torch): 1e-12;
- DycoreModel._cgrate in the grow, slow and decay cases of
  tests/test_cgrate.py: 1e-10;
- stepone and leapfrog steps of a GCM with SPPT, RDF and cgrate all on
  (the same draw every step: the JAX window is traced once): 1e-9 of
  each field level's signal, as tests/test_torch_gcm.py holds the GCM;
- kernels/csrc/optional_host.cpp, the very headers of K24-K26 compiled
  with g++ -ffp-contract=off, bit for bit against the plain versions in
  float32 and float64 (the kernels follow the plain versions' order of
  operations and sums), K25's and K26's clusters with their blocks run
  first to last and last to first, at T10 and at T30's widths with
  levels and latitude rows that do not divide into the clusters' 8
  blocks; an order of sums reversed must differ.
The launch code runs only on a card (chip_smoke.py phase 16).
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.data.calendar import ModelDate as JModelDate
from speedy_ml_tpu.dycore.model import DycoreModel as JDycore
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.physics import randfor as jrandfor
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu.physics.sppt import SPPT as JSPPT
from speedy_ml_tpu_torch.convert import gcm_state_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.core.spectral import SpectralTransform
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.dycore.model import DycoreModel
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.kernels import cgrate as k26
from speedy_ml_tpu_torch.kernels import rdf as k25
from speedy_ml_tpu_torch.kernels import sppt as k24
from speedy_ml_tpu_torch.physics import randfor
from speedy_ml_tpu_torch.physics.boundaries import synthetic_boundary_data
from speedy_ml_tpu_torch.physics.driver import PhysicsModel, SpptGrid
from speedy_ml_tpu_torch.physics.sppt import SPPT
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
F64 = torch.float64
FIELDS = ("vor", "div", "t", "ps", "tr")


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _close(got, ref, rtol):
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, f"err {err:.3e}, scale {scale:.3e}"


def _close_levels(got, ref, rtol=1e-9):
    """Each field level against its signal, floored at 1e-3 of the whole
    array's magnitude (tests/test_torch_gcm.py)."""
    got, ref = _np(got), np.asarray(ref)
    assert got.shape == ref.shape
    r = ref.reshape(-1, *ref.shape[-2:]) if ref.ndim > 2 else ref[None]
    g = got.reshape(r.shape)
    floor = 1e-3 * np.abs(r).max()
    for a, b in zip(g, r):
        scale = max(np.abs(b - b.mean()).max(), floor, 1e-300)
        assert np.abs(a - b).max() <= rtol * scale, (
            f"err {np.abs(a - b).max():.3e}, scale {scale:.3e}")


@pytest.fixture(scope="module")
def shts():
    jg = JGeometry(**GEOM)
    g = Geometry(**GEOM)
    return (jg, JST(jg, dtype=jnp.float64),
            g, SpectralTransform(g, dtype=F64, device="cpu"))


# ---------------------------------------------------------------- RDF

@pytest.mark.parametrize("seed", [7, -3])
def test_init_randfh_is_the_same_stream(shts, seed):
    jg, jsht, g, sht = shts
    a = jrandfor.init_randfh(seed, jg, jsht, ampl=0.5, ntrfor=8,
                             freq0=0.2 if seed < 0 else 0.0)
    b = randfor.init_randfh(seed, g, sht, ampl=0.5, ntrfor=8,
                            freq0=0.2 if seed < 0 else 0.0)
    assert b.dtype == np.float32 and b.shape == (2, g.nlat, g.nlon)
    np.testing.assert_array_equal(b, a)


def _heating(g, seed):
    rng = np.random.default_rng(seed)
    K = g.nlev
    return [rng.normal(0.0, 1e-4, (K, g.nlat, g.nlon)) for _ in range(3)] + [
        rng.uniform(0.9, 1.3, (g.nlat, g.nlon))]


@pytest.mark.parametrize("ivm", [0, 1])
def test_xs_rdf_and_setrdf_match(shts, ivm):
    jg, jsht, g, sht = shts
    tt1, tt2, _, _ = _heating(g, 1)
    sig = np.asarray(jg.full_sigma)
    ref = jrandfor.xs_rdf(jnp.asarray(tt1), jnp.asarray(tt2), sig, ivm)
    got = randfor.xs_rdf(torch.as_tensor(tt1), torch.as_tensor(tt2), sig,
                         ivm)
    _close(got, ref, 1e-12)
    h = randfor.init_randfh(5, g, sht)
    v = np.random.default_rng(2).normal(size=(2, g.nlat, g.nlev))
    _close(randfor.setrdf(torch.as_tensor(h, dtype=F64), torch.as_tensor(v)),
           jrandfor.setrdf(jnp.asarray(h, dtype=jnp.float64),
                           jnp.asarray(v)), 1e-12)


@pytest.mark.parametrize("xs", [True, False], ids=["shortwave", "other"])
def test_rdf_plain_matches_xs_rdf_then_setrdf(shts, xs):
    """K25's plain version (tt_rlw formed as K12 forms it, the zonal sums
    in order) against the JAX formulas on the same heating."""
    jg, jsht, g, sht = shts
    ttm, tt_rsw, dfabs, psg = _heating(g, 3)
    rps = 1.0 / psg
    grdscp = np.linspace(1e-3, 2e-3, g.nlev)
    tt = np.random.default_rng(4).normal(0.0, 1e-5, ttm.shape)
    h = randfor.init_randfh(9, g, sht).astype(np.float64)
    v_in = np.random.default_rng(5).normal(0.0, 1e-5, (2, g.nlat, g.nlev))
    sig = np.asarray(jg.full_sigma)
    if xs:
        rlw = dfabs * rps[None] * grdscp[:, None, None]
        v_ref = jnp.stack([
            jrandfor.xs_rdf(jnp.asarray(ttm), jnp.zeros_like(ttm), sig, 0),
            jrandfor.xs_rdf(jnp.asarray(tt_rsw), jnp.asarray(rlw), sig, 1)])
    else:
        v_ref = jnp.asarray(v_in)
    tt_ref = tt + jrandfor.setrdf(jnp.asarray(h), v_ref)
    heat = k25.RdfHeating(*map(torch.as_tensor, (ttm, tt_rsw, dfabs, rps,
                                                 grdscp)),
                          w=randfor.rdf_weights(sig, g.nlon, F64))
    got_tt, got_v = k25.rdf(torch.as_tensor(tt), torch.as_tensor(h),
                            torch.as_tensor(v_in), heat if xs else None)
    _close(got_v, v_ref, 1e-12)
    _close(got_tt, tt_ref, 1e-12)


@pytest.fixture(scope="module")
def gcm_pair():
    """JAX and port GCMs (T10, float64, the aquaplanet) with SPPT, cgrate
    and RDF on (the same init_randfh patterns in both)."""
    jg = JGeometry(**GEOM)
    jbd = jsynthetic(jg, JST(jg, dtype=jnp.float64))
    jgcm = JGCM(jg, dtype=jnp.float64, nsteps_day=36, bd=jbd, sppt_on=True,
                cgrate_on=True)
    g = Geometry(**GEOM)
    tgcm = GCM(g, dtype=F64, nsteps_day=36,
               bd=synthetic_boundary_data(g, dtype=F64), sppt_on=True,
               cgrate_on=True, device="cpu")
    h = randfor.init_randfh(11, g, tgcm.sht)
    jgcm.phys.randfh = np.asarray(h, dtype=np.float64)
    tgcm.phys.randfh = h
    return jgcm, tgcm


@pytest.mark.parametrize("lradsw", [True, False], ids=["shortwave", "other"])
def test_physics_step_with_rdf_matches(gcm_pair, lradsw):
    """One physics step with RDF (the carry's randfv seeded, so that the
    step off the shortwave adds a forcing too), JAX _physics_fn against
    the port's."""
    jgcm, tgcm = gcm_pair
    js, jf = jgcm.init_state(JModelDate(1990, 7, 1))
    v = np.random.default_rng(6).normal(0.0, 1e-5, (2, 16, 8))
    js = dataclasses.replace(js, radiation=dataclasses.replace(
        js.radiation, randfv=jnp.asarray(v)))
    ts = gcm_state_from_numpy(js, device="cpu", dtype=F64)
    _, tf = tgcm.init_state(ModelDate(1990, 7, 1))
    jt, (jc, _) = jgcm._physics_fn(js.spectral, 0, jgcm.dyn, js.sfc, jf,
                                   js.radiation, jnp.asarray(lradsw))
    tt, (tc, _, _) = tgcm._physics_fn(ts.spectral, 0, tgcm.dyn, ts.sfc, tf,
                                      ts.radiation, lradsw)
    for k in ("u", "v", "t", "tr"):
        _close(getattr(tt, k), getattr(jt, k), 1e-12)
    _close(tc.randfv, jc.randfv, 1e-12)
    if not lradsw:
        np.testing.assert_array_equal(_np(tc.randfv), v)


def test_randfh_is_checked_and_stored():
    g = Geometry(**GEOM)
    phys = PhysicsModel(g, tgcm_const(), randfh=np.ones((2, 16, 32)),
                        device="cpu", dtype=F64)
    assert phys.randfh.dtype == F64 and phys.randfh.shape == (2, 16, 32)
    with pytest.raises(ValueError, match="randfh"):
        phys.randfh = np.zeros(3)
    phys.randfh = None
    assert phys.randfh is None


def tgcm_const():
    from speedy_ml_tpu_torch.core.constants import PhysicalConstants
    return PhysicalConstants()


# --------------------------------------------------------------- SPPT

def test_sppt_init_step_and_pattern_match(shts):
    jg, jsht, g, sht = shts
    js = JSPPT(jsht, g.nlev, nsteps_day=36)
    ts = SPPT(sht, g.nlev, nsteps_day=36)
    assert ts.phi == js.phi
    _close(ts.sigma, js.sigma, 1e-15)
    rng = np.random.default_rng(8)
    shp = (g.nlev, g.mx, g.nx)
    draws = [rng.normal(size=shp) + 1j * rng.normal(size=shp)
             for _ in range(3)]
    draws[1].real[0, 1, 2] = 12.0        # a part beyond the clip
    clip = lambda d: np.clip(d.real, -10, 10) + 1j * np.clip(d.imag, -10, 10)
    js._noise = lambda key: jnp.asarray(clip(draws[js._i]))
    js._i = 0
    a = js.init_state(None)
    b = ts.init_state(torch.as_tensor(draws[0]))
    _close(b, a, 1e-12)
    for i in (1, 2):
        js._i = i
        a = js.step(a, None)
        b = ts.step(b, torch.as_tensor(draws[i]))
        _close(b, a, 1e-12)
    _close(ts.grid_pattern(b), js.grid_pattern(a), 1e-12)
    assert float(np.abs(_np(ts.grid_pattern(b))).max()) <= 1.0


def test_sppt_noise_draws_from_the_generator(shts):
    _, _, g, sht = shts
    sp = SPPT(sht, g.nlev)
    gen = torch.Generator().manual_seed(3)
    a = sp.noise(gen)
    b = sp.noise(torch.Generator().manual_seed(3))
    assert a.shape == (g.nlev, g.mx, g.nx) and a.dtype == torch.complex128
    assert torch.equal(a, b)
    assert not torch.equal(a, sp.noise(gen))
    assert 0.8 < float(a.real.std()) < 1.2


# ------------------------------------------------------------- cgrate

@pytest.fixture(scope="module")
def dycores():
    jg = JGeometry(**GEOM)
    g = Geometry(**GEOM)
    return (JDycore(jg, dtype=jnp.float64, cgrate_on=True),
            DycoreModel(g, dtype=F64, cgrate_on=True, device="cpu"))


@pytest.mark.parametrize("case", ["grow", "slow", "decay"])
def test_cgrate_matches(dycores, case):
    jm, tm = dycores
    g = tm.geom
    rng = np.random.default_rng(0)
    shp = (g.nlev, g.mx, g.nx)
    f = rng.normal(0, 1e-5, shp) + 1j * rng.normal(0, 1e-5, shp)
    f = np.asarray(jm.sht.trunct(jnp.asarray(f)))
    fdt = {"grow": f * 1e-3, "slow": f * 1e-9, "decay": -f * 1e-3}[case]
    # div grows at another rate: each field takes its own cd
    fdt_d = fdt * (0.5 if case == "grow" else 1.0)
    jv, jd = jm._cgrate(jnp.asarray(f), jnp.asarray(f), jnp.asarray(fdt),
                        jnp.asarray(fdt_d))
    tv, td = tm._cgrate(*(torch.tensor(np.array(a))
                          for a in (f, f, fdt, fdt_d)))
    _close(tv, jv, 1e-10)
    _close(td, jd, 1e-10)
    if case == "grow":
        # the damping took place: 0.8e-3 of the field off the eddies
        expect = fdt[:, 1:] - 0.8e-3 * f[:, 1:]
        _close(tv[:, 1:], expect, 1e-10)
        np.testing.assert_array_equal(_np(tv[:, 0]), fdt[:, 0])
    else:
        np.testing.assert_array_equal(_np(tv), fdt)


def test_steps_with_sppt_rdf_and_cgrate_match(gcm_pair):
    """init_state, stepone and three leapfrog steps (across the shortwave
    cadence) with all three options on; both sides draw the same eta."""
    jgcm, tgcm = gcm_pair
    g = tgcm.geom
    rng = np.random.default_rng(12)
    shp = (g.nlev, g.mx, g.nx)
    eta = rng.normal(size=shp) + 1j * rng.normal(size=shp)
    jgcm.sppt._noise = lambda key: jnp.asarray(eta)
    js, jf = jgcm.init_state(JModelDate(1990, 7, 1))
    ts, tf = tgcm.init_state(ModelDate(1990, 7, 1))
    ts = dataclasses.replace(ts, sppt_spec=tgcm.sppt.init_state(
        torch.as_tensor(eta)))
    _close(ts.sppt_spec, js.sppt_spec, 1e-12)
    js, ts = jgcm.stepone(js, jf), tgcm.stepone(ts, tf)
    js = jgcm.run_window(js, jf, 3)
    for _ in range(3):
        ts = tgcm.leapfrog(ts, tf, eta=torch.as_tensor(eta))
    assert ts.istep == 3
    for k in FIELDS:
        _close_levels(getattr(ts.spectral, k), getattr(js.spectral, k))
    _close_levels(ts.sppt_spec, js.sppt_spec)
    _close(ts.radiation.randfv, js.radiation.randfv, 1e-9)
    assert float(np.abs(_np(ts.radiation.randfv)).max()) > 0.0
    # the options changed the run: the port's plain GCM differs
    plain = GCM(tgcm.geom, dtype=F64, nsteps_day=36, bd=tgcm.bd,
                device="cpu")
    ps, pf = plain.init_state(ModelDate(1990, 7, 1))
    ps = plain.run_window(plain.stepone(ps, pf), pf, 3)
    assert float((ps.spectral.t - ts.spectral.t).abs().max()) > 1e-6


def test_gcm_draws_sppt_from_its_generator(gcm_pair):
    """Without a given eta each step draws from the state's generator:
    the same seed gives the same run, another seed another; a window
    built without the pattern (the hybrid's cold start) runs without
    SPPT, whatever sppt_on."""
    _, tgcm = gcm_pair
    runs = []
    for seed in (1, 1, 2):
        s, f = tgcm.init_state(ModelDate(1990, 7, 1), sppt_seed=seed)
        s = tgcm.leapfrog(tgcm.stepone(s, f), f)
        runs.append(s)
    assert torch.equal(runs[0].sppt_spec, runs[1].sppt_spec)
    assert torch.equal(runs[0].spectral.t, runs[1].spectral.t)
    assert not torch.equal(runs[0].sppt_spec, runs[2].sppt_spec)
    s, f = tgcm.init_state(ModelDate(1990, 7, 1))
    bare = dataclasses.replace(s, sppt_spec=None, sppt_gen=None)
    out = tgcm.leapfrog(bare, f)
    assert out.sppt_spec is None and out.sppt_gen is None


# ------------------------------------------ the kernels' host arithmetic

@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/optional_host.cpp built with g++ and loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' arithmetic for the host")
    so = tmp_path_factory.mktemp("optional_host") / "liboptional_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    str(CSRC / "optional_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_double)
    pv = ctypes.POINTER(vp)
    lib.sppt_ar1_host.argtypes = [i, i, ll, vp, vp, vp, d, d, vp]
    lib.sppt_perturb_host.argtypes = [i, i, ll, vp, vp, pv]
    lib.rdf_host.argtypes = [i, i, i, i, i] + [vp] * 10 + [i]
    lib.cgrate_host.argtypes = [i, i, i, i, pv, pv, vp, vp, pv, i, d, d, d,
                                d, i]
    return lib


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


DTYPES = {"f64": (torch.float64, torch.complex128),
          "f32": (torch.float32, torch.complex64)}
# the host build's block orders: first to last, last to first
ORDERS = (0, 1)


def _rdf_host(lib, tt, h, v_in, heat, order):
    """K25's whole forms on the host build: (tt', randfv' or None)."""
    K, nlat, nlon = tt.shape
    got_tt = tt.clone()
    got_v = torch.full_like(v_in, float("nan"))
    ptrs = [x.data_ptr() for x in heat] if heat is not None else [0] * 6
    lib.rdf_host(int(tt.dtype == F64), K, nlat, nlon, int(heat is not None),
                 got_tt.data_ptr(), h.data_ptr(), v_in.data_ptr(), *ptrs,
                 got_v.data_ptr() if heat is not None else 0, order)
    return got_tt, (got_v if heat is not None else None)


def _cgrate_host(lib, dyn, state, out, j1, dt, eps, order):
    """K26's whole form on the host build: [vor', div']."""
    g = dyn.geom
    K, mx, nx = state.vor.shape[1:]
    got = [out.vor.clone(), out.div.clone()]
    lib.cgrate_host(int(out.vor.dtype == torch.complex128), K, mx, nx,
                    _ptrs([state.vor[0], state.div[0]]),
                    _ptrs([state.vor[j1 - 1], state.div[j1 - 1]]),
                    dyn.sht.elm2.data_ptr(), dyn.sht.trfilt.data_ptr(),
                    _ptrs(got), int(g.nlon == 4 * g.nlat_half), dt,
                    dyn.wil * eps, (1.0 - dyn.wil) * eps, k26.GRMAX, order)
    return got


@pytest.mark.parametrize("dt", list(DTYPES))
def test_host_sppt_matches_plain(lib, shts, dt):
    rt, ct = DTYPES[dt]
    _, _, g, sht = shts
    rng = np.random.default_rng(21)
    shp = (g.nlev, g.mx, g.nx)
    c = lambda a: torch.as_tensor(a).to(ct).contiguous()
    state = c(rng.normal(size=shp) + 1j * rng.normal(size=shp))
    eta = c(4 * rng.normal(size=shp) + 4j * rng.normal(size=shp))
    sigma = torch.as_tensor(rng.uniform(0, 0.1, (g.mx, g.nx))).to(rt)
    for phi in (0.85, 0.0):
        out = torch.empty_like(state)
        lib.sppt_ar1_host(int(rt == F64), g.nlev, g.mx * g.nx,
                          state.data_ptr(), eta.data_ptr(), sigma.data_ptr(),
                          phi, k24.NOISE_CLIP, out.data_ptr())
        assert torch.equal(out, k24.sppt_plain("ar1", state, eta, sigma,
                                               phi))
    tends = [torch.as_tensor(rng.normal(size=(g.nlev, g.nlat, g.nlon)))
             .to(rt) for _ in range(4)]
    pattern = torch.as_tensor(1.5 * rng.normal(size=tends[0].shape)).to(rt)
    mu = torch.as_tensor(rng.uniform(0.5, 1.0, g.nlev)).to(rt)
    for m in (mu, None):
        ref = k24.sppt_plain("perturb", tends, pattern, m)
        got = [t.clone() for t in tends]
        lib.sppt_perturb_host(int(rt == F64), g.nlev, g.nlat * g.nlon,
                              pattern.data_ptr(),
                              0 if m is None else m.data_ptr(), _ptrs(got))
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("xs", [True, False], ids=["shortwave", "other"])
def test_host_rdf_matches_plain(lib, shts, dt, xs):
    rt, _ = DTYPES[dt]
    jg, _, g, sht = shts
    K = g.nlev
    t = lambda a: torch.as_tensor(a).to(rt).contiguous()
    ttm, tt_rsw, dfabs, psg = map(t, _heating(g, 31))
    heat = k25.RdfHeating(ttm, tt_rsw, dfabs, t(1.0 / psg),
                          t(np.linspace(1e-3, 2e-3, K)),
                          randfor.rdf_weights(jg.full_sigma, g.nlon, rt))
    h = t(randfor.init_randfh(4, g, sht))
    v_in = t(np.random.default_rng(32).normal(0, 1e-5, (2, g.nlat, K)))
    tt = t(np.random.default_rng(33).normal(0, 1e-5, (K, g.nlat, g.nlon)))
    ref_tt, ref_v = k25.rdf_plain(tt, h, v_in, heat if xs else None)
    for order in ORDERS:
        got_tt, got_v = _rdf_host(lib, tt, h, v_in, heat if xs else None,
                                  order)
        assert torch.equal(got_tt, ref_tt)
        if xs:
            assert torch.equal(got_v, ref_v)
    if xs:
        # the zonal sums from the other end differ: the order is held
        rev = k25.RdfHeating(ttm.flip(-1).contiguous(),
                             tt_rsw.flip(-1).contiguous(),
                             dfabs.flip(-1).contiguous(),
                             heat.rps.flip(-1).contiguous(), heat.grdscp,
                             heat.w)
        _, v_rev = k25.rdf_plain(tt, h, v_in, rev)
        assert not torch.equal(v_rev, ref_v)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("j1,eps", [(2, 0.05), (1, 0.0)])
def test_host_cgrate_matches_plain(lib, dycores, dt, j1, eps):
    rt, ct = DTYPES[dt]
    _, tm64 = dycores
    tm = tm64 if rt == F64 else DycoreModel(tm64.geom, dtype=rt,
                                            cgrate_on=True, device="cpu")
    g = tm.geom
    rng = np.random.default_rng(41)
    shp = (2, g.nlev, g.mx, g.nx)
    c = lambda a: torch.as_tensor(a).to(ct).contiguous()
    f = rng.normal(0, 1e-5, shp) + 1j * rng.normal(0, 1e-5, shp)
    state = type("S", (), {})()
    state.vor, state.div = c(f), c(f[::-1].copy())
    # vor grows fast (damped), div slowly (not)
    tend = lambda a, r: c(np.stack([a[0] * r, np.zeros_like(a[0])]))
    out = dataclasses.make_dataclass("O", ["vor", "div"])(
        tend(f, 1e-3), tend(f[::-1], 1e-9))
    ref = k26.cgrate_plain(tm, state, dataclasses.replace(out), j1, 900.0,
                           eps)
    for order in ORDERS:
        got = _cgrate_host(lib, tm, state, out, j1, 900.0, eps, order)
        assert torch.equal(got[0], ref.vor)
        assert torch.equal(got[1], ref.div)
    _, cd = k26.damp_plain(state.vor[0], out.vor[0], tm.sht.elm2)
    assert float(cd) > 0.0
    _, cd = k26.damp_plain(state.div[0], out.div[0], tm.sht.elm2)
    assert float(cd) == 0.0


# ------------------------------------------- K25 and K26 at uneven sizes
# Built directly at T30's widths (no GCM): K26 with K levels that do not
# fill the cluster's 8 blocks (3: five blocks hold none) or overfill it
# (11: three blocks hold two), K25 with latitude rows that do not divide
# into its 8 chunks (46: a last chunk of 4 rows; 20: chunks of 3 rows, the
# cluster's last block with none).


def _t30_dycore(rt, K):
    """A stand-in for a T30 DycoreModel with K levels: what K26's plain
    version and the host build read."""
    mx, nx = 31, 32
    rng = np.random.default_rng(50 + K)
    sht = SimpleNamespace(
        elm2=torch.as_tensor(rng.uniform(0.1, 1.0, (mx, nx))).to(rt),
        trfilt=torch.as_tensor(rng.uniform(0.0, 1.0, (mx, nx))).to(rt))
    geom = SimpleNamespace(nlon=96, nlat_half=24, nlev=K, mx=mx, nx=nx)
    return SimpleNamespace(sht=sht, geom=geom, wil=0.53, m0=0)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("K", [3, 8, 11])
@pytest.mark.parametrize("fires", [True, False], ids=["fires", "free"])
def test_host_cgrate_uneven_levels(lib, dt, K, fires):
    """K26's whole form on the host build, both block orders, bit for bit
    the plain version at K levels, where the trigger fires (vor's
    tendency 1e-3 of the field: every level k >= 1 triggers) and where it
    does not (1e-9, below grmax)."""
    rt, ct = DTYPES[dt]
    dyn = _t30_dycore(rt, K)
    g = dyn.geom
    rng = np.random.default_rng(60 + K)
    shp = (2, K, g.mx, g.nx)
    c = lambda a: torch.as_tensor(a).to(ct).contiguous()
    f = rng.normal(0, 1e-5, shp) + 1j * rng.normal(0, 1e-5, shp)
    state = type("S", (), {})()
    state.vor, state.div = c(f), c(f[::-1].copy())
    r = 1e-3 if fires else 1e-9
    tend = lambda a, s: c(np.stack([a[0] * s, rng.normal(0, 1e-9, a[0].shape)
                                    + 0j]))
    out = dataclasses.make_dataclass("O", ["vor", "div"])(
        tend(f, r), tend(f[::-1], 1e-9))
    ref = k26.cgrate_plain(dyn, state, dataclasses.replace(out), 2, 900.0,
                           0.05)
    for order in ORDERS:
        got = _cgrate_host(lib, dyn, state, out, 2, 900.0, 0.05, order)
        assert torch.equal(got[0], ref.vor)
        assert torch.equal(got[1], ref.div)
    _, cd = k26.damp_plain(state.vor[0], out.vor[0], dyn.sht.elm2)
    assert (float(cd) > 0.0) == fires
    _, cd = k26.damp_plain(state.div[0], out.div[0], dyn.sht.elm2)
    assert float(cd) == 0.0


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("nlat", [20, 46, 48])
@pytest.mark.parametrize("xs", [True, False], ids=["shortwave", "other"])
def test_host_rdf_uneven_rows(lib, dt, nlat, xs):
    """K25's whole forms on the host build, both block orders, bit for bit
    the plain version on nlat latitude rows (K = 5, nlon = 96)."""
    rt, _ = DTYPES[dt]
    K, nlon = 5, 96
    rng = np.random.default_rng(70 + nlat)
    t = lambda a: torch.as_tensor(a).to(rt).contiguous()
    sh = (K, nlat, nlon)
    heat = k25.RdfHeating(t(rng.normal(0, 1e-5, sh)),
                          t(rng.normal(0, 1e-5, sh)),
                          t(rng.normal(0, 1.0, sh)),
                          t(1.0 / rng.uniform(0.6, 1.0, sh[1:])),
                          t(np.linspace(1e-3, 2e-3, K)),
                          t(rng.uniform(0.5, 1.5, (2, K)) / nlon))
    h = t(rng.normal(0, 1.0, (2, nlat, nlon)))
    v_in = t(rng.normal(0, 1e-5, (2, nlat, K)))
    tt = t(rng.normal(0, 1e-5, sh))
    ref_tt, ref_v = k25.rdf_plain(tt, h, v_in, heat if xs else None)
    for order in ORDERS:
        got_tt, got_v = _rdf_host(lib, tt, h, v_in, heat if xs else None,
                                  order)
        assert torch.equal(got_tt, ref_tt)
        if xs:
            assert torch.equal(got_v, ref_v)

"""The arithmetic of K15 (kernels/spectral_stack.py) and of the window's
flux sums (kernels/flux_accumulate.py, a phase of K12_pbl_flux) without a
card, and their wiring.

kernels/csrc/stack_host.cpp compiles the headers the CUDA kernels include
(spectral_stack.cuh, flux_accumulate.cuh) for the host with g++
-ffp-contract=off: K15's warps (one per row (m, level k), lane n on
coefficient n) with their lanes written out as loops in phase order, the
exchange of the n +- 1 neighbours as copies and each lane's registers
starting as NaN, and the flux sums' loop over the grid points (K16's
first design).  On spectral
states made from a seed with numpy (red noise in the total wavenumber,
real at m = 0, the two leapfrog levels different, every coefficient of
the (mx, nx) arrays set):
  - at K = 5, 7 and 8, T10 and T30, (jd, jp) = (1, 0) and (0, 0), the
    lanes write both stacks equal to the plain versions bit for bit, in
    float32 and float64; each stack alone likewise, the other untouched;
  - the flux sums' body equals flux_accumulate_plain bit for bit in both
    dtypes;
  - in float64 the lanes agree with the JAX package's uvspec, grad,
    geopotential and the two stacks it builds (1e-12 of each field's
    scale), at K = 5, 7 and 8, both pairs of levels and each stack alone;
  - uvspec's n-1 and n+1 neighbours swapped, and the m = 0 geopotential
    correction left out, both fail the comparison (negative controls);
  - a dycore step makes one K15 call at (j2-1, 0) (the dry core at
    (j2-1, None)) and hands the physics stack to the physics, and a GCM
    leapfrog step's physics one K12_pbl_flux call (stepone's two physics
    steps K12 without the sums).
The launch code itself runs only on a card (chip_smoke.py).
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.dycore.model import DycoreModel as JDycore
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.dycore import model as dycore_model
from speedy_ml_tpu_torch.dycore.model import DycoreModel
from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch import gcm as gcm_module
from speedy_ml_tpu_torch.gcm import GCM, FluxAccumulator
from speedy_ml_tpu_torch.kernels import column_pbl as cpbl
from speedy_ml_tpu_torch.kernels.flux_accumulate import flux_accumulate_plain
from speedy_ml_tpu_torch.physics import driver as phys_driver
from speedy_ml_tpu_torch.kernels.spectral_stack import (spectral_stack,
                                                        stack_blob)
from speedy_ml_tpu_torch.physics.boundaries import synthetic_boundary_data
from torch_lane import one_thread_per_pool  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
GEOMS = {"T30": dict(trunc=30, nlon=96, nlat=48),
         "T10": dict(trunc=10, nlon=32, nlat=16)}
LEVELS = [(1, 0), (0, 0)]
RTOL_F64 = 1e-12
FAULTS = {"uvspec_shifts_swapped": 1, "geopotential_correction_dropped": 2}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/stack_host.cpp built with g++ and loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' arithmetic for the host")
    so = tmp_path_factory.mktemp("stack_host") / "libstack_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    str(CSRC / "stack_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    ptrs = ctypes.POINTER(vp)
    lib.stack_lanes_host.argtypes = [i] * 4 + [vp] * 7 + [i, i, vp, vp, i]
    lib.flux_host.argtypes = [i, ctypes.c_longlong, ptrs, ptrs, ptrs, d, d]
    lib.stack_lanes_host.restype = lib.flux_host.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def dycore(geom: str, K: int, dtype) -> DycoreModel:
    return DycoreModel(Geometry(nlev=K, **GEOMS[geom]), dtype=dtype,
                       device="cpu")


def red_state(seed, g, dtype):
    """(SpectralState, phis) of red noise: amplitude 1/(1 + l) in the
    total wavenumber l = m + n (every coefficient set, the rows beyond
    the truncation too), real at m = 0, the two levels drawn apart,
    at plausible magnitudes of each variable."""
    rng = np.random.default_rng(seed)
    cd = torch.complex128 if dtype == torch.float64 else torch.complex64
    red = 1.0 / (1.0 + np.add.outer(np.arange(g.mx), np.arange(g.nx)))

    def noise(scale, *lead):
        z = (rng.normal(size=(*lead, g.mx, g.nx))
             + 1j * rng.normal(size=(*lead, g.mx, g.nx))) * red
        z[..., 0, :] = z[..., 0, :].real
        return torch.as_tensor(scale * z).to(cd).contiguous()

    K = g.nlev
    state = SpectralState(vor=noise(2e-5, 2, K), div=noise(5e-6, 2, K),
                          t=noise(3.0, 2, K), ps=noise(1e-2, 2),
                          tr=noise(1.0, 2, 1, K))
    return state, noise(1e3)


def _ptr(t):
    if t is None:
        return None
    assert t.is_contiguous() and t.device.type == "cpu"
    return t.data_ptr()


def run_host(lib, dyn, state, phis, jd, jp, fault=0):
    """K15's warps built for the host: (dynamics stack or None, physics
    stack or None); every output starts as NaN."""
    g = dyn.geom
    K, mx, nx = g.nlev, g.mx, g.nx
    real = state.vor.real.dtype
    blob = stack_blob(dyn, real)
    if dyn.stack_blob is not None:
        assert torch.equal(blob, dyn.stack_blob)
    nan = complex("nan+nanj")
    cd = state.vor.dtype
    od = None if jd is None else torch.full((6 * K + 2, mx, nx), nan,
                                            dtype=cd)
    op = None if jp is None else torch.full((5 * K + 1, mx, nx), nan,
                                            dtype=cd)
    rc = lib.stack_lanes_host(
        K, int(real == torch.float64), mx, nx,
        *(_ptr(getattr(state, k)) for k in ("vor", "div", "t", "ps", "tr")),
        _ptr(phis), _ptr(blob), jd or 0, jp or 0, _ptr(od), _ptr(op), fault)
    assert rc == 0
    return od, op


def field_err(got, ref):
    """max over the fields of |got - ref| / the field's scale."""
    g, r = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    scale = r.abs().amax(dim=1).clamp(min=1e-300)
    return float(((g - r).abs().amax(dim=1) / scale).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("jd,jp", LEVELS, ids=["jd1_jp0", "jd0_jp0"])
@pytest.mark.parametrize("geom", ["T10", "T30"])
@pytest.mark.parametrize("K", [5, 7, 8])
def test_blocks_match_plain(lib, K, geom, jd, jp, dtype):
    dyn = dycore(geom, K, dtype)
    state, phis = red_state(100 + K, dyn.geom, dtype)
    got = run_host(lib, dyn, state, phis, jd, jp)
    ref = spectral_stack(dyn, state, phis, jd, jp)
    for g_, r_ in zip(got, ref):
        assert g_.shape == r_.shape
        assert torch.equal(g_, r_), field_err(g_, r_)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("which", ["dynamics", "physics"])
def test_one_stack_alone(lib, which, dtype):
    dyn = dycore("T30", 8, dtype)
    state, phis = red_state(7, dyn.geom, dtype)
    jd, jp = (1, None) if which == "dynamics" else (None, 1)
    got = run_host(lib, dyn, state, phis, jd, jp)
    ref = spectral_stack(dyn, state, phis, jd, jp)
    for g_, r_ in zip(got, ref):
        assert (g_ is None) == (r_ is None)
        if r_ is not None:
            assert torch.equal(g_, r_)


def hold_against_jax(lib, geom, K, jd, jp, seed):
    """The float64 lanes against the JAX package's operators and the
    stacks it builds from them (grid_tendencies' order for the dynamics,
    the port's order [t, q, phi, ps | u, v] for the physics), at levels
    jd and jp (None: that stack left out), on red_state(seed)."""
    dyn = dycore(geom, K, torch.float64)
    jdy = JDycore(JGeometry(nlev=K, **GEOMS[geom]), dtype=jnp.float64,
                  zonal="dft")
    state, phis = red_state(seed, dyn.geom, torch.float64)
    got_d, got_p = run_host(lib, dyn, state, phis, jd, jp)
    assert (got_d is None) == (jd is None) and (got_p is None) == (jp is None)
    js = {k: jnp.asarray(getattr(state, k).numpy())
          for k in SpectralState.FIELDS}
    jsht = jdy.sht
    mx, nx = dyn.geom.mx, dyn.geom.nx
    pieces = {}
    if jd is not None:
        u1, v1 = jsht.uvspec(js["vor"][jd], js["div"][jd])
        px, py = jsht.grad(js["ps"][jd])
        ref_d = jnp.concatenate([js["vor"][jd], js["div"][jd], js["t"][jd],
                                 js["tr"][jd].reshape(K, mx, nx), u1, v1,
                                 px[None], py[None]])
        pieces.update({"uvspec u": (got_d[4 * K:5 * K], u1),
                       "uvspec v": (got_d[5 * K:6 * K], v1),
                       "grad": (got_d[6 * K:], jnp.stack([px, py])),
                       "dynamics stack": (got_d, ref_d)})
    if jp is not None:
        u0, v0 = jsht.uvspec(js["vor"][jp], js["div"][jp])
        phi = jdy.geopotential(js["t"][jp], jnp.asarray(phis.numpy()))
        ref_p = jnp.concatenate([js["t"][jp], js["tr"][jp, 0], phi,
                                 js["ps"][jp][None], u0, v0])
        pieces.update({"geopotential": (got_p[2 * K:3 * K], phi),
                       "physics stack": (got_p, ref_p)})
    for name, (got, ref) in pieces.items():
        err = field_err(got, torch.as_tensor(np.array(ref)))
        assert err <= RTOL_F64, (name, err)


@pytest.mark.parametrize("geom", ["T10", "T30"])
def test_blocks_match_jax(lib, geom):
    hold_against_jax(lib, geom, 8, 1, 0, 11)


@pytest.mark.parametrize("jd,jp", LEVELS + [(1, None), (None, 0)],
                         ids=["jd1_jp0", "jd0_jp0", "dynamics", "physics"])
@pytest.mark.parametrize("K", [5, 7, 8])
def test_lanes_match_jax_at_each_level_count(lib, K, jd, jp):
    """The lanes at every K the kernel is compiled for, at the levels of a
    leapfrog step, of stepone's first step, and each stack alone (the dry
    core's, the window exit's), against the JAX package at T10 (nx = 12:
    lanes 12-31 of each warp masked)."""
    hold_against_jax(lib, "T10", K, jd, jp, 11 + K)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_fail_the_comparison(lib, fault):
    dyn = dycore("T10", 8, torch.float32)
    state, phis = red_state(3, dyn.geom, torch.float32)
    good = run_host(lib, dyn, state, phis, 1, 0)
    bad = run_host(lib, dyn, state, phis, 1, 0, FAULTS[fault])
    ref = spectral_stack(dyn, state, phis, 1, 0)
    assert all(torch.equal(g_, r_) for g_, r_ in zip(good, ref))
    err = max(field_err(b, r) for b, r in zip(bad, ref))
    assert err > 1e-3, err


def flux_case(seed, geom, dtype):
    """A FluxAccumulator and the step's diagnostics of plausible
    magnitudes, from the seed."""
    g = GEOMS[geom]
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: torch.as_tensor(
        rng.uniform(lo, hi, (g["nlat"], g["nlon"]))).to(dtype)
    fx = FluxAccumulator(hflux_l=f(-50, 150), hflux_s=f(-50, 300),
                         hflux_i=f(-20, 80), precip=f(0, 4e3))
    diag = SimpleNamespace(hflux_l=f(-100, 400), hflux_s=f(-100, 600),
                           hflux_i=f(-50, 200), precnv=f(0, 1e-1),
                           precls=f(0, 5e-2))
    return fx, diag


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("geom", ["T10", "T30"])
def test_flux_body_matches_plain(lib, geom, dtype):
    fx, diag = flux_case(21, geom, dtype)
    rsteps, delt2 = 1.0 / 96, 1800.0
    ref = flux_accumulate_plain(fx, diag, rsteps, delt2)
    arr = lambda ts: (ctypes.c_void_p * len(ts))(*[_ptr(t) for t in ts])
    acc = [fx.hflux_l, fx.hflux_s, fx.hflux_i, fx.precip]
    dg = [diag.hflux_l, diag.hflux_s, diag.hflux_i, diag.precnv,
          diag.precls]
    out = [torch.full_like(a, float("nan")) for a in acc]
    assert lib.flux_host(int(dtype == torch.float64), acc[0].numel(),
                         arr(acc), arr(dg), arr(out), rsteps, delt2) == 0
    for o, nm in zip(out, ("hflux_l", "hflux_s", "hflux_i", "precip")):
        assert torch.equal(o, getattr(ref, nm)), nm
    # the accumulator given is left as it is
    again = flux_accumulate_plain(fx, diag, rsteps, delt2)
    assert all(torch.equal(getattr(again, k), getattr(ref, k))
               for k in ("hflux_l", "hflux_s", "hflux_i", "precip"))


def test_wrappers_raise_off_cpu_and_cuda():
    dyn = dycore("T10", 8, torch.float32)
    state, phis = red_state(1, dyn.geom, torch.float32)
    meta = state.map(lambda t: t.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        spectral_stack(dyn, meta, phis.to("meta"), 1, 0)
    with pytest.raises(ValueError, match="at least one"):
        spectral_stack(dyn, state, phis, None, None)
    with pytest.raises(ValueError, match="no kernel"):
        spectral_stack(dyn, meta, phis.to("meta"), 1, None)


def test_step_and_leapfrog_call_k15_and_k16(monkeypatch):
    """One K15 call a step at (j2-1, 0) with physics, its physics stack
    handed to the physics (which then makes no K15 call of its own); the
    dry core's at (j2-1, None); a leapfrog step's physics makes one
    K12_pbl_flux call, which forms the flux sums (K16's work, no launch
    of its own), and stepone's two physics steps K12 without them; the
    sums equal those of the plain steps."""
    g = Geometry(nlev=8, **GEOMS["T10"])
    gcm = GCM(g, dtype=torch.float64, nsteps_day=36,
              bd=synthetic_boundary_data(g, dtype=torch.float64),
              device="cpu")
    calls, pbl = [], []

    def stack(dyn, state, phis, jd, jp):
        calls.append((jd, jp))
        return spectral_stack(dyn, state, phis, jd, jp)

    def counted(name, fn):
        def run(*a):
            pbl.append((name, a[9] if name == "K12_pbl_flux" else None))
            return fn(*a)
        return run

    monkeypatch.setattr(dycore_model, "spectral_stack", stack)
    monkeypatch.setattr(gcm_module, "spectral_stack", stack)
    monkeypatch.setattr(phys_driver, "column_pbl",
                        counted("K12", cpbl.column_pbl))
    monkeypatch.setattr(phys_driver, "pbl_flux",
                        counted("K12_pbl_flux", cpbl.pbl_flux))
    from speedy_ml_tpu_torch.data.calendar import ModelDate
    st, fo = gcm.init_state(ModelDate(1990, 7, 1))
    st = gcm.stepone(st, fo)
    assert calls == [(0, 0), (1, 0)]
    assert [nm for nm, _ in pbl] == ["K12", "K12"]
    acc = [st.fluxes]
    for _ in range(2):
        st = gcm.leapfrog(st, fo)
        acc.append(st.fluxes)
    assert calls[2:] == [(1, 0), (1, 0)]
    assert [nm for nm, _ in pbl[2:]] == ["K12_pbl_flux"] * 2
    # each step's sums start from the accumulator the step before left
    assert pbl[2][1] is acc[0] and pbl[3][1] is acc[1]
    assert np.isfinite(st.fluxes.precip.numpy()).all()
    assert float(st.fluxes.precip.max()) > 0
    calls.clear()
    dyn = gcm.dyn
    dyn.leapfrog_step(st.spectral, gcm.phis)
    assert calls == [(1, None)]

"""Port parity of the slab coupler (A10a): physics/land_sea.py, K21
(kernels/slab_couple.py), GCM.run_days and the persistent coupled
surface of the hybrid cycle, on the CPU at T10.

Against the JAX package in float64, on inputs made from a seed with
numpy:
  - sea_domain_mask for every domain and build_slab_coeffs with regional
    domains: equal (the same numpy code);
  - couple_daily for each flag branch that tests/test_sea_coupling.py
    covers (icsea 0-4, isstan, icland 0, icice 0, a regional domain),
    on the synthetic aquaplanet and on a mixed land mask with sea ice,
    from a perturbed surface: every field within 1e-12 of its scale;
  - sstan_for_window: equal;
  - GCM.run_days for one day at nsteps_day = 36 with CplFlags(icsea=2,
    isstan=1) and a seeded anomaly series: within 1e-9;
  - two persistent coupled cycles (persist_surface) from step 2, so
    that they cover the first cycle's climatology, one accumulation and
    a coupling with its reset, sfc and fluxes included: within 1e-9; and
    the same with the gate tripped (safe false), where the JAX cycle
    skips the window and the port selects the window's sums away (C4):
    within 1e-9 and finite.
kernels/csrc/glue_host.cpp compiles slab_couple.cuh, the header K21
includes, for the host with g++ -ffp-contract=off; the test holds it bit
for bit against the plain version in float32 and float64, in all three
forms (accumulate, couple with each icsea mode, the day form with three
anomaly planes), with a tripped gate over window sums that hold NaN.
The launch code runs only on a card (chip_smoke.py phase 12).
"""

import ctypes
import dataclasses
import functools
import shutil
import subprocess
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.data.calendar import ModelDate as JModelDate
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.hybrid.build import build_untrained_hybrid as jbuild
from speedy_ml_tpu.physics import land_sea as jls
from speedy_ml_tpu.physics.boundaries import BoundaryData as JBoundaryData
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu_torch.convert import boundary_from_numpy, params_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
from speedy_ml_tpu_torch.kernels import slab_couple as k21
from speedy_ml_tpu_torch.kernels import surface_forcing as sfk
from speedy_ml_tpu_torch.physics import land_sea
from torch_lane import one_thread_per_pool  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
RTOL_COUPLE = 1e-12
RTOL_RUN = 1e-9
IMON, FMON = 5, 0.4
DOMAINS = ("globe", "northe", "natlan", "npacif", "tropic", "indian",
           "elnino")
# (flags, with the observed anomaly, with sstom12), after
# tests/test_sea_coupling.py
CASES = {
    "default": (jls.CplFlags(), False, False),
    "isstan": (jls.CplFlags(isstan=1), True, False),
    "icsea1_isstan": (jls.CplFlags(icsea=1, isstan=1), True, False),
    "icsea2": (jls.CplFlags(icsea=2), False, False),
    "icsea3": (jls.CplFlags(icsea=3), False, False),
    "icsea3_sstom12": (jls.CplFlags(icsea=3), False, True),
    "icsea4": (jls.CplFlags(icsea=4), True, False),
    "icsea4_sstom12": (jls.CplFlags(icsea=4, isstan=1), True, True),
    "icland0": (jls.CplFlags(icland=0), False, False),
    "icice0": (jls.CplFlags(icice=0), False, False),
    "no_sea_model": (jls.CplFlags(icsea=0, icice=0), False, False),
    "regional": (jls.CplFlags(icsea=2, sea_domains=("natlan", "tropic")),
                 False, False),
}


def port_flags(f):
    return land_sea.CplFlags(**dataclasses.asdict(f))


def lat_deg():
    return np.rad2deg(JGeometry(**GEOM).lat_radians)


@functools.lru_cache(maxsize=None)
def bd_fields(kind):
    """BoundaryData fields (numpy, float64): the synthetic aquaplanet;
    "continents", the aquaplanet with smooth continents (a fractional
    coast) on which the GCM runs; or "mixed", a seeded land mask (some
    points below the 1/3 thresholds) with sea ice on both sides of 0.5
    and SST on both sides of freezing."""
    g = JGeometry(**GEOM)
    if kind == "aquaplanet":
        jbd = jsynthetic(g, JST(g, dtype=jnp.float64))
        return {k: np.asarray(getattr(jbd, k))
                for k in jbd.__dataclass_fields__}
    if kind == "continents":
        f = dict(bd_fields("aquaplanet"))
        lat = g.lat_radians[:, None]
        lon = np.arange(g.nlon)[None, :] * 2 * np.pi / g.nlon
        fmask = np.clip(0.5 + np.cos(2 * lon) * np.cos(lat)
                        + 0.4 * np.sin(lon + 3 * lat), 0.0, 1.0)
        f.update(fmask=fmask, fmask_l=fmask, fmask_s=1.0 - fmask,
                 bmask_l=(fmask > 0.5).astype(float),
                 bmask_s=(fmask <= 0.5).astype(float))
        return f
    rng = np.random.default_rng(21)
    grid = (g.nlat, g.nlon)
    u = lambda lo, hi, *lead: rng.uniform(lo, hi, lead + grid)
    fmask = np.where(u(0, 1) < 0.4, 0.0, u(0, 1))
    sice12 = np.where(u(0, 1, 12) < 0.5, 0.0, u(0, 1, 12))
    phis0 = 2.0e4 * fmask * u(0, 1)
    return dict(orog=phis0, phis0=phis0, fmask=fmask, fmask_l=fmask,
                bmask_l=(fmask > 0.5).astype(float), fmask_s=1.0 - fmask,
                bmask_s=(fmask <= 0.5).astype(float), alb0=u(0.1, 0.6),
                stl12=u(250.0, 310.0, 12), snowd12=u(0.0, 100.0, 12),
                soilw12=u(0.0, 1.0, 12), sst12=u(268.0, 305.0, 12),
                sice12=sice12, forog=1.0 + u(0, 0.5))


@functools.lru_cache(maxsize=None)
def jbd(kind):
    return JBoundaryData(**{k: jnp.asarray(v)
                            for k, v in bd_fields(kind).items()})


@functools.lru_cache(maxsize=None)
def tbd(kind, dtype=torch.float64):
    return boundary_from_numpy(types.SimpleNamespace(**bd_fields(kind)),
                               device="cpu", dtype=dtype)


def seeded_inputs(seed=3):
    """(a perturbation of the surface's slab fields, the day's fluxes,
    an observed anomaly, three anomaly planes, an ocean-model
    climatology): numpy, float64."""
    rng = np.random.default_rng(seed)
    shape = (GEOM["nlat"], GEOM["nlon"])
    pert = {k: rng.normal(0, 2.0, shape)
            for k in ("stl_lm", "sst_om", "tice_om")}
    fx = {k: rng.normal(0, 30.0, shape)
          for k in ("hflux_l", "hflux_s", "hflux_i", "precip")}
    return (pert, fx, rng.normal(0, 1.5, shape),
            rng.normal(0, 1.5, (3,) + shape),
            bd_fields("mixed")["sst12"] + rng.normal(0, 0.5, (12,) + shape))


def jax_carry(kind):
    pert = seeded_inputs()[0]
    s = jls.init_surface_state(jbd(kind), jnp.asarray(IMON),
                               jnp.asarray(FMON), flags=jls.CplFlags(icsea=2))
    return dataclasses.replace(
        s, **{k: getattr(s, k) + jnp.asarray(v) for k, v in pert.items()})


def port_carry(kind, dtype=torch.float64):
    js = jax_carry(kind)
    return land_sea.SurfaceState(**{
        k: torch.as_tensor(np.array(getattr(js, k))).to(dtype)
        for k in js.__dataclass_fields__})


def field_err(got, ref):
    """|got - ref| max over |ref| max (the field's scale)."""
    ref = np.asarray(ref)
    got = got.detach().numpy()
    scale = max(np.abs(ref).max(), 1e-300)
    return np.abs(got - ref).max() / scale


# ------------------------------------------------------------ host numpy

@pytest.mark.parametrize("name", DOMAINS)
def test_sea_domain_mask_matches_jax(name):
    ref = jls.sea_domain_mask(name, lat_deg(), GEOM["nlon"])
    got = land_sea.sea_domain_mask(name, lat_deg(), GEOM["nlon"])
    np.testing.assert_array_equal(got, ref)
    if name != "globe":
        assert 0 < np.count_nonzero(got) < got.size
    with pytest.raises(ValueError, match="unknown sea domain"):
        land_sea.sea_domain_mask("atlantis", lat_deg(), GEOM["nlon"])


@pytest.mark.parametrize("kind", ["aquaplanet", "mixed"])
@pytest.mark.parametrize("domains", [("globe",), ("natlan",),
                                     ("npacif", "tropic"),
                                     ("northe", "indian", "elnino")],
                         ids=lambda d: "+".join(d))
def test_build_slab_coeffs_matches_jax(domains, kind):
    ref = jls.build_slab_coeffs(jbd(kind), lat_deg(), jnp.float64,
                                sea_domains=domains)
    got = land_sea.build_slab_coeffs(tbd(kind), lat_deg(), torch.float64,
                                     sea_domains=domains)
    assert got._fields == ref._fields
    for k in ref._fields:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)
    assert got.cdsea.device.type == "cpu"
    if domains != ("globe",):
        assert float(got.cdsea.min()) == 0.0 < float(got.cdsea.max())


@pytest.mark.parametrize("fmon", [0.1, 0.5, 0.9])
def test_sstan_for_window_matches_jax(fmon):
    planes = seeded_inputs()[3]
    ref = jls.sstan_for_window(jnp.asarray(planes), jnp.asarray(fmon))
    got = land_sea.sstan_for_window(torch.as_tensor(planes), fmon)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------ couple_daily

@pytest.mark.parametrize("kind", ["aquaplanet", "mixed"])
@pytest.mark.parametrize("case", list(CASES))
def test_couple_daily_matches_jax(case, kind):
    flags, with_an, with_om = CASES[case]
    _, fx, an, _, om12 = seeded_inputs()
    jcoef = jls.build_slab_coeffs(jbd(kind), lat_deg(), jnp.float64,
                                  sea_domains=flags.sea_domains)
    wsst = jls.sea_domain_mask("elnino", lat_deg(), GEOM["nlon"]) \
        if flags.icsea >= 4 else None
    jfx = {k: jnp.asarray(v) for k, v in fx.items()}
    ref = jls.couple_daily(
        jax_carry(kind), jcoef, jbd(kind), jfx, jnp.asarray(IMON),
        jnp.asarray(FMON), flags=flags,
        sstan_ob=jnp.asarray(an) if with_an else None,
        wsst_ob=None if wsst is None else jnp.asarray(wsst),
        sstom12=jnp.asarray(om12) if with_om else None)
    tcoef = land_sea.build_slab_coeffs(tbd(kind), lat_deg(), torch.float64,
                                       sea_domains=flags.sea_domains)
    t = torch.as_tensor
    got = land_sea.couple_daily(
        port_carry(kind), tcoef, tbd(kind),
        {k: t(v) for k, v in fx.items()}, IMON, FMON, flags=port_flags(flags),
        sstan_ob=t(an) if with_an else None,
        wsst_ob=None if wsst is None else t(wsst),
        sstom12=t(om12) if with_om else None)
    for k in ref.__dataclass_fields__:
        err = field_err(getattr(got, k), getattr(ref, k))
        assert err <= RTOL_COUPLE, (k, err)
    # the models moved the surface off the climatology where they run
    cl = land_sea.interp_climatology(tbd(kind), IMON, FMON)
    if flags.icsea == 2:
        assert float((got.sst_om - cl["sstcl"]).abs().max()) > 1e-3


# ------------------------------------------------------- K21's host build

@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/glue_host.cpp built with g++ and loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' arithmetic for the host")
    so = tmp_path_factory.mktemp("glue_host") / "libglue_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    str(CSRC / "glue_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
    lib.slab_couple_host.argtypes = [
        ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(vp), vp, vp,
        ctypes.POINTER(ctypes.c_double), ip, ctypes.c_double, ip]
    return lib


def _ptr(t):
    if t is None:
        return None
    assert t.is_contiguous() and t.device.type == "cpu"
    return t.data_ptr()


def host_k21(lib, bd, coef, carry, acc, month, flags, **kw):
    """K21 built for the host, with the wrapper's operands and options
    (slab_couple.operands); every output starts as NaN."""
    grid = tuple(bd.sst12.shape[-2:])
    dt = bd.sst12.dtype
    ins, opts, w_an = k21.operands(bd, coef, carry, acc, flags, **kw)
    scal, ix = sfk._scalars(month, 0.0, None, 0.0, 0.0)
    nan = lambda n: torch.full((n,) + grid, float("nan"), dtype=dt)
    sfc = nan(len(k21.SURFACE_FIELDS)) if kw.get("do_couple", True) \
        else None
    fx = nan(len(k21.FLUX_FIELDS)) if kw.get("window") is not None else None
    ptrs = (ctypes.c_void_p * len(k21.INPUTS))(
        *[_ptr(ins[k]) for k in k21.INPUTS])
    op = (ctypes.c_int * len(k21.OPTIONS))(*[opts[k] for k in k21.OPTIONS])
    assert lib.slab_couple_host(int(dt == torch.float64), grid[0] * grid[1],
                                ptrs, _ptr(sfc), _ptr(fx), scal, ix,
                                float(w_an), op) == 0
    return sfc, fx


def k21_operands(dtype, flags, gate_ok=True):
    """The mixed land mask's operands in `dtype`: (bd, coef, carry, acc,
    window, ok, the observed anomaly, three anomaly planes, sstom12, the
    elnino weights).  With gate_ok false, the window's sums hold NaN and
    ok is false."""
    _, fx, an, planes, om12 = seeded_inputs()
    t = lambda a: torch.as_tensor(a).to(dtype).contiguous()
    bd = tbd("mixed", dtype)
    coef = land_sea.build_slab_coeffs(bd, lat_deg(), dtype,
                                      sea_domains=flags.sea_domains)
    carry = port_carry("mixed", dtype)
    acc = [t(fx[k]) for k in k21.FLUX_FIELDS]
    rng = np.random.default_rng(8)
    window = [t(rng.normal(0, 5.0, acc[0].shape)) for _ in acc]
    if not gate_ok:
        for w in window:
            w[3, 4] = float("nan")
    ok = torch.tensor(gate_ok)
    wsst = t(land_sea.sea_domain_mask("elnino", lat_deg(), GEOM["nlon"]))
    return (bd, coef, carry, acc, window, ok, t(an),
            [t(p) for p in planes], t(om12), wsst)


FORMS = ["accumulate", "accumulate_gate", "couple_icsea0_isstan",
         "couple_icsea2", "couple_icsea3_sstom12", "couple_icsea4",
         "couple_gate", "day_fmon0.25", "day_fmon0.75"]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("form", FORMS)
def test_slab_couple_host_matches_plain(lib, form, dtype):
    """K21's host build against its plain version, bit for bit (the same
    four operations in the same order): the cycle's accumulate and
    couple forms, with the gate passed and tripped over window sums that
    hold NaN, each icsea mode with isstan 1, and the day form with three
    anomaly planes on both sides of mid-month."""
    icsea = {"couple_icsea2": 2, "couple_icsea3_sstom12": 3,
             "couple_icsea4": 4}.get(form, 0)
    flags = land_sea.CplFlags(icsea=icsea, isstan=1)
    gate_ok = not form.endswith("gate")
    (bd, coef, carry, acc, window, ok, an, planes, om12,
     wsst) = k21_operands(dtype, flags, gate_ok)
    month = (IMON, FMON)
    kw = dict(wsst=wsst, sstom12=om12 if "sstom12" in form else None)
    if form.startswith("day"):
        fmon = float(form.split("fmon")[1])
        month = (IMON, fmon)
        kw.update(sstan=(planes, fmon))
    else:
        kw.update(window=window, ok=ok,
                  do_couple=form.startswith("couple"), sstan=an)
    ref = k21.slab_couple(bd, coef, carry, acc, month, flags, **kw)
    got = host_k21(lib, bd, coef, carry, acc, month, flags, **kw)
    for g_, r_ in zip(got, ref):
        assert (g_ is None) == (r_ is None)
        if r_ is not None:
            assert bool(torch.isfinite(r_).all())
            assert torch.equal(g_, r_)
    sfc, fx = ref
    if form.startswith("accumulate"):
        assert sfc is None
        want = [a + w for a, w in zip(acc, window)] if gate_ok else acc
        for k, w in enumerate(want):
            assert torch.equal(fx[k], w)
    elif form.startswith("couple"):
        assert float(fx.abs().max()) == 0.0
        # the sums that reach the coupler are acc alone when the gate
        # tripped
        f = acc if not gate_ok else [a + w for a, w in zip(acc, window)]
        direct = land_sea.couple_daily(
            carry, coef, bd, dict(zip(("hflux_l", "hflux_s", "hflux_i"),
                                      f)), *month, flags=flags, sstan_ob=an,
            wsst_ob=wsst, sstom12=kw["sstom12"])
        assert torch.equal(sfc, torch.stack(
            [getattr(direct, k) for k in k21.SURFACE_FIELDS]))
    else:
        assert fx is None
        an_day = land_sea.sstan_for_window(torch.stack(planes), month[1])
        cl = land_sea.interp_climatology(bd, *month)
        sst_am = cl["sstcl"] + an_day
        sice = cl["sicecl"]
        sst_am = sst_am + sice * (sfc[k21.SURFACE_FIELDS.index("tice_am")]
                                  - sst_am)
        assert torch.equal(sfc[k21.SURFACE_FIELDS.index("sst_am")], sst_am)


def test_slab_couple_host_refuses_operands_that_do_not_fit(lib):
    """The options checked before a launch: no window and no coupling,
    a coupling without the carry."""
    flags = land_sea.CplFlags()
    bd, coef, carry, acc, window, ok, *_ = k21_operands(torch.float64, flags)
    with pytest.raises(ValueError, match="nothing but the coupling"):
        k21.slab_couple(bd, coef, carry, acc, (IMON, FMON), flags,
                        do_couple=False)
    grid = tuple(bd.sst12.shape[-2:])
    ptrs = (ctypes.c_void_p * len(k21.INPUTS))()
    op = (ctypes.c_int * len(k21.OPTIONS))(0, 0, 0, 0, 0, 1, 0)
    out = torch.empty((10,) + grid, dtype=torch.float64)
    scal, ix = sfk._scalars((IMON, FMON), 0.0, None, 0.0, 0.0)
    assert lib.slab_couple_host(1, grid[0] * grid[1], ptrs, _ptr(out), None,
                                scal, ix, 0.0, op) == 1


# ------------------------------------------------ the day loop, the cycle

def test_run_days_with_anomalies_matches_jax():
    """One day of GCM.run_days (stepone first, 36 steps, the coupler at
    the new date) with CplFlags(icsea=2, isstan=1) and a seeded monthly
    anomaly series, as tests/test_sea_coupling.py's end-to-end GCM, with
    smooth continents: the state within 1e-9 of each field's signal,
    the surface and the sums within 1e-9 of their scale."""
    flags = jls.CplFlags(icsea=2, isstan=1)
    sstan = np.random.default_rng(4).normal(0, 1.0, (24, GEOM["nlat"],
                                                     GEOM["nlon"]))
    jg = JGeometry(**GEOM)
    jgcm = JGCM(jg, dtype=jnp.float64, nsteps_day=36, bd=jbd("continents"),
                cpl_flags=flags, sstan_monthly=sstan, sstan_year0=1990)
    tgcm = GCM(Geometry(**GEOM), dtype=torch.float64, nsteps_day=36,
               bd=tbd("continents"), cpl_flags=port_flags(flags),
               sstan_monthly=sstan, sstan_year0=1990, device="cpu")
    jd, td = JModelDate(1990, 6, 30), ModelDate(1990, 6, 30)
    # the anomaly at the date, and the clamp of months beyond the series
    # (the JAX package's is jit-compiled, where XLA may fuse the forint's
    # multiply and add: within 1e-12 of its scale, not equal)
    for d, tdd in ((jd, td), (JModelDate(1992, 3, 1), ModelDate(1992, 3, 1)),
                   (JModelDate(1989, 1, 5), ModelDate(1989, 1, 5))):
        assert field_err(tgcm.sstan_for(tdd), jgcm.sstan_for(d)) \
            <= RTOL_COUPLE
    js, jf = jgcm.init_state(jd)
    ts, tf = tgcm.init_state(td)
    js, jd = jgcm.run_days(jgcm.stepone(js, jf), jd, 1)
    ts, td = tgcm.run_days(tgcm.stepone(ts, tf), td, 1)
    assert (td.year, td.month, td.day) == (jd.year, jd.month, jd.day) \
        == (1990, 7, 1)
    assert ts.istep == int(js.istep) == 36
    for k in ("vor", "div", "t", "ps", "tr"):
        ref = np.asarray(getattr(js.spectral, k))
        got = getattr(ts.spectral, k).numpy()
        r = ref.reshape(-1, *ref.shape[-2:])
        gg = got.reshape(r.shape)
        floor = 1e-3 * np.abs(r).max()
        for a, b in zip(gg, r):
            scale = max(np.abs(b - b.mean()).max(), floor, 1e-300)
            assert np.abs(a - b).max() <= RTOL_RUN * scale, k
    for k in js.sfc.__dataclass_fields__:
        assert field_err(getattr(ts.sfc, k), getattr(js.sfc, k)) \
            <= RTOL_RUN, k
    for k in ("hflux_l", "hflux_s", "hflux_i", "precip"):
        assert field_err(getattr(ts.fluxes, k), getattr(js.fluxes, k)) \
            <= RTOL_RUN, k
    sfc = ts.sfc
    np.testing.assert_allclose(
        sfc.sst_am.numpy(),
        (sfc.sst_om + sfc.sice_am * (sfc.tice_am - sfc.sst_om)).numpy(),
        atol=1e-9)


N_REGIONS, M = 128, 300


@pytest.fixture(scope="module")
def persist_pair():
    """The JAX package's and the port's coupled hybrids (T10, 128 regions,
    m = 300, 2 GCM steps a window, float64) with smooth continents, with
    persist_surface on."""
    jg = JGeometry(**GEOM)
    jgcm = JGCM(jg, dtype=jnp.float64, nsteps_day=8, bd=jbd("continents"))
    jhyb = jbuild(jgcm, n_regions=N_REGIONS, m=M, key=jax.random.PRNGKey(0),
                  ml_only=False, radius_iters=30)
    geom = Geometry(**GEOM)
    tgcm = GCM(geom, dtype=torch.float64, nsteps_day=8,
               bd=tbd("continents"), device="cpu")
    layout = RegionLayout(geom, n_regions=N_REGIONS)
    atmo = jax.tree_util.tree_map(np.asarray, jhyb.params[0])
    packs = params_from_numpy(atmo, layout, ESNHyper(m=M), device="cpu",
                              dtype=torch.float64)
    thyb = HybridAtmosphere(tgcm, layout, packs, ml_only=False, device="cpu")
    jhyb.persist_surface = thyb.persist_surface = True
    return jhyb, thyb


def _close(got, ref, rtol=RTOL_RUN):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    signal = max(np.abs(ref - ref.mean()).max(), 1e-3 * np.abs(ref).max(),
                 1e-300)
    err = np.abs(got - ref).max()
    assert err <= rtol * signal, f"err {err:.3e}, signal {signal:.3e}"


@pytest.mark.parametrize("gate", ["passed", "tripped"])
def test_persistent_cycles_match_jax(persist_pair, gate):
    """Two persistent coupled cycles from step 2 (the first starts the
    surface from the climatology and accumulates, the second couples and
    zeroes the sums), against the JAX package's _cycle_jit; with the gate
    tripped (safe false) the JAX cycle skips the window and hands the
    coupler zeros, the port runs it and selects its sums away (C4)."""
    jhyb, thyb = persist_pair
    sst = np.asarray(jsynthetic(JGeometry(**GEOM), JST(
        JGeometry(**GEOM), dtype=jnp.float64)).sst12[0])
    js = dataclasses.replace(jhyb.init_state(jnp.asarray(sst)),
                             step=jnp.asarray(2, dtype=jnp.int32))
    ts = dataclasses.replace(thyb.init_state(sst), step=2)
    if gate == "tripped":
        js = dataclasses.replace(js, safe=jnp.asarray(False))
        ts = dataclasses.replace(ts, safe=torch.tensor(False))
    assert ts.sfc is None and ts.fluxes is None
    date = ModelDate(1990, 1, 1)
    for step in (2, 3):
        args = (date.month - 1, date.tmonth, date.tyear)
        js, jd = jhyb.cycle(js, jnp.asarray(args[0]), jnp.asarray(args[1]),
                            jnp.asarray(args[2]))
        ts, td = thyb.cycle(ts, *args)
        assert ts.step == step + 1 == int(js.step)
        assert bool(ts.safe) == bool(js.safe) == (gate == "passed")
        for jc, tc in zip(js.classes, ts.classes):
            _close(tc.x, jc.x)
            _close(tc.local_model, jc.local_model)
        _close(td["speedy_atmo"], jd["speedy_atmo"])
        for k in js.sfc.__dataclass_fields__:
            got = getattr(ts.sfc, k)
            assert bool(torch.isfinite(got).all()), k
            assert field_err(got, getattr(js.sfc, k)) <= RTOL_RUN, k
        for k in ("hflux_l", "hflux_s", "hflux_i", "precip"):
            got = getattr(ts.fluxes, k)
            assert bool(torch.isfinite(got).all()), k
            ref = np.asarray(getattr(js.fluxes, k))
            assert np.abs(got.numpy() - ref).max() <= RTOL_RUN * max(
                np.abs(ref).max(), 1.0), k
        if step == 2:
            # accumulated: the window's sums, or with the gate tripped the
            # zeros the first cycle starts from
            nonzero = float(ts.fluxes.hflux_s.abs().max()) > 0
            assert nonzero == (gate == "passed")
        else:
            # coupled: the sums zeroed
            assert float(torch.stack(list(dataclasses.astuple(
                ts.fluxes))).abs().max()) == 0.0
        date = date.advance_hours(6)


def test_persistent_window_takes_the_carried_surface(persist_pair):
    """The window's entry with a carry (K17's carry form): the slab
    models' fields are the carry's, sst_am the climatology's with the
    hybrid SST, and the forcing reads the carried stl_lm."""
    _, thyb = persist_pair
    gcm = thyb.gcm
    carry = port_carry("continents")
    sst = carry.sst_am - 1.0
    sfc, frc = gcm.window_entry(IMON, FMON, 0.4, sst, sfc_carry=carry)
    base, _ = gcm.window_entry(IMON, FMON, 0.4, sst)
    for k in ("stl_lm", "stl_am"):
        assert getattr(sfc, k) is carry.stl_lm
    assert sfc.sst_om is carry.sst_om
    assert sfc.tice_om is carry.tice_om and sfc.tice_am is carry.tice_om
    for k in ("sst_am", "sice_am", "snowd_am", "soilw_am", "sice_om"):
        assert torch.equal(getattr(sfc, k), getattr(base, k)), k
    ref = gcm.forcing_for(dataclasses.replace(base, stl_am=carry.stl_lm),
                          0.4)
    for k in ref.__dataclass_fields__:
        assert torch.equal(getattr(frc, k), getattr(ref, k)), k
    # K17's carry form: the forcing made with the surface reads the
    # carried land temperature; on orography its diffusion corrections
    # move with it, and the surface planes do not
    bd = tbd("mixed")
    day = gcm.phys.day_args(0.4)
    stl = carry.stl_lm + 3.0
    s0, f0 = sfk.surface_forcing(bd, month=(IMON, FMON), day=day)
    s1, f1 = sfk.surface_forcing(bd, month=(IMON, FMON), day=day,
                                 stl_carry=stl)
    surf = dict(zip(sfk.SURFACE, s0))
    ref1 = sfk.forcing_plain(bd, stl, surf["snowd"], surf["sst_am"],
                             surf["sice"], day, GEOM["nlon"])
    assert torch.equal(s1, s0) and torch.equal(f1, ref1)
    assert not torch.equal(f1[1], f0[1])
    with pytest.raises(ValueError, match="carry form"):
        sfk.surface_forcing(bd, month=(IMON, FMON), stl_carry=stl)


def test_persist_surface_off_leaves_the_state(persist_pair):
    """With persist_surface off the cycle carries no surface."""
    _, thyb = persist_pair
    h = HybridAtmosphere(thyb.gcm, thyb.layout, thyb.packs, ml_only=False,
                         device="cpu")
    s, _ = h.cycle(h.init_state(np.full((16, 32), 290.0)), 0, 0.5, 0.05)
    assert s.sfc is None and s.fluxes is None


def test_slab_couple_counts_nothing_on_cpu_and_refuses_other_devices():
    """K21's wrapper: CPU tensors take the plain version and count no
    launch; a device without a kernel raises (no silent plain path)."""
    flags = land_sea.CplFlags()
    bd, coef, carry, acc, window, ok, *_ = k21_operands(torch.float64, flags)
    before = k21.slab_couple.launches
    k21.slab_couple(bd, coef, carry, acc, (IMON, FMON), flags,
                    window=window, ok=ok, do_couple=False)
    assert k21.slab_couple.launches == before
    meta = dataclasses.replace(bd, sst12=torch.empty(bd.sst12.shape,
                                                     device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        k21.slab_couple(meta, coef, carry, acc, (IMON, FMON), flags)

"""The window's entry and exit and the injection's glue: K17 and K17b
(kernels/surface_forcing.py), K18 (kernels/inject_spectral.py, phase 0 of
K6_inject), K19 (kernels/gate_check.py) and K20
(kernels/window_select.py), and K3's date form (kernels/window_gather.py),
without a card.

The plain versions against the JAX package in float64 on the CPU, on
inputs made from a seed with numpy (T30 grids):
  - K17: init_surface_state and daily_forcing on a mixed land mask with
    sea ice, snow and orography, at fmon <= 0.5 and > 0.5, imon 0 and 11
    (the month wrap), without a hybrid SST and with one on both sides of
    the 6 K test; every field within RTOL_F64 of its scale;
  - K17b: HybridAtmosphere.tisr_field;
  - K18 and K6_inject (inject_synthesis): vdspec, trunct and uv_grid of
    inject_to_speedy, the injected state and the gate.
kernels/csrc/glue_host.cpp compiles the headers the CUDA kernels include
(surface_forcing.cuh, inject_spectral.cuh, gate_check.cuh,
window_select.cuh, window_gather.cuh) for the host with g++
-ffp-contract=off, and the test holds them against the plain versions:
K18's first-design blocks (shared memory starting as NaN), K19 and K20
bit for bit in float32 and float64; K3's date form bit for bit against
K17b's host plane gathered (float32); K17 and
K17b in float64 within RTOL_F64, in float32 within K17_ULPS of each
plane's scale (the host's cosf, sinf, acosf, expf and powf are glibc's,
the CPU plain version's over whole rows are PyTorch's vectorized ones,
which differ in the last bit; on the card both sides call the same CUDA
functions).  K19: each of the gate's eight bounds tripped in turn, a NaN,
and a safe grid.  The wiring: a coupled cycle calls each kernel once, an
ML-only cycle none of them (K3 takes the date).
The launch code itself runs only on a card (chip_smoke.py).
"""

import ctypes
import functools
import re
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.constants import PhysicalConstants as JConst
from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.hybrid.model import HybridAtmosphere as JHybrid
from speedy_ml_tpu.physics.boundaries import BoundaryData as JBoundaryData
from speedy_ml_tpu.physics.driver import PhysicsModel as JPhysics
from speedy_ml_tpu.physics.land_sea import \
    init_surface_state as jinit_sfc
from speedy_ml_tpu_torch import gcm as gcm_module
from speedy_ml_tpu_torch.convert import boundary_from_numpy
from speedy_ml_tpu_torch.core.constants import PhysicalConstants
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.core.spectral import SpectralTransform
from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.gcm import GCM, zero_carries
from speedy_ml_tpu_torch.hybrid import model as hybrid_model
from speedy_ml_tpu_torch.hybrid.build import build_untrained_hybrid
from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels import surface_forcing as sfk
from speedy_ml_tpu_torch.kernels.gate_check import (GATE_BOUNDS, gate_check,
                                                    gate_check_plain)
from speedy_ml_tpu_torch.kernels.inject_spectral import (
    inject_spectral_plain, inject_synthesis)
from speedy_ml_tpu_torch.kernels.window_gather import (window_gather,
                                                       window_gather_plain)
from speedy_ml_tpu_torch.kernels.window_select import (window_select,
                                                       window_select_plain)
from speedy_ml_tpu_torch.physics import driver as driver_module
from speedy_ml_tpu_torch.physics import land_sea
from speedy_ml_tpu_torch.physics.boundaries import synthetic_boundary_data
from speedy_ml_tpu_torch.physics.driver import PhysicsModel
from torch_lane import one_thread_per_pool  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
GEOMS = {"T30": dict(trunc=30, nlon=96, nlat=48),
         "T10": dict(trunc=10, nlon=32, nlat=16)}
T30 = dict(nlev=8, **GEOMS["T30"])
RTOL_F64 = 1e-12
# K17/K17b host build against the CPU plain version in float32: ulps of
# each plane's scale (its largest magnitude).  Measured: 2.4 in qcorr,
# where qref - qsfc cancels a powf and two expf of the last bit; at most
# 0.6 in the solar planes; the surface and the albedos bit for bit
K17_ULPS = 4
MONTHS = [(0, 0.25), (0, 0.75), (11, 0.25), (11, 0.75)]
TYEAR = 0.52
SST_BIAS = 0.25


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
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dp = ctypes.POINTER(ctypes.c_double)
    lib.surface_forcing_host.argtypes = [i] * 4 + [ctypes.POINTER(vp), vp,
                                                   vp, dp, ctypes.POINTER(i)]
    lib.tisr_host.argtypes = [i, i, i, vp, vp, vp, dp]
    lib.inject_block_host.argtypes = [i] * 4 + [vp] * 8
    lib.gate_host.argtypes = [i, i, ll, vp, dp, vp, vp]
    lib.select_host.argtypes = [i, i, ll] + [vp] * 8
    pv = ctypes.POINTER(vp)
    lib.window_gather_host.argtypes = [pv, ll, ll, i, pv, pv, pv, pv,
                                       ctypes.POINTER(ll), vp, vp, dp, i]
    return lib


def _ptr(t):
    if t is None:
        return None
    assert t.is_contiguous() and t.device.type == "cpu"
    return t.data_ptr()


def field_err(got, ref):
    """max over the leading axis of |got - ref| / the field's scale (real
    or complex)."""
    wide = torch.complex128 if got.is_complex() else torch.float64
    g = got.reshape(got.shape[0], -1).to(wide)
    r = torch.as_tensor(np.array(ref)).reshape(g.shape).to(wide)
    scale = r.abs().amax(dim=1).clamp(min=1e-300)
    return float(((g - r).abs().amax(dim=1) / scale).max())


def ulp_err(got, ref):
    """max over the leading axis of |got - ref| in ulps of the field's
    scale (the spacing of float32 at its largest magnitude)."""
    g = got.reshape(got.shape[0], -1)
    r = ref.reshape(g.shape)
    scale = r.abs().amax(dim=1)
    ulp = torch.finfo(torch.float32).eps * torch.where(scale > 0, scale, 1.0)
    return float(((g - r).abs().amax(dim=1) / ulp).max())


# ------------------------------------------------------------ K17, K17b

@functools.lru_cache(maxsize=None)
def mixed_fields(seed=5):
    """BoundaryData fields (numpy, float64) of a mixed land mask with sea
    ice, snow and orography at T30: SST on both sides of freezing, sea
    ice below and above 0.5, snow depths on both sides of SD2SC."""
    g = JGeometry(**T30)
    rng = np.random.default_rng(seed)
    grid = (g.nlat, g.nlon)
    u = lambda lo, hi, *lead: rng.uniform(lo, hi, lead + grid)
    fmask = np.where(u(0, 1) < 0.4, 0.0, u(0, 1))
    phis0 = 2.0e4 * fmask * u(0, 1)
    sice12 = np.where(u(0, 1, 12) < 0.5, 0.0, u(0, 1, 12))
    return dict(orog=phis0, phis0=phis0, fmask=fmask, fmask_l=fmask,
                bmask_l=(fmask > 0.5).astype(float), fmask_s=1.0 - fmask,
                bmask_s=(fmask <= 0.5).astype(float), alb0=u(0.1, 0.3),
                stl12=u(250.0, 310.0, 12), snowd12=u(0.0, 100.0, 12),
                soilw12=u(0.0, 1.0, 12), sst12=u(268.0, 305.0, 12),
                sice12=sice12, forog=1.0 + u(0, 0.5))


@functools.lru_cache(maxsize=None)
def jax_side():
    g = JGeometry(**T30)
    jsht = JST(g, dtype=jnp.float64, zonal="dft")
    jbd = JBoundaryData(**{k: jnp.asarray(v)
                           for k, v in mixed_fields().items()})
    return g, jsht, jbd, JPhysics(g, JConst(), dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def port_side(dtype):
    g = Geometry(**T30)
    sht = SpectralTransform(g, dtype=dtype, device="cpu")
    bd = boundary_from_numpy(SimpleNamespace(**mixed_fields()), device="cpu",
                             dtype=dtype)
    return g, sht, bd, PhysicsModel(g, PhysicalConstants(), dtype=dtype,
                                    device="cpu")


def hybrid_sst(imon, seed=6):
    """A hybrid SST (numpy) whose difference from the month's climatology
    lies on both sides of the 6 K test."""
    rng = np.random.default_rng(seed)
    sst = mixed_fields()["sst12"][imon]
    return sst - rng.uniform(-4.0, 12.0, sst.shape)


@pytest.mark.parametrize("hybrid", [False, True], ids=["no_hybrid",
                                                        "hybrid"])
@pytest.mark.parametrize("imon,fmon", MONTHS,
                         ids=[f"imon{m}_fmon{f}" for m, f in MONTHS])
def test_surface_forcing_plain_matches_jax(imon, fmon, hybrid):
    g, jsht, jbd, jphys = jax_side()
    _, sht, bd, phys = port_side(torch.float64)
    sst = hybrid_sst(imon) if hybrid else None
    jsfc = jinit_sfc(jbd, jnp.asarray(imon), jnp.asarray(fmon),
                     None if sst is None else jnp.asarray(sst), SST_BIAS)
    jf = jphys.daily_forcing(jbd, jsfc, TYEAR, jsht)
    tsst = None if sst is None else torch.as_tensor(sst)
    tsfc = land_sea.init_surface_state(bd, imon, fmon, tsst, SST_BIAS)
    tf = phys.daily_forcing(bd, tsfc, TYEAR, sht)
    for k in tsfc.__dataclass_fields__:
        err = field_err(getattr(tsfc, k)[None], getattr(jsfc, k))
        assert err <= RTOL_F64, (k, err)
    for k in tf.__dataclass_fields__:
        err = field_err(getattr(tf, k)[None], getattr(jf, k))
        assert err <= RTOL_F64, (k, err)
    # the window's entry in one call gives the same surface and forcing
    sfc2, f2 = phys.surface_and_forcing(bd, imon, fmon, TYEAR, sht, tsst,
                                        SST_BIAS)
    for a, b in ((tsfc, sfc2), (tf, f2)):
        for k in a.__dataclass_fields__:
            assert torch.equal(getattr(a, k), getattr(b, k)), k
    # the inputs reach both branches of each decision
    cl = dict(zip(sfk.SURFACE, sfk.surface_plain(bd, imon, fmon)))
    n = cl["sst"].numel()
    assert 0 < int((cl["sst"] > 271.4).sum()) < n
    assert 0 < int((cl["sice"] > 0.5).sum()) < int((cl["sice"] > 0).sum())
    if sst is not None:
        assert 0 < int((cl["sst"] - tsst < 6.0).sum()) < n
    assert 0 < int((tf.snowc == 1.0).sum()) < tf.snowc.numel()


def _host_k17(lib, bd, phys, month, sst, sfc, dtype, block=0,
              forcing=True, stl_carry=None):
    """K17 built for the host: (surface planes or None, forcing planes or
    None), every output starting as NaN.  block 0: the per-point body;
    block 1: the kernel's row blocks.  stl_carry: the carry form's land
    temperature."""
    nlat, nlon = bd.sst12.shape[-2:]
    day = phys.day_args(TYEAR)
    ins = [None] * 17
    ins[16] = stl_carry
    if month is not None:
        ins[:5] = [bd.stl12, bd.snowd12, bd.soilw12, bd.sst12, bd.sice12]
        ins[5] = sst
    if forcing:
        ins[6:10] = [bd.alb0, bd.fmask_l, bd.fmask_s, bd.phis0]
        if month is None:
            ins[10:14] = [sfc.stl_am, sfc.snowd_am, sfc.sst_am, sfc.sice_am]
        ins[14:16] = [day.slat, day.clat]
    scal, ix = sfk._scalars(month, SST_BIAS, TYEAR if forcing else None,
                            day.gamlat, day.pexp)
    planes = None if month is None else torch.full(
        (len(sfk.SURFACE), nlat, nlon), float("nan"), dtype=dtype)
    frc = None if not forcing else torch.full(
        (len(sfk.FORCING), nlat, nlon), float("nan"), dtype=dtype)
    ptrs = (ctypes.c_void_p * 17)(*[_ptr(t) for t in ins])
    assert lib.surface_forcing_host(int(dtype == torch.float64), block,
                                    nlat, nlon, ptrs, _ptr(planes),
                                    _ptr(frc), scal, ix) == 0
    return planes, frc


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["window", "surface_then_forcing"])
@pytest.mark.parametrize("imon,fmon", [(0, 0.25), (11, 0.75)],
                         ids=["imon0_fmon0.25", "imon11_fmon0.75"])
def test_surface_forcing_host_matches_plain(lib, imon, fmon, mode, dtype):
    _, _, bd, phys = port_side(dtype)
    sst = torch.as_tensor(hybrid_sst(imon)).to(dtype)
    day = phys.day_args(TYEAR)
    ref_s, ref_f = sfk.surface_forcing(bd, month=(imon, fmon),
                                       sst_hybrid=sst, sst_bias=SST_BIAS,
                                       day=day)
    if mode == "window":
        got_s, got_f = _host_k17(lib, bd, phys, (imon, fmon), sst, None,
                                 dtype)
    else:
        got_s, _ = _host_k17(lib, bd, phys, (imon, fmon), sst, None, dtype)
        sfc = land_sea.surface_state(got_s, 0)
        _, got_f = _host_k17(lib, bd, phys, None, None, sfc, dtype)
    for got, ref in ((got_s, ref_s), (got_f, ref_f)):
        assert not torch.isnan(got).any()
        if dtype == torch.float64:
            assert field_err(got, ref) <= RTOL_F64
        else:
            assert ulp_err(got, ref) <= K17_ULPS
    # the surface has no transcendental function: bit for bit
    assert torch.equal(got_s, ref_s)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["window", "surface", "forcing"])
@pytest.mark.parametrize("hybrid", [True, False], ids=["hybrid",
                                                       "no_hybrid"])
def test_surface_forcing_row_blocks_match_point_body(lib, hybrid, mode,
                                                     dtype):
    """K17's row blocks (the point threads' loads and latitude-free
    planes, the solar warp's row terms in shared memory starting as NaN,
    the barrier, the solar planes) bit for bit against the first design's
    per-point body, on the mixed land mask with sea ice: the window's call
    (surface and forcing), the surface alone and the forcing of a given
    surface."""
    _, _, bd, phys = port_side(dtype)
    month = (11, 0.75)
    sst = torch.as_tensor(hybrid_sst(11)).to(dtype) if hybrid else None
    sfc = None
    if mode == "forcing":
        sfc = land_sea.surface_state(_host_k17(
            lib, bd, phys, month, sst, None, dtype, forcing=False)[0], 0)
    m = None if mode == "forcing" else month
    kw = dict(forcing=mode != "surface")
    ref = _host_k17(lib, bd, phys, m, sst, sfc, dtype, **kw)
    got = _host_k17(lib, bd, phys, m, sst, sfc, dtype, block=1, **kw)
    for g_, r_ in zip(got, ref):
        assert (g_ is None) == (r_ is None)
        if r_ is not None:
            assert not torch.isnan(r_).any()
            assert torch.equal(g_, r_)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("block", [0, 1], ids=["point_body", "row_blocks"])
def test_surface_forcing_carry_form(lib, block, dtype):
    """K17's carry form (the persistent surface's window): the forcing
    reads the carried land temperature for stl_am, the surface planes
    stay as computed; the host build (per-point body and row blocks)
    against the plain version, which is forcing_plain of the surface with
    stl_am replaced: the surface bit for bit, the forcing as the window
    form's tolerance (RTOL_F64, K17_ULPS)."""
    _, _, bd, phys = port_side(dtype)
    month = (11, 0.75)
    sst = torch.as_tensor(hybrid_sst(11)).to(dtype)
    rng = np.random.default_rng(17)
    stl = (bd.stl12[11] + torch.as_tensor(
        rng.normal(0, 3.0, tuple(bd.stl12.shape[-2:]))).to(dtype))
    day = phys.day_args(TYEAR)
    ref_s, ref_f = sfk.surface_forcing(bd, month=month, sst_hybrid=sst,
                                       sst_bias=SST_BIAS, day=day,
                                       stl_carry=stl)
    p = dict(zip(sfk.SURFACE, ref_s))
    assert torch.equal(ref_f, sfk.forcing_plain(
        bd, stl, p["snowd"], p["sst_am"], p["sice"], day, bd.sst12.shape[-1]))
    got_s, got_f = _host_k17(lib, bd, phys, month, sst, None, dtype,
                             block=block, stl_carry=stl)
    _, no_carry = _host_k17(lib, bd, phys, month, sst, None, dtype,
                            block=block)
    assert torch.equal(got_s, ref_s)
    assert not torch.isnan(got_f).any()
    if dtype == torch.float64:
        assert field_err(got_f, ref_f) <= RTOL_F64
    else:
        assert ulp_err(got_f, ref_f) <= K17_ULPS
    # the carried temperature reached the diffusion corrections
    assert not torch.equal(got_f[1], no_carry[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("tyear", [0.01, 0.37, 0.8])
def test_tisr_plane(lib, tyear, dtype):
    """K17b: the plain version against the JAX package's tisr_field
    (float64) and the host build against the plain version."""
    g, _, _, phys = port_side(dtype)
    ref = sfk.tisr_plane(tyear, phys.slat_t, phys.clat_t, g.nlon)
    if dtype == torch.float64:
        jself = SimpleNamespace(gcm=SimpleNamespace(geom=JGeometry(**T30),
                                                    dtype=jnp.float64))
        assert field_err(ref, JHybrid.tisr_field(jself, tyear)) <= RTOL_F64
    got = torch.full((g.nlat, g.nlon), float("nan"), dtype=dtype)
    scal, _ = sfk._scalars(None, 0.0, tyear, 0.0, 0.0)
    assert lib.tisr_host(int(dtype == torch.float64), g.nlat, g.nlon,
                         _ptr(phys.slat_t), _ptr(phys.clat_t), _ptr(got),
                         scal) == 0
    if dtype == torch.float64:
        assert field_err(got, ref) <= RTOL_F64
    else:
        assert ulp_err(got[None], ref[None]) <= K17_ULPS
    # the hybrid's TISR field is this plane
    hyb = SimpleNamespace(geom=g, _slat=phys.slat_t, _clat=phys.clat_t)
    assert torch.equal(HybridAtmosphere.tisr_field(hyb, tyear), ref)


def _host_gather(lib, fields, idx, mean, std, date=None):
    """K3 built for the host over all the classes' outputs (starting as
    NaN): fields (atmo, logp, precip, sst, tisr plane or None), date
    (slat, clat, tyear) for tisr None."""
    vp = ctypes.c_void_p
    nc = len(idx)
    outs = [torch.full(i.shape, float("nan")) for i in idx]
    arr = lambda ts: (vp * nc)(*[_ptr(t) for t in ts])
    slat, clat, tyear = date if date is not None else (None, None, 0.0)
    scal = sfk.tisr_scalars(tyear) if date is not None else None
    atmo = fields[0]
    assert lib.window_gather_host(
        (vp * 5)(*[_ptr(f) for f in fields]), atmo.numel(),
        atmo.shape[-2] * atmo.shape[-1], nc, arr(idx), arr(mean), arr(std),
        arr(outs), (ctypes.c_longlong * nc)(*[i.numel() for i in idx]),
        _ptr(slat), _ptr(clat), scal, atmo.shape[-1]) == 0
    return outs


@pytest.mark.parametrize("tyear", [0.05, 0.61])
def test_gather_date_form_host(lib, tyear):
    """K3's date form built for the host (float32): each TISR element
    worked out from the date where it is read equals K17b's host plane
    gathered by the plane form, bit for bit; the plane form equals the
    plain version on that plane; an index outside the source gives NaN in
    both forms.  Two classes, tables reading every source block and the
    whole TISR block."""
    g, _, _, phys = port_side(torch.float32)
    K, nlat, nlon = 8, g.nlat, g.nlon
    G = nlat * nlon
    rng = np.random.default_rng(21)
    f32 = lambda *s: torch.as_tensor(rng.normal(size=s)).float()
    atmo = f32(4, K, nlat, nlon)
    n_src = atmo.numel() + 4 * G
    tisr_block = atmo.numel() + 3 * G + np.arange(G)
    tables = [np.concatenate([rng.integers(0, n_src, 3000), tisr_block]),
              rng.integers(atmo.numel() + 2 * G, n_src, 2000)]
    idx = [torch.as_tensor(t.astype(np.int32)).reshape(r, -1)
           for t, r in zip(tables, (2, 4))]
    mean = [f32(*i.shape) for i in idx]
    std = [torch.as_tensor(rng.uniform(0.5, 2.0, i.shape)).float()
           for i in idx]
    plane = torch.full((nlat, nlon), float("nan"))
    assert lib.tisr_host(0, nlat, nlon, _ptr(phys.slat_t), _ptr(phys.clat_t),
                         _ptr(plane), sfk.tisr_scalars(tyear)) == 0
    fields = (atmo, f32(nlat, nlon), f32(nlat, nlon), f32(nlat, nlon))
    by_plane = _host_gather(lib, fields + (plane,), idx, mean, std)
    by_date = _host_gather(lib, fields + (None,), idx, mean, std,
                           (phys.slat_t, phys.clat_t, tyear))
    plain = window_gather_plain(fields + (plane,), idx, mean, std)
    for a, b, c in zip(by_date, by_plane, plain):
        assert not torch.isnan(a).any()
        assert torch.equal(a, b) and torch.equal(b, c)
    # an index outside the source
    bad = [torch.tensor([[0, n_src, 5]], dtype=torch.int32)]
    one = [torch.ones(1, 3)]
    for fl, date in ((fields + (plane,), None),
                     (fields + (None,), (phys.slat_t, phys.clat_t, tyear))):
        out, = _host_gather(lib, fl, bad, one, one, date)
        assert torch.isnan(out).tolist() == [[False, True, False]]


# ------------------------------------------------------------------- K18

@functools.lru_cache(maxsize=None)
def transform(geom: str, K: int, dtype) -> SpectralTransform:
    return SpectralTransform(Geometry(nlev=K, **GEOMS[geom]), dtype=dtype,
                             device="cpu")


def analysed(seed, g, K, dtype):
    """K5's output (4K + 1, mx, nx) as red noise in the total wavenumber,
    real at m = 0, every coefficient set (beyond the truncation too)."""
    rng = np.random.default_rng(seed)
    cd = torch.complex128 if dtype == torch.float64 else torch.complex64
    red = 1.0 / (1.0 + np.add.outer(np.arange(g.mx), np.arange(g.nx)))
    z = (rng.normal(size=(4 * K + 1, g.mx, g.nx))
         + 1j * rng.normal(size=(4 * K + 1, g.mx, g.nx))) * red
    z[:, 0, :] = z[:, 0, :].real
    scale = np.concatenate([np.full(K, 3.0), np.full(K, 1.0), [1e-2],
                            np.full(2 * K, 10.0)])
    return torch.as_tensor(scale[:, None, None] * z).to(cd).contiguous()


def host_inject(lib, sht, spec, K):
    g = sht.geom
    mx, nx = g.mx, g.nx
    nan = complex("nan+nanj")
    new = lambda *s: torch.full(s, nan, dtype=spec.dtype)
    out = dict(vor=new(2, K, mx, nx), div=new(2, K, mx, nx),
               t=new(2, K, mx, nx), ps=new(2, mx, nx),
               tr=new(2, 1, K, mx, nx))
    stk = new(4 * K, mx, nx)
    assert lib.inject_block_host(
        K, int(spec.dtype == torch.complex128), mx, nx, _ptr(spec),
        *(_ptr(out[k]) for k in ("vor", "div", "t", "ps", "tr")), _ptr(stk),
        _ptr(sht.inject_blob)) == 0
    return out, stk


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("geom", ["T10", "T30"])
@pytest.mark.parametrize("K", [5, 7, 8])
def test_inject_blocks_match_plain(lib, K, geom, dtype):
    sht = transform(geom, K, dtype)
    spec = analysed(40 + K, sht.geom, K, dtype)
    got, got_stk = host_inject(lib, sht, spec, K)
    ref, ref_stk = inject_spectral_plain(sht, spec, K)
    for k, v in got.items():
        assert torch.equal(v, getattr(ref, k)), k
    assert torch.equal(got_stk, ref_stk)


def grid_atmo(seed, g):
    """(atmo (4, K, lat, lon) = [t, u, v, q], logp) of plausible
    magnitudes (q below 0 at some points, for the clamp), numpy."""
    rng = np.random.default_rng(seed)
    K, grid = g.nlev, (g.nlat, g.nlon)
    atmo = np.stack([250.0 + 20.0 * rng.normal(size=(K,) + grid),
                     15.0 * rng.normal(size=(K,) + grid),
                     10.0 * rng.normal(size=(K,) + grid),
                     rng.uniform(-0.5, 15.0, (K,) + grid)])
    return atmo, 0.05 * rng.normal(size=grid)


def test_inject_plain_matches_jax():
    """inject_to_speedy (K5, K6_inject, K19 on the card) against the JAX
    package's, and inject_synthesis's CPU route (K6_inject's plain
    version: K18's stack, then the synthesis) against its vdspec, trunct
    and uv_grid (hybrid/model.py:410-421): the state and the grid."""
    K = 8
    g = JGeometry(**T30)
    jsht = JST(g, dtype=jnp.float64, zonal="dft")
    sht = transform("T30", K, torch.float64)
    atmo, logp = grid_atmo(3, g)
    jstate, jsafe = JHybrid.inject_to_speedy(
        SimpleNamespace(gcm=SimpleNamespace(sht=jsht)), jnp.asarray(atmo),
        jnp.asarray(logp))
    tatmo, tlogp = torch.as_tensor(atmo), torch.as_tensor(logp)
    port = SimpleNamespace(gcm=SimpleNamespace(sht=sht), nz=K)
    state, safe = HybridAtmosphere.inject_to_speedy(port, tatmo, tlogp)
    for k in ("vor", "div", "t", "ps", "tr"):
        ref = np.asarray(getattr(jstate, k))
        got = getattr(state, k)
        assert field_err(got.reshape(-1, *got.shape[-2:]),
                         ref.reshape(-1, *ref.shape[-2:])) <= RTOL_F64, k
    assert bool(safe) == bool(jsafe)
    # the stack on the grid: [t2, q2, u2, v2]
    spec = sht.analysis(torch.cat([tatmo[0], torch.clamp(tatmo[3], min=0.0),
                                   tlogp[None], tatmo[1], tatmo[2]]),
                        2 * K + 1)
    istate, back = inject_synthesis(sht, spec, K)
    for k in SpectralState.FIELDS:
        assert torch.equal(getattr(istate, k), getattr(state, k)), k
    _, stk = inject_spectral_plain(sht, spec, K)
    assert torch.equal(back, sht.synthesis(stk, 2 * K))
    jvor, jdiv = jsht.vdspec(jnp.asarray(atmo[1]), jnp.asarray(atmo[2]),
                             kcos=2)
    u2, v2 = jsht.uv_grid(jsht.trunct(jvor), jsht.trunct(jdiv))
    t2 = jsht.spec_to_grid(jsht.trunct(jsht.grid_to_spec(jnp.asarray(
        atmo[0]))))
    q2 = jsht.spec_to_grid(jsht.trunct(jsht.grid_to_spec(jnp.maximum(
        jnp.asarray(atmo[3]), 0.0))))
    assert field_err(back, np.concatenate([t2, q2, u2, v2])) <= RTOL_F64


# ------------------------------------------------------------------- K19

GATE_CASES = ["safe", "nan"] + [f"{v}_{s}" for v in "uvtq"
                                for s in ("min", "max")]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", GATE_CASES)
def test_gate(lib, case, dtype):
    """Each of the eight bounds tripped in turn (by one value just beyond
    it), a NaN, and a safe grid: the plain version's flag and extrema, the
    host build's bit for bit."""
    K, nlat, nlon = 8, 16, 32
    rng = np.random.default_rng(len(case))
    mid = {v: 0.5 * (lo + hi) for v, (lo, hi) in zip("uvtq", GATE_BOUNDS)}
    half = {v: 0.45 * (hi - lo) for v, (lo, hi) in zip("uvtq", GATE_BOUNDS)}
    # the stack [t, q, u, v], each variable within 90% of its range
    back = np.concatenate([mid[v] + half[v] * rng.uniform(
        -1, 1, (K, nlat, nlon)) for v in "tquv"])
    back = torch.as_tensor(back).to(dtype)
    order = {"t": 0, "q": 1, "u": 2, "v": 3}
    at = (3, 5, 7)
    if case == "nan":
        back[order["q"] * K + at[0], at[1], at[2]] = float("nan")
    elif case != "safe":
        v, side = case.split("_")
        lo, hi = GATE_BOUNDS["uvtq".index(v)]
        beyond = torch.nextafter(torch.tensor(lo if side == "min" else hi,
                                              dtype=dtype),
                                 torch.tensor(-np.inf if side == "min"
                                              else np.inf, dtype=dtype))
        back[order[v] * K + at[0], at[1], at[2]] = beyond
    back = back.contiguous()
    safe, ext = gate_check(back, K)
    assert bool(safe) == (case == "safe")
    got_ext = torch.full((8,), 1.0, dtype=dtype)
    got_safe = torch.ones((), dtype=torch.bool)
    bounds = (ctypes.c_double * 8)(*[b for lh in GATE_BOUNDS for b in lh])
    assert lib.gate_host(int(dtype == torch.float64), K, nlat * nlon,
                         _ptr(back), bounds, _ptr(got_ext),
                         _ptr(got_safe)) == 0
    assert bool(got_safe) == bool(safe)
    torch.testing.assert_close(got_ext, ext, rtol=0, atol=0, equal_nan=True)
    if case == "nan":
        assert torch.isnan(ext[6:]).all() and not torch.isnan(ext[:6]).any()
    # the gate of the JAX package's form on the same grid
    u2, v2, t2, q2 = back[2 * K:3 * K], back[3 * K:], back[:K], back[K:2 * K]
    ref = ((u2.amin() >= -150.0) & (u2.amax() <= 150.0)
           & (v2.amin() >= -120.0) & (v2.amax() <= 120.0)
           & (t2.amin() >= 160.0) & (t2.amax() <= 330.0)
           & (q2.amin() >= -6.0) & (q2.amax() <= 30.0))
    assert bool(ref) == bool(safe) and torch.equal(gate_check_plain(
        back, K)[0], ref)


# ------------------------------------------------------------------- K20

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("select", ["none", "ok", "prev_false",
                                    "safe_false"])
def test_window_select(lib, select, dtype):
    """The plain version against torch.stack + torch.where, and the host
    build against the plain version bit for bit."""
    K, nlat, nlon = 8, 48, 96
    rng = np.random.default_rng(9)
    out = torch.as_tensor(rng.normal(size=(5 * K + 1, nlat, nlon))) \
        .to(dtype)
    atmo_in = torch.as_tensor(rng.normal(size=(4, K, nlat, nlon))).to(dtype)
    logp_in = torch.as_tensor(rng.normal(size=(nlat, nlon))).to(dtype)
    sel = None
    if select != "none":
        prev = torch.tensor(select != "prev_false")
        safe = torch.tensor(select != "safe_false")
        sel = (prev, safe, atmo_in, logp_in)
    atmo, logp, ok = window_select(out, K, sel)
    w_atmo = torch.stack([out[:K], out[3 * K + 1:4 * K + 1],
                          out[4 * K + 1:], out[K:2 * K]])
    keep = select in ("none", "ok")
    assert torch.equal(atmo, w_atmo if keep else atmo_in)
    assert torch.equal(logp, out[3 * K] if keep else logp_in)
    assert (ok is None) == (select == "none")
    if ok is not None:
        assert bool(ok) == keep
    nan = float("nan")
    got_a = torch.full((4, K, nlat, nlon), nan, dtype=dtype)
    got_l = torch.full((nlat, nlon), nan, dtype=dtype)
    got_ok = torch.zeros((), dtype=torch.bool)
    ptrs = [None] * 4 if sel is None else [_ptr(t) for t in sel]
    assert lib.select_host(int(dtype == torch.float64), K, nlat * nlon,
                           _ptr(out), *ptrs, _ptr(got_a), _ptr(got_l),
                           _ptr(got_ok)) == 0
    assert torch.equal(got_a, atmo) and torch.equal(got_l, logp)
    if ok is not None:
        assert bool(got_ok) == bool(ok)
    assert torch.equal(window_select_plain(out, K, sel)[0], atmo)


def test_exit_matches_the_five_field_synthesis():
    """GCM.grid_state (K15's physics stack at level 0, K6 of its 41 fields,
    K20) against the window's former exit: uvspec and a synthesis of
    [t, q, ps | u cos, v cos]."""
    g = Geometry(**T30)
    gcm = GCM(g, dtype=torch.float64, nsteps_day=8, device="cpu",
              bd=synthetic_boundary_data(g, dtype=torch.float64))
    rng = np.random.default_rng(13)
    red = 1.0 / (1.0 + np.add.outer(np.arange(g.mx), np.arange(g.nx)))
    noise = lambda s, *lead: torch.as_tensor(s * red * (
        rng.normal(size=lead + (g.mx, g.nx))
        + 1j * rng.normal(size=lead + (g.mx, g.nx))))
    K = g.nlev
    spec = SimpleNamespace(vor=noise(2e-5, 2, K), div=noise(5e-6, 2, K),
                           t=noise(3.0, 2, K), ps=noise(1e-2, 2),
                           tr=noise(1.0, 2, 1, K))
    for f in ("vor", "div", "t", "ps", "tr"):
        getattr(spec, f)[..., 0, :].imag.zero_()
    spec = SpectralState(**vars(spec))
    atmo, logp, ok = gcm.grid_state(spec)
    sht = gcm.sht
    ucosm, vcosm = sht.uvspec(spec.vor[0], spec.div[0])
    old = sht.synthesis(torch.cat([spec.t[0], spec.tr[0, 0],
                                   spec.ps[0][None], ucosm, vcosm]),
                        2 * K + 1)
    ref = torch.stack([old[:K], old[2 * K + 1:3 * K + 1], old[3 * K + 1:],
                       old[K:2 * K]])
    assert ok is None
    assert field_err(atmo.reshape(4 * K, -1), ref.reshape(4 * K, -1)) \
        <= RTOL_F64
    assert field_err(logp[None], old[2 * K][None]) <= RTOL_F64


# ------------------------------------------------------- wiring and checks

def test_zero_carries_are_views_of_one_buffer():
    rad, fx = zero_carries(8, 48, 96, torch.float32)
    fields = list(vars(rad).values()) + list(vars(fx).values())
    assert len(fields) == 11
    base = fields[0].untyped_storage().data_ptr()
    assert all(f.untyped_storage().data_ptr() == base for f in fields)
    assert all(not f.any() and f.is_contiguous() for f in fields)
    assert all(f.storage_offset() % 64 == 0 for f in fields)
    assert tuple(rad.tau2.shape) == (8, 4, 48, 96)
    assert tuple(rad.randfv.shape) == (2, 48, 8)
    assert tuple(fx.precip.shape) == (48, 96)


@functools.lru_cache(maxsize=None)
def t10_hybrid(ml_only: bool):
    """A T10 float64 GCM on the CPU and an untrained hybrid on it."""
    g = Geometry(**GEOMS["T10"], nlev=8)
    gcm = GCM(g, dtype=torch.float64, nsteps_day=8, device="cpu",
              bd=synthetic_boundary_data(g, dtype=torch.float64))
    return gcm, build_untrained_hybrid(gcm, n_regions=128, m=300,
                                       ml_only=ml_only, device="cpu")


def _spy(monkeypatch, calls, module, name):
    """Record (name, its keyword arguments that are not None) and the
    positional arguments of every call of module.name."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append((name, sorted(k for k, v in kw.items()
                                   if v is not None), a))
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, wrapped)


def _t10_sst(g):
    lat = np.asarray(g.lat_radians)
    return np.broadcast_to(290.0 - 20 * np.sin(lat)[:, None] ** 2,
                           (g.nlat, g.nlon)).copy()


@pytest.mark.parametrize("cycle", ["coupled", "ml_only"])
def test_coupled_cycle_calls_each_kernel_once(monkeypatch, cycle):
    """One coupled cycle on the CPU: K17 once (surface and forcing in one
    call), K6_inject, K19 and K20 (with the gate's select) once each, and
    no K17b: the TISR plane it feeds back is its window's fsol.  An
    ML-only cycle runs none of them, K17b neither: its one K3 launch of
    the feedback takes the date."""
    gcm, hyb = t10_hybrid(cycle == "ml_only")
    calls = []
    _spy(monkeypatch, calls, driver_module, "surface_forcing")
    _spy(monkeypatch, calls, hybrid_model, "inject_synthesis")
    _spy(monkeypatch, calls, hybrid_model, "gate_check")
    _spy(monkeypatch, calls, hybrid_model, "tisr_plane")
    _spy(monkeypatch, calls, gcm_module, "window_select")
    _spy(monkeypatch, calls, hybrid_model, "window_gather")
    s = hyb.init_state(_t10_sst(gcm.geom))
    s, diag = hyb.cycle(s, 0, 0.5, 0.05)
    gathers = [c[2] for c in calls if c[0] == "window_gather"]
    calls = [c for c in calls if c[0] != "window_gather"]
    names = sorted(c[0] for c in calls)
    (fields, *_), = [a for a in gathers if a[1] is hyb.feedback_index]
    if cycle == "ml_only":
        assert names == [], calls
        date = fields[4]
        assert isinstance(date, sfk.TisrDate) and date.tyear == 0.05
        assert date.slat is hyb._slat and date.clat is hyb._clat
        assert torch.isfinite(diag["atmo"]).all()
        return
    assert torch.is_tensor(fields[4])
    assert names == sorted(["surface_forcing", "inject_synthesis",
                            "gate_check", "window_select"]), calls
    assert ("surface_forcing", ["day", "month", "sst_bias",
                                "sst_hybrid"]) in [c[:2] for c in calls]
    assert bool(s.safe) and torch.isfinite(diag["speedy_atmo"]).all()


@pytest.mark.parametrize("tyear", [0.05, 0.61])
def test_coupled_cycle_feeds_back_the_window_fsol(monkeypatch, tyear):
    """The TISR plane of a coupled cycle's feedback is its window's
    forcing.fsol, and that plane equals tisr_plain (K17b's plain version)
    at the same tyear, bit for bit."""
    gcm, hyb = t10_hybrid(False)
    calls = []
    _spy(monkeypatch, calls, hybrid_model, "window_gather")
    _spy(monkeypatch, calls, driver_module, "surface_forcing")
    s = hyb.init_state(_t10_sst(gcm.geom))
    hyb.cycle(s, 3, 0.4, tyear)
    fb = [a for nm, _, a in calls if nm == "window_gather"
          and a[1] is hyb.feedback_index]
    (fields, *_), = fb
    tisr = fields[4]
    g = gcm.geom
    assert torch.equal(tisr, sfk.tisr_plain(tyear, hyb._slat, hyb._clat,
                                            g.nlon))
    frc = dict(zip(sfk.FORCING, sfk.forcing_plain(
        gcm.bd, *[torch.zeros(g.nlat, g.nlon, dtype=torch.float64)] * 4,
        gcm.phys.day_args(tyear), g.nlon)))
    assert torch.equal(tisr, frc["fsol"])


def test_c_signatures_match_the_entry_points():
    """Every SPEEDY_API function of csrc/*.cu takes as many arguments as
    kernels/build.py SIGNATURES gives ctypes (a mismatch shows only on a
    card otherwise)."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r"SPEEDY_API\s+(?:\w+\s+)+?(\w+)\(([^)]*)\)",
                             text):
            args = [a for a in m.group(2).split(",") if a.strip()]
            found[m.group(1)] = len(args)
    assert set(found) == set(kb.SIGNATURES)
    for name, n in found.items():
        assert len(kb.SIGNATURES[name]) == n, name


@pytest.mark.parametrize("kernel", ["surface_forcing", "tisr_plane",
                                    "inject_synthesis", "gate_check",
                                    "window_select", "window_gather_date"])
def test_wrappers_raise_off_cpu_and_cuda(kernel):
    _, sht, bd, phys = port_side(torch.float32)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        if kernel == "surface_forcing":
            sfk.surface_forcing(
                SimpleNamespace(**{k: meta(v) for k, v in vars(bd).items()}),
                month=(0, 0.3))
        elif kernel == "tisr_plane":
            sfk.tisr_plane(0.3, meta(phys.slat_t), meta(phys.clat_t), 96)
        elif kernel == "inject_synthesis":
            inject_synthesis(sht, torch.zeros(
                33, 31, 32, dtype=torch.complex64, device="meta"), 8)
        elif kernel == "window_gather_date":
            one = torch.ones(1, 4, device="meta")
            window_gather((torch.zeros(4, 8, 48, 96, device="meta"),
                           *[torch.zeros(48, 96, device="meta")] * 3,
                           sfk.TisrDate(0.3, meta(phys.slat_t),
                                        meta(phys.clat_t))),
                          [one.int()], [one], [one])
        elif kernel == "gate_check":
            gate_check(torch.zeros(32, 48, 96, device="meta"), 8)
        else:
            window_select(torch.zeros(41, 48, 96, device="meta"), 8)

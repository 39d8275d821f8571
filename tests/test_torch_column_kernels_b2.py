"""Port parity of the column kernels K10a_down_surface's surface fluxes
(kernels/column_longwave.py down_surface, with kernels/surface_fluxes.py),
K12 (kernels/column_pbl.py) and K13 (kernels/column_shortwave.py).

The plausible random columns of tests/test_torch_column_kernels.py (16 x
32 columns, made from a seed with numpy) and K9's plain outputs on them
go through
  (a) the JAX package's radlw_down followed by suflux, vdifsc + the sums
      of PhysicsModel.compute
      (speedy_ml_tpu/physics/driver.py:258-275, 298-307) and cloud +
      radsw (do_sw, driver.py:221-238), and the port's wrappers on CPU
      tensors (their plain versions), float64, 1e-12 of each output's
      scale; the shortwave with the precipitation top iptop forced to 0,
      1, an interior level and K, and with columns whose cloud top is K;
  (b) the column bodies of the CUDA kernels, compiled for the host with
      g++ from kernels/csrc/column_host.cpp, against the plain versions:
      float64 at 1e-12, float32 within 1e-5 of each output's scale (the
      rule of chip_smoke.column_errors); the buffers are unpacked by the
      wrappers' own `unpack`; and K12's block (32 columns x K levels, its
      threads written out as loops) against its per-column body bit for
      bit;
  (c) one whole physics step, with and without the shortwave, through
      PhysicsModel.compute with every kernel's CPU route replaced by its
      host-built body (K9, K10a_down_surface, K10b, K12, K13), against the
      JAX package's
      PhysicsModel.compute, float64, 1e-10: the wiring between kernels;
  (d) the wrappers' operand checks and their table blobs.
The launch code itself runs only on a card (chip_smoke.py).
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.constants import PhysicalConstants as JConst
from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.physics import constants as jpc
from speedy_ml_tpu.physics import radiation as jrad
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu.physics.driver import PhysicsModel as JPhysics
from speedy_ml_tpu.physics.driver import RadiationCarry as JCarry
from speedy_ml_tpu.physics.land_sea import \
    init_surface_state as jinit_sfc
from speedy_ml_tpu.physics.surface import sflset as jsflset
from speedy_ml_tpu.physics.vdiff import vdifsc as jvdifsc
from speedy_ml_tpu_torch.convert import boundary_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.core.spectral import SpectralTransform
from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels import column_longwave as clw
from speedy_ml_tpu_torch.kernels import column_moist as cm
from speedy_ml_tpu_torch.kernels import column_pbl as cpbl
from speedy_ml_tpu_torch.kernels import column_shortwave as csw
from speedy_ml_tpu_torch.kernels import surface_fluxes as sf
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics import land_sea
from speedy_ml_tpu_torch.physics import radiation as rad
from speedy_ml_tpu_torch.physics.driver import RadiationCarry
from test_torch_column_kernels import (GEOM, NGP, NLAT, NLON, _close, _hold,
                                       _plane, _t, down_surface_args, ds_dict,
                                       host_down_surface, host_lib,
                                       host_moist, host_up, jax_down_surface,
                                       make_columns, moist_inputs, phys_for,
                                       sfc_dict, surface_kwargs)

KX = 8
SOLAR = ((0.0, 420.0), (0.0, 15.0), (0.0, 15.0), (1.0, 4.0), (0.0, 10.0))


# ------------------------------------------------------------------ inputs

def moist(seed, dtype=torch.float64, K=KX):
    """K9's plain outputs on the random columns, and the grid fields."""
    phys = phys_for(dtype, K)
    tg, qg, phig, pslg = moist_inputs(seed, dtype, K)
    return phys, cm.column_moist_plain(tg, qg, phig, pslg,
                                       phys.moist_tabs), tg, phig


def pbl_args(seed, phys, m, tg, phig):
    """column_pbl's operands: K9's outputs, K11's fluxes on them, a
    radiation carry's tt_rsw/ssrd, a longwave dfabs, sea ice."""
    rng = np.random.default_rng(seed + 50)
    dt = m.se.dtype
    K = tg.shape[0]
    fx = sf.surface_fluxes_plain(
        **surface_kwargs(seed, m.psg, m.qg, tg, phig, "mixed", dt),
        tabs=phys.sfc_tabs)
    lev = lambda lo, hi: _t(rng.uniform(lo, hi, (K, NLAT, NLON)), dt)
    return (m, phig, fx, lev(-2e-4, 2e-4), _t(_plane(rng, 0.0, 400.0), dt),
            lev(-60.0, 60.0), _t(_plane(rng, 250.0, 272.0), dt),
            _t(_plane(rng, 0.0, 0.8), dt))


def shortwave_args(seed, phys, m, phig, iptop="data"):
    """column_shortwave's operands.  iptop: K9's itop ("data") or forced
    to 0, 1, an interior level or K; a quarter of the columns get a dry
    PBL top (rh below RHCL1), so that no level is cloudy there."""
    rng = np.random.default_rng(seed + 60)
    dt = m.se.dtype
    K = m.se.shape[0]
    rh = m.rh.clone()
    dry = torch.as_tensor(rng.uniform(size=(NLAT, NLON)) < 0.25)
    rh[K - 2] = torch.where(dry, _t(_plane(rng, 0.0, 0.3), dt), rh[K - 2])
    rh[2:K - 2] = torch.where(dry, rh[2:K - 2] * 0.25, rh[2:K - 2])
    if iptop != "data":
        level = dict(zero=0, one=1, interior=K // 2, top=K)[iptop]
        m = m._replace(itop=torch.full_like(m.itop, level))
    sol = rad.SolarForcing(*(_t(_plane(rng, lo, hi), dt) for lo, hi in SOLAR))
    return (m._replace(rh=rh), phig, _t(_plane(rng, 0.0, 1.0), dt), sol,
            _t(_plane(rng, 0.05, 0.6), dt))


def _j(a):
    return jnp.asarray(a.numpy())


PBL_OUT = ("utend", "vtend", "ttend", "qtend", "hflux_i")
SW_OUT = ("tau2", "stratc", "tt_rsw", "ssrd", "ssr", "tsr")


# ------------------------------------------------ (a): against the JAX code

def jax_pbl(jphys, m, phig, fx, tt_rsw, ssrd, dfabs_lw, tice, sice):
    """vdifsc and the sums of the JAX package's PhysicsModel.compute
    (physics/driver.py:262-275, 298-307)."""
    c, K = jphys.const, phig.shape[0]
    g = lambda t: _j(t)
    rps = g(m.rps)
    ut, vt, tt, qt = jvdifsc(g(phig), g(phig), g(m.se), g(m.rh), g(m.qg),
                             g(m.qsat), g(phig), g(m.icnv), sig=jphys.sig,
                             sigh=jphys.sigh, dsig=jphys.dsig, cp=c.cp,
                             alhc=c.alhc)
    ttend = g(m.ttend) + g(tt_rsw) \
        + g(dfabs_lw) * rps[None] * jphys.grdscp[:, None, None]
    bot = K - 1
    ut = ut.at[bot].add(g(fx.ustr[2]) * rps * jphys.grdsig[bot])
    vt = vt.at[bot].add(g(fx.vstr[2]) * rps * jphys.grdsig[bot])
    tt = tt.at[bot].add(g(fx.shf[2]) * rps * jphys.grdscp[bot])
    qt = qt.at[bot].add(g(fx.evap[2]) * rps * jphys.grdsig[bot])
    esbc = jpc.EMISFC * c.sbc
    difice = ((jpc.ALBSEA - jpc.ALBICE) * g(ssrd)
              + esbc * (jpc.SSTFR ** 4 - g(tice) ** 4)
              + g(fx.shf[1]) + g(fx.evap[1]) * c.alhc)
    return (ut, vt, ttend + tt, g(m.qtend) + qt,
            g(fx.hfluxn[1]) + difice * (1.0 - g(sice)))


def jax_shortwave(jphys, m, phig, fmask, sol, albsfc):
    """The do_sw branch of the JAX package's PhysicsModel.compute."""
    K = phig.shape[0]
    g = lambda t: _j(t)
    se, ph = g(m.se), g(phig)
    gse = (se[K - 2] - se[K - 1]) / (ph[K - 2] - ph[K - 1])
    jc = jrad.cloud(g(m.qg), g(m.rh), g(m.precnv), g(m.precls), g(m.itop),
                    gse, g(fmask))
    ssrd, ssr, tsr, dfabs, tau2, stratc = jrad.radsw(
        g(m.psg), g(m.qg), *jc, jrad.SolarForcing(*map(g, sol)), g(albsfc),
        sig=jphys.sig, dsig=jphys.dsig)
    tt_rsw = dfabs * g(m.rps)[None] * jphys.grdscp[:, None, None]
    return (tau2, stratc, tt_rsw, ssrd, ssr, tsr), jc[0]


def _jphys(K=KX):
    return JPhysics(JGeometry(nlev=K, **GEOM), JConst(), dtype=jnp.float64)


@pytest.mark.parametrize("mask", ["sea", "land", "mixed"])
def test_surface_fluxes_matches_jax(mask):
    """down_surface's surface fluxes (and its downward longwave, whose
    slrd they take) against the JAX package's radlw_down followed by
    suflux."""
    phys, m, tg, phig = moist(51)
    kw = surface_kwargs(51, m.psg, m.qg, tg, phig, mask)
    tau2 = _t(np.random.default_rng(151).uniform(0.05, 1.0,
                                                 (KX, 4, NLAT, NLON)))
    before = clw.down_surface.launches
    down, got = clw.down_surface(**down_surface_args(kw, tau2),
                                 lw_tabs=phys.lw_tabs,
                                 sfc_tabs=phys.sfc_tabs)
    assert clw.down_surface.launches == before   # the CPU route counts 0
    jdown, ref = jax_down_surface(_jphys(), kw, tau2)
    K = tg.shape[0]
    unstable = tg[K - 1] > tg[K - 2]
    assert unstable.any() and not unstable.all()
    if mask != "sea":
        assert (got.evap[0] == 0).any() and (got.evap[0] > 0).any()
    for nm, r in sfc_dict(ref).items():
        _close(sfc_dict(got)[nm], r)
    _close(down[0], jdown[0])


@pytest.mark.parametrize("seed", [52, 53])
def test_column_pbl_matches_jax(seed):
    phys, m, tg, phig = moist(seed)
    args = pbl_args(seed, phys, m, tg, phig)
    before = cpbl.column_pbl.launches
    got = cpbl.column_pbl(*args, phys.pbl_tabs)
    assert cpbl.column_pbl.launches == before
    K = tg.shape[0]
    assert (m.icnv > 0).any() and (m.icnv <= 0).any()
    dmse = (m.se[K - 1] - m.se[K - 2]) \
        + phys.const.alhc * (m.qg[K - 1] - m.qsat[K - 2])
    assert (dmse >= 0).any() and (dmse < 0).any()
    se0 = m.se[1:] + pc.SEGRAD * (phig[:-1] - phig[1:])
    assert (m.se[:-1] < se0).any(), "no super-adiabatic layer"
    for g, r in zip(got, jax_pbl(_jphys(), *args)):
        _close(g, r)
    assert float(got[0][:K - 1].abs().max()) == 0.0


@pytest.mark.parametrize("iptop", ["data", "zero", "one", "interior", "top"])
def test_column_shortwave_matches_jax(iptop):
    phys, m, tg, phig = moist(54)
    args = shortwave_args(54, phys, m, phig, iptop)
    before = csw.column_shortwave.launches
    got = csw.column_shortwave(*args, phys.sw_tabs)
    assert csw.column_shortwave.launches == before
    ref, icltop = jax_shortwave(_jphys(), *args)
    icltop = np.asarray(icltop)
    K = tg.shape[0]
    if iptop in ("zero", "one"):        # the reflectivity quirk
        assert (icltop == dict(zero=0, one=1)[iptop]).all()
    elif iptop == "interior":
        assert (icltop == K // 2).any()
    else:
        assert (icltop < K).any()
        assert iptop == "data" or (icltop == K).any()
    for g, r in zip(got, ref):
        _close(g, r)
    assert got[0].shape == (K, 4, NLAT, NLON)


# ------------------------- (b): the kernels' column bodies, built for the host

@pytest.fixture(scope="module")
def lib(host_lib):
    """The host build with the argument types of the K11-K13 entries."""
    vp, i, pp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
    host_lib.column_pbl_host.argtypes = [i, i, pp, i, vp, i, vp]
    host_lib.column_pbl_block_host.argtypes = [i, i, pp, i, vp, i, vp]
    host_lib.column_shortwave_host.argtypes = [i, i, pp, i, vp, i, vp]
    for fn in (host_lib.column_pbl_host, host_lib.column_pbl_block_host,
               host_lib.column_shortwave_host):
        fn.restype = i
    return host_lib


def _out(rows, like):
    return torch.full((rows,) + tuple(like.shape[-2:]), float("nan"),
                      dtype=like.dtype)


def host_pbl(lib, *args):
    K, nlat, nlon, ins = cpbl.operands(*args)
    se = args[0].se
    out = _out(4 * K + 1, se)
    rc = lib.column_pbl_host(K, int(se.dtype == torch.float64),
                             kb.pointer_array(ins), len(ins),
                             args[-1].blob.data_ptr(), nlat * nlon,
                             out.data_ptr())
    assert rc == 0
    return cpbl.unpack(out, K)


def host_shortwave(lib, *args):
    K, nlat, nlon, ins = csw.operands(*args)
    se = args[0].se
    out = _out(5 * K + 5, se)
    rc = lib.column_shortwave_host(K, int(se.dtype == torch.float64),
                                   kb.pointer_array(ins), len(ins),
                                   args[-1].blob.data_ptr(), nlat * nlon,
                                   out.data_ptr())
    assert rc == 0
    return csw.unpack(out, K)


def _check_three(lib, seed, dtype, K=KX, iptop="data"):
    phys, m, tg, phig = moist(seed, dtype, K)
    kw = surface_kwargs(seed, m.psg, m.qg, tg, phig, "mixed", dtype)
    tau2 = _t(np.random.default_rng(seed + 90).uniform(
        0.05, 1.0, (K, 4, NLAT, NLON)), dtype)
    ds = dict(down_surface_args(kw, tau2), lw_tabs=phys.lw_tabs,
              sfc_tabs=phys.sfc_tabs)
    _hold(ds_dict(host_down_surface(lib, **ds)),
          ds_dict(clw.down_surface_plain(**ds)), dtype)
    pa = pbl_args(seed, phys, m, tg, phig) + (phys.pbl_tabs,)
    _hold(dict(zip(PBL_OUT, host_pbl(lib, *pa))),
          dict(zip(PBL_OUT, cpbl.column_pbl_plain(*pa))), dtype)
    sa = shortwave_args(seed, phys, m, phig, iptop) + (phys.sw_tabs,)
    _hold(dict(zip(SW_OUT, host_shortwave(lib, *sa))),
          dict(zip(SW_OUT, csw.column_shortwave_plain(*sa))), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("iptop", ["data", "zero", "one", "top"])
def test_host_columns_b2_match_plain(lib, iptop, dtype):
    _check_three(lib, 61, dtype, iptop=iptop)


@pytest.mark.parametrize("ncols", [NGP, NGP - 12], ids=["grid", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("K", [5, 7, 8])
def test_host_pbl_block_matches_column_body(lib, K, dtype, ncols):
    """K12's block (32 columns x K warps: the loads and the sums a level
    to a warp, vdifsc on one warp, handed on through shared memory that
    starts as NaN) gives the first design's per-column body bit for bit;
    on the whole grid and on NGP - 12 columns, whose last block is
    ragged."""
    phys, m, tg, phig = moist(70 + K, dtype, K)
    pa = pbl_args(70 + K, phys, m, tg, phig) + (phys.pbl_tabs,)
    _, _, _, ins = cpbl.operands(*pa)
    cols = [(a.reshape(K, -1) if a.dim() == 3 else a.reshape(1, -1))
            [:, :ncols].contiguous() for a in ins]
    blob = phys.pbl_tabs.blob.data_ptr()
    outs = []
    for entry in (lib.column_pbl_host, lib.column_pbl_block_host):
        out = torch.full((4 * K + 1, ncols), float("nan"), dtype=dtype)
        assert entry(K, int(dtype == torch.float64),
                     kb.pointer_array(cols), len(cols), blob, ncols,
                     out.data_ptr()) == 0
        outs.append(out)
    ref, got = outs
    assert not got.isnan().any()
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("K", [5, 7])
def test_host_columns_b2_at_other_level_counts(lib, K):
    """The bodies are templates on K; 5 and 7 levels are compiled too."""
    _check_three(lib, 62, torch.float64, K)
    null = ctypes.POINTER(ctypes.c_void_p)()
    assert lib.column_pbl_host(6, 1, null, len(cpbl.INPUTS), None, 1,
                               None) == 1
    assert lib.column_pbl_host(8, 1, null, 3, None, 1, None) == 1
    assert lib.column_pbl_block_host(6, 1, null, len(cpbl.INPUTS), None, 1,
                                     None) == 1
    assert lib.column_pbl_block_host(8, 1, null, 3, None, 1, None) == 1


# ---------------------- (c): one whole step of host-built bodies against JAX

def _boundaries(seed):
    """Mixed land and sea with orography, snow and sea ice at T10."""
    rng = np.random.default_rng(seed)
    jg = JGeometry(**GEOM)
    jsht = JST(jg, dtype=jnp.float64, zonal="dft")
    jbd = jsynthetic(jg, jsht)
    shape = (jg.nlat, jg.nlon)
    fmask = rng.uniform(0.0, 1.0, shape)
    oro = rng.uniform(0.0, 2.0e4, shape) * fmask
    sice = np.where(rng.uniform(size=(12,) + shape) < 0.3,
                    rng.uniform(0.0, 0.9, (12,) + shape), 0.0)
    jbd = dataclasses.replace(
        jbd, fmask=jnp.asarray(fmask), fmask_l=jnp.asarray(fmask),
        fmask_s=jnp.asarray(1.0 - fmask), phis0=jnp.asarray(oro),
        forog=jnp.asarray(jsflset(oro, 9.81)),
        alb0=jnp.asarray(rng.uniform(0.1, 0.3, shape)),
        snowd12=jnp.asarray(rng.uniform(0.0, 80.0, (12,) + shape)),
        soilw12=jnp.asarray(rng.uniform(0.0, 1.0, (12,) + shape)),
        sice12=jnp.asarray(sice))
    return jg, jsht, jbd


@pytest.fixture(scope="module")
def step_setup():
    jg, jsht, jbd = _boundaries(71)
    jphys = JPhysics(jg, JConst(), dtype=jnp.float64)
    g = Geometry(**GEOM)
    sht = SpectralTransform(g, dtype=torch.float64, device="cpu")
    bd = boundary_from_numpy(jbd, device="cpu", dtype=torch.float64)
    phys = phys_for(torch.float64)
    imon, fmon, tyear = 1, 0.4, 0.12
    sst = np.asarray(jbd.sst12[imon]) + 1.0
    jsfc = jinit_sfc(jbd, jnp.asarray(imon), jnp.asarray(fmon),
                     jnp.asarray(sst), 0.0)
    tsfc = land_sea.init_surface_state(bd, imon, fmon, _t(sst), 0.0)
    jf = jphys.daily_forcing(jbd, jsfc, tyear, jsht)
    tf = phys.daily_forcing(bd, tsfc, tyear, sht)
    assert float(tsfc.sice_am.max()) > 0, "no sea ice"
    return jbd, jphys, jsfc, jf, bd, phys, tsfc, tf


@pytest.mark.parametrize("lradsw", [True, False], ids=["sw", "no_sw"])
def test_host_built_step_matches_jax_compute(lib, step_setup, lradsw,
                                             monkeypatch):
    jbd, jphys, jsfc, jf, bd, phys, tsfc, tf = step_setup
    calls = dict.fromkeys(("K9", "K10a_down_surface", "K10b", "K12",
                           "K13"), 0)

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    lw = phys.lw_tabs
    monkeypatch.setattr(cm, "column_moist_plain", counted(
        "K9", lambda tg, qg, phig, pslg, tabs: host_moist(
            lib, tg, qg, phig, pslg, tabs)))
    monkeypatch.setattr(clw, "down_surface_plain", counted(
        "K10a_down_surface", lambda **kw: host_down_surface(lib, **kw)))
    monkeypatch.setattr(rad, "radlw_up", counted(
        "K10b", lambda *a, **kw: host_up(lib, *a[:-1], lw)))
    monkeypatch.setattr(cpbl, "column_pbl_plain", counted(
        "K12", lambda *a: host_pbl(lib, *a)))
    monkeypatch.setattr(csw, "column_shortwave_plain", counted(
        "K13", lambda *a: host_shortwave(lib, *a)))

    c = make_columns(72)
    rng = np.random.default_rng(73)
    wind = lambda: rng.uniform(-25.0, 25.0, c["tg"].shape)
    args = (wind(), wind(), c["tg"], c["qg"], c["phig"], c["pslg"])
    jcarry = JCarry.zeros(KX, NLAT, NLON, jnp.float64)
    tcarry = RadiationCarry.zeros(KX, NLAT, NLON, torch.float64)
    if not lradsw:
        # a carry with content, as after a shortwave step
        vals = {k: rng.uniform(0.1, 1.0, np.asarray(getattr(jcarry, k)).shape)
                for k in tcarry.__dataclass_fields__}
        jcarry = JCarry(**{k: jnp.asarray(v) for k, v in vals.items()})
        tcarry = RadiationCarry(**{k: _t(v) for k, v in vals.items()})
    jout = jphys.compute(*map(jnp.asarray, args), bd=jbd, sfc=jsfc,
                         forcing=jf, carry=jcarry, lradsw=jnp.asarray(lradsw))
    tout = phys.compute(*map(_t, args), bd=bd, sfc=tsfc, forcing=tf,
                        carry=tcarry, lradsw=lradsw)
    assert calls == dict(K9=1, K10a_down_surface=1, K10b=1, K12=1,
                         K13=int(lradsw))
    for got, ref in zip(tout[:4], jout[:4]):
        _close(got, ref, 1e-10)
    for k in tcarry.__dataclass_fields__:
        _close(getattr(tout[4], k), getattr(jout[4], k), 1e-10)
    for got, ref in zip(tout[5], jout[5]):
        _close(got, ref, 1e-10)
    assert float(np.abs(np.asarray(jout[5].hflux_i)).max()) > 0


# ----------------------------------------- (d): operand checks and tables

def test_wrappers_b2_refuse_bad_operands():
    phys, m, tg, phig = moist(81)
    tau2 = _t(np.random.default_rng(181).uniform(0.05, 1.0,
                                                 (KX, 4, NLAT, NLON)))
    kw = dict(down_surface_args(
        surface_kwargs(81, m.psg, m.qg, tg, phig, "mixed"), tau2),
        lw_tabs=phys.lw_tabs)
    call = lambda **bad: clw.down_surface(**{**kw, **bad},
                                          sfc_tabs=phys.sfc_tabs)
    with pytest.raises(TypeError, match="ta: dtype"):
        call(ta=tg.to(torch.float16))
    with pytest.raises(TypeError, match="tsea: dtype"):
        call(tsea=kw["tsea"].float())
    with pytest.raises(ValueError, match="clat: shape"):
        call(clat=kw["clat"][None])
    with pytest.raises(ValueError, match="ua: shape"):
        call(ua=kw["ua"][0])
    with pytest.raises(ValueError, match="ssrd: must be contiguous"):
        call(ssrd=kw["ssrd"].t().contiguous().t())
    with pytest.raises(ValueError, match="sfc_tabs.blob: shape"):
        clw.down_surface(**kw, sfc_tabs=phys.sfc_tabs._replace(
            blob=phys.sfc_tabs.blob[:-1]))
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="down_surface: no kernel"):
        clw.down_surface(**{k: meta(v) for k, v in kw.items()
                            if torch.is_tensor(v)},
                         lw_tabs=phys.lw_tabs._replace(
                             blob=meta(phys.lw_tabs.blob)),
                         sfc_tabs=phys.sfc_tabs._replace(
                             blob=meta(phys.sfc_tabs.blob)))

    pa = pbl_args(81, phys, m, tg, phig)
    with pytest.raises(TypeError, match="icnv: dtype"):
        cpbl.column_pbl(pa[0]._replace(icnv=m.icnv.int()), *pa[1:],
                        phys.pbl_tabs)
    with pytest.raises(ValueError, match="dfabs_lw: shape"):
        cpbl.column_pbl(*pa[:5], pa[5][0], *pa[6:], phys.pbl_tabs)
    with pytest.raises(TypeError, match="tice: dtype"):
        cpbl.column_pbl(*pa[:6], pa[6].float(), pa[7], phys.pbl_tabs)
    with pytest.raises(TypeError, match="tabs.blob: dtype"):
        cpbl.column_pbl(*pa, phys_for(torch.float32).pbl_tabs)

    sa = shortwave_args(81, phys, m, phig)
    with pytest.raises(TypeError, match="itop: dtype"):
        csw.column_shortwave(sa[0]._replace(itop=m.itop.float()), *sa[1:],
                             phys.sw_tabs)
    with pytest.raises(ValueError, match="zenit: must be contiguous"):
        csw.column_shortwave(*sa[:3], sa[3]._replace(
            zenit=sa[3].zenit[:, :1].expand(NLAT, NLON)), sa[4],
            phys.sw_tabs)
    with pytest.raises(ValueError, match="phig: shape"):
        csw.column_shortwave(sa[0], sa[1][:-1], *sa[2:], phys.sw_tabs)
    with pytest.raises(ValueError, match="column_shortwave: no kernel"):
        ms = sa[0]._replace(**{k: meta(v) for k, v in sa[0]._asdict()
                               .items()})
        csw.column_shortwave(ms, meta(sa[1]), meta(sa[2]),
                             rad.SolarForcing(*map(meta, sa[3])),
                             meta(sa[4]), phys.sw_tabs._replace(
                                 blob=meta(phys.sw_tabs.blob)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_table_blobs_b2_hold_the_plain_versions_tables(dtype):
    """Each blob entry is the Python float (or the model's table value)
    the plain version computes with, cast to the model's dtype.  The
    expected values repeat the formulas of the JAX package's suflux
    (surface.py:40-75), vdifsc (vdiff.py:24-38) and cloud/radsw
    (radiation.py:165-330)."""
    K = KX
    phys = phys_for(dtype)
    c = phys.const
    sig, sigh, dsig = phys.sig, phys.sigh, phys.dsig
    cast = lambda x: torch.tensor([float(v) for v in x],
                                  dtype=torch.float64).to(dtype)
    jp = _jphys()
    esbc = pc.EMISFC * c.sbc
    want = cast([pc.FWIND0, 1.0 / c.cp, -1.0 / (287.0 * 288.0 * jp.sigl_bot),
                 jp.wvi2_bot, 1.0, 0.0, 1.0e5 / 287.0, 25.0, pc.CTDAY,
                 pc.FSTAB / pc.DTHETA, 0.5, pc.DTHETA, pc.CDL, pc.CHL,
                 pc.CHL * c.cp, esbc, 4.0 * esbc, c.alhc, pc.CLAMBDA, 0.0,
                 c.cp, pc.CDS, pc.CHS, pc.CHS * c.cp])
    assert torch.equal(phys.sfc_tabs.blob, want)

    cshc = dsig[K - 1] / 3600.0
    cvdi = (sigh[K - 1] - sigh[1]) / ((K - 2) * 3600.0)
    rsig1 = [1.0 / (1.0 - sigh[k + 1]) for k in range(K - 1)] + [1.0]
    drh0 = [pc.RHGRAD * (sig[k + 1] - sig[k]) for k in range(K - 1)] + [0.0]
    fvdiq2 = [cvdi / pc.TRVDI * sigh[k + 1] for k in range(K - 1)] + [0.0]
    vdon = [float(2 <= k <= K - 3 and sigh[k + 1] > 0.5) for k in range(K)]
    assert sum(vdon) == 2                      # T30L8: the layers 4-5, 5-6
    want = torch.cat([cast(1.0 / dsig), cast(rsig1), phys.grdsig,
                      phys.grdscp, cast(drh0), cast(fvdiq2), cast(vdon),
                      cast([c.alhc, cshc / (pc.TRSHC * c.cp),
                            cshc / pc.TRSHC, 1.0 - pc.REDSHC, pc.SEGRAD,
                            cvdi / (pc.TRVDS * c.cp), pc.ALBSEA - pc.ALBICE,
                            esbc, pc.SSTFR ** 4])])
    blob = phys.pbl_tabs.blob
    assert blob.shape == (cpbl.N_TABLES * K + cpbl.N_SCALARS,)
    assert torch.equal(blob, want)

    abs1 = [pc.ABSDRY + pc.ABSAER * float(s) ** 2 for s in sig]
    want = torch.cat([cast(dsig), cast(abs1), phys.grdscp,
                      cast([pc.RHCL1, 1.0 / (pc.RHCL2 - pc.RHCL1), pc.QACL,
                            86.4, pc.PMAXCL, pc.WPCL,
                            1.0 / (pc.GSE_S1 - pc.GSE_S0), pc.GSE_S0,
                            pc.CLSMAX, 1.2, pc.CLSMINL, pc.ALBCL, pc.ALBCLS,
                            pc.ABSCL1, pc.ABSCL2, pc.ABSDRY, pc.ABSWV1,
                            pc.ABSWV2, 0.95, 0.05, pc.ABLCL2, pc.ABLWIN,
                            pc.ABLCO2, pc.ABLWV1, pc.ABLWV2, pc.ABLCL1,
                            pc.EPSLW / (dsig[0] + dsig[1])])])
    blob = phys.sw_tabs.blob
    assert blob.shape == (csw.N_TABLES * K + csw.N_SCALARS,)
    assert blob.dtype == dtype and blob.is_contiguous()
    assert torch.equal(blob, want)

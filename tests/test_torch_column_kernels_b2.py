"""Port parity of the column kernels K10a_down_surface's surface fluxes
(kernels/column_longwave.py down_surface, with kernels/surface_fluxes.py),
K12 and K12_pbl_flux (kernels/column_pbl.py column_pbl, pbl_flux) and
K9_moist_shortwave's shortwave (kernels/column_shortwave.py, run by
kernels/column_moist.py moist_shortwave).

The plausible random columns of tests/test_torch_column_kernels.py (16 x
32 columns, made from a seed with numpy) and K9's plain outputs on them
go through
  (a) the JAX package's radlw_down followed by suflux, vdifsc + the sums
      of PhysicsModel.compute
      (speedy_ml_tpu/physics/driver.py:258-275, 298-307) and cloud +
      radsw (do_sw, driver.py:221-238), and the port's wrappers and plain
      versions on CPU tensors, float64, 1e-12 of each output's scale;
      the shortwave with the precipitation top iptop forced to 0, 1, an
      interior level and K, and with columns whose cloud top is K;
  (b) the column bodies of the CUDA kernels, compiled for the host with
      g++ from kernels/csrc/column_host.cpp, against the plain versions:
      float64 at 1e-12, float32 within 1e-5 of each output's scale (the
      rule of chip_smoke.column_errors); the buffers are unpacked by the
      wrappers' own `unpack`; K12's block (32 columns x K levels, its
      threads written out as loops) against its per-column body bit for
      bit; and the fused blocks against the first designs run one after
      the other, bit for bit: K9_moist_shortwave's against K9's and then
      K13's per-column bodies, K12_pbl_flux's against K12's and then
      K16's (K = 5, 7, 8, both dtypes, 1 to 100 columns);
  (c) one whole physics step, with and without the shortwave, with and
      without the window's flux sums, through
      PhysicsModel.compute_with_sums with every kernel's CPU route
      replaced by its host-built block or body (K9 or K9_moist_shortwave,
      K10a_down_surface, K10b, K12 or K12_pbl_flux), against the JAX
      package's PhysicsModel.compute and GCM.leapfrog's sums, float64, 1e-10: the wiring between kernels;
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
from speedy_ml_tpu_torch.gcm import FluxAccumulator
from speedy_ml_tpu_torch.convert import boundary_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.core.spectral import SpectralTransform
from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels import column_longwave as clw
from speedy_ml_tpu_torch.kernels import column_moist as cm
from speedy_ml_tpu_torch.kernels import column_pbl as cpbl
from speedy_ml_tpu_torch.kernels import column_shortwave as csw
from speedy_ml_tpu_torch.kernels import surface_fluxes as sf
from speedy_ml_tpu_torch.kernels.flux_accumulate import (FluxTerms,
                                                         flux_accumulate_plain)
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics import land_sea
from speedy_ml_tpu_torch.physics import radiation as rad
from speedy_ml_tpu_torch.physics.driver import RadiationCarry
from test_torch_column_kernels import (GEOM, NGP, NLAT, NLON, _close, _hold,
                                       _plane, _ptrs, _t, down_surface_args,
                                       ds_dict, host_down_surface, host_lib,
                                       host_moist, host_up, jax_down_surface,
                                       make_columns, moist_inputs, phys_for,
                                       sfc_dict, surface_kwargs)
from torch_lane import one_thread_per_pool  # noqa: F401

KX = 8
SOLAR = ((0.0, 420.0), (0.0, 15.0), (0.0, 15.0), (1.0, 4.0), (0.0, 10.0))
RSTEPS, DELT2 = 1.0 / 96, 1800.0   # the window's flux sums' factors


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
    got = csw.column_shortwave_plain(*args, phys.sw_tabs)
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
    d = ctypes.c_double
    # K12 (flux 0) or K12_pbl_flux (flux 1): column_pbl_launch's arguments
    host_lib.column_pbl_host.argtypes = [i, i, i, pp, i, vp, i, vp, d, d]
    host_lib.column_pbl_block_host.argtypes = [i, i, i, pp, i, vp, i, vp, d,
                                               d]
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
    rc = lib.column_pbl_host(K, int(se.dtype == torch.float64), 0,
                             kb.pointer_array(ins), len(ins),
                             args[-1].blob.data_ptr(), nlat * nlon,
                             out.data_ptr(), 0.0, 0.0)
    assert rc == 0
    return cpbl.unpack(out, K)


# the first design's operands (column_shortwave_at), in the order of
# ShortwaveIn (csrc/column_shortwave.cuh): level fields, planes, itop
# (int64)
SW_LEVEL_INPUTS = ("qg", "rh", "se", "phig")
SW_INPUTS = SW_LEVEL_INPUTS + (
    "precnv", "precls", "psg", "rps", "fmask", "fsol", "ozupp", "ozone",
    "zenit", "stratz", "albsfc", "itop")


def shortwave_operands(m, phig, fmask, sol, albsfc, tabs):
    """Validate column_shortwave_at's operands: m.se's floating dtype
    (itop int64), contiguous, on m.se's device.  Returns (K, nlat, nlon,
    the tensors in ShortwaveIn's order)."""
    se = m.se
    K, nlat, nlon = kb.level_dims(se, "m.se")
    named = dict(qg=m.qg, rh=m.rh, se=se, phig=phig, precnv=m.precnv,
                 precls=m.precls, psg=m.psg, rps=m.rps, fmask=fmask,
                 albsfc=albsfc, itop=m.itop, **sol._asdict())
    for nm in SW_INPUTS:
        lev = nm in SW_LEVEL_INPUTS
        kb.require(named[nm], nm, torch.int64 if nm == "itop" else se.dtype,
                   (K, nlat, nlon) if lev else (nlat, nlon), se.device)
    kb.require(tabs.blob, "tabs.blob", se.dtype,
               (csw.N_TABLES * K + csw.N_SCALARS,), se.device)
    return K, nlat, nlon, [named[nm] for nm in SW_INPUTS]


def host_shortwave(lib, *args):
    K, nlat, nlon, ins = shortwave_operands(*args)
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
        assert entry(K, int(dtype == torch.float64), 0,
                     kb.pointer_array(cols), len(cols), blob, ncols,
                     out.data_ptr(), 0.0, 0.0) == 0
        outs.append(out)
    ref, got = outs
    assert not got.isnan().any()
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def host_moist_shortwave_buffers(lib, tg, qg, phig, pslg, tabs, sw,
                                 block=True):
    """K9_moist_shortwave built for the host: its block (32 columns x K
    warps), or (block=False) K9's per-column body over every column and
    then K13's on its outputs, the first designs in a row.  Returns the
    buffers (out (6K + 5, ...), out_i (2, ...), the shortwave's (5K + 5,
    ...)), which start as NaN and -99."""
    K, nlat, nlon = tg.shape
    out = torch.full((cm.N_LEVEL_FIELDS * K + cm.N_PLANES, nlat, nlon),
                     float("nan"), dtype=tg.dtype)
    out_i = torch.full((2, nlat, nlon), -99, dtype=torch.int64)
    sw_out = torch.full((5 * K + 5, nlat, nlon), float("nan"),
                        dtype=tg.dtype)
    planes = csw.forcing_planes(sw, K, nlat, nlon, tg.dtype, tg.device)
    head = (K, int(tg.dtype == torch.float64),
            *_ptrs(tg, qg, phig, pslg, tabs.blob), nlat * nlon,
            *_ptrs(out, out_i))
    tail = (kb.pointer_array(planes), len(planes), sw.tabs.blob.data_ptr(),
            sw_out.data_ptr())
    if block:
        rc = lib.column_moist_block_host(*head, 1, *tail)
    else:
        rc = lib.moist_shortwave_host(*head, *tail)
    assert rc == 0
    return out, out_i, sw_out


def host_moist_shortwave(lib, tg, qg, phig, pslg, tabs, sw):
    """K9_moist_shortwave's block built for the host, as moist_shortwave
    returns: (MoistColumns, (tau2, stratc, tt_rsw, ssrd, ssr, tsr))."""
    out, out_i, sw_out = host_moist_shortwave_buffers(lib, tg, qg, phig,
                                                      pslg, tabs, sw)
    K = tg.shape[0]
    return cm.unpack(out, out_i, K), csw.unpack(sw_out, K)


def moist_shortwave_case(seed, K, ncols, dtype):
    """K9_moist_shortwave's operands on `ncols` of the random columns, in
    one latitude row: a quarter of them with a dry PBL top (q at level
    K-2 and at 2..K-3 scaled down, so that no level is cloudy there), the
    cloud tops and itop K9 makes of the data; a ShortwaveForcing's planes
    from the seed.  Returns (PhysicsModel, (tg, qg, phig, pslg), the
    ShortwaveForcing)."""
    phys = phys_for(dtype, K)
    c = make_columns(seed, K)
    rng = np.random.default_rng(seed + 5)
    dry = rng.uniform(size=NGP) < 0.25
    q = c["qg"].reshape(K, NGP).copy()
    q[K - 2, dry] *= 0.2
    q[2:K - 2, dry] *= 0.25
    row = lambda a: _t(np.ascontiguousarray(
        a.reshape(-1, NGP)[:, :ncols]), dtype).reshape(-1, 1, ncols)
    args = (row(c["tg"]), row(q), row(c["phig"]), row(c["pslg"])[0])
    plane = lambda lo, hi: _t(rng.uniform(lo, hi, (1, ncols)), dtype)
    sol = rad.SolarForcing(*(plane(lo, hi) for lo, hi in SOLAR))
    sw = csw.ShortwaveForcing(fmask=plane(0.0, 1.0), sol=sol,
                              albsfc=plane(0.05, 0.6), tabs=phys.sw_tabs)
    return phys, args, sw


@pytest.mark.parametrize("ncols", [1, 31, 33, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("K", [5, 7, 8])
def test_host_moist_shortwave_block_matches_column_bodies(lib, K, dtype,
                                                          ncols):
    """K9_moist_shortwave's block (K9's four phases; then the clouds on
    warp 0, each level's transmissivities and tau2 on its warp, the fluxes
    on warp 0; handed on through shared memory and registers that start
    as NaN) gives K9's per-column body followed by K13's, the first
    designs in a row, bit for bit, every plane of its three buffers; 1,
    31, 33 and 100 columns leave the last block partly empty.  In float64
    the shortwave's planes also hold the plain version's values
    (1e-12)."""
    phys, args, sw = moist_shortwave_case(800 + 10 * K + ncols, K, ncols,
                                          dtype)
    tabs = phys.moist_tabs
    ref = host_moist_shortwave_buffers(lib, *args, tabs, sw, block=False)
    got = host_moist_shortwave_buffers(lib, *args, tabs, sw)
    for name, a, b in zip(("out", "out_i", "shortwave"), got, ref):
        assert not a.to(torch.float64).isnan().any(), name
        assert (a != -99).all(), name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    rh = cm.unpack(got[0], got[1], K).rh[K - 2]
    if ncols > 1:   # cloudy and dry PBL tops both
        assert (rh > pc.RHCL1).any() and (rh < pc.RHCL1).any()
    if dtype == torch.float64:
        m, sw_ref = cm.moist_shortwave_plain(*args, tabs, sw)
        _hold(dict(zip(SW_OUT, csw.unpack(got[2], K))),
              dict(zip(SW_OUT, sw_ref)), dtype)


def host_pbl_flux(lib, *args, block=True):
    """K12_pbl_flux built for the host, as pbl_flux returns (utend,
    vtend, ttend, qtend, hflux_i, the new accumulator): its block, or
    (block=False) K12's per-column body over every column and then the
    flux sums (K16's first design) over every column.  args: pbl_flux's
    operands."""
    *pa, fluxes, rsteps, delt2 = args
    K, nlat, nlon, ins = cpbl.operands(*pa)
    m = pa[0]
    ins += cpbl.flux_operands(m, pa[2], fluxes, (nlat, nlon), m.se.dtype,
                              m.se.device)
    out = _out(4 * K + 5, m.se)
    entry = lib.column_pbl_block_host if block else lib.column_pbl_host
    assert entry(K, int(m.se.dtype == torch.float64), 1,
                 kb.pointer_array(ins), len(ins), pa[-1].blob.data_ptr(),
                 nlat * nlon, out.data_ptr(), rsteps, delt2) == 0
    return cpbl.unpack(out, K) + (type(fluxes)(*out[4 * K + 1:]),)


def flux_sums(seed, dtype, shape=(NLAT, NLON)):
    """A FluxAccumulator of plausible magnitudes, from the seed."""
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: _t(rng.uniform(lo, hi, shape), dtype)
    return FluxAccumulator(hflux_l=f(-50, 150), hflux_s=f(-50, 300),
                           hflux_i=f(-20, 80), precip=f(0, 4e3))


FLUX_OUT = ("hflux_l", "hflux_s", "hflux_i", "precip")


@pytest.mark.parametrize("ncols", [1, 31, 33, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("K", [5, 7, 8])
def test_host_pbl_flux_block_matches_bodies(lib, K, dtype, ncols):
    """K12_pbl_flux's block (K12's, with warp 1 forming the four flux
    sums beside hflux_i) gives K12's per-column body followed by the flux
    sums of K16's first design, bit for bit, every plane; and the sums
    the plain version's values (pbl_flux_plain)."""
    seed = 600 + 10 * K + ncols
    phys, m, tg, phig = moist(seed, dtype, K)
    pa = pbl_args(seed, phys, m, tg, phig) + (phys.pbl_tabs,)
    fluxes = flux_sums(seed, dtype)
    # the operands on their first `ncols` columns, as one latitude row
    cols = lambda t: t.reshape(*t.shape[:-2], -1)[..., :ncols] \
        .reshape(*t.shape[:-2], 1, ncols).contiguous()
    pick = lambda o: type(o)(*[cols(v) if torch.is_tensor(v) else
                              tuple(map(cols, v)) for v in o])
    args = (pick(m), cols(phig), pick(pa[2]), *map(cols, pa[3:8]), pa[8],
            FluxAccumulator(*map(cols, dataclasses.astuple(fluxes))),
            RSTEPS, DELT2)
    ref = host_pbl_flux(lib, *args, block=False)
    got = host_pbl_flux(lib, *args)
    for name, a, b in zip(PBL_OUT + ("fluxes",), got, ref):
        for x, y in ([(a, b)] if torch.is_tensor(a) else
                     zip(dataclasses.astuple(a), dataclasses.astuple(b))):
            assert not x.isnan().any(), name
            np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                          err_msg=name)
    want = cpbl.pbl_flux_plain(*args)[5]
    _hold(dict(zip(FLUX_OUT, dataclasses.astuple(got[5]))),
          dict(zip(FLUX_OUT, dataclasses.astuple(want))), dtype)


@pytest.mark.parametrize("K", [5, 7])
def test_host_columns_b2_at_other_level_counts(lib, K):
    """The bodies are templates on K; 5 and 7 levels are compiled too."""
    _check_three(lib, 62, torch.float64, K)
    null = ctypes.POINTER(ctypes.c_void_p)()
    n_in = len(cpbl.INPUTS)
    for entry in (lib.column_pbl_host, lib.column_pbl_block_host):
        assert entry(6, 1, 0, null, n_in, None, 1, None, 0.0, 0.0) == 1
        assert entry(8, 1, 0, null, 3, None, 1, None, 0.0, 0.0) == 1
        # the flux sums' seven operands must follow K12's
        assert entry(8, 1, 1, null, n_in, None, 1, None, 0.0, 0.0) == 1
    assert lib.moist_shortwave_host(8, 1, *[None] * 5, 1, None, None, null,
                                    3, None, None) == 1


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


@pytest.mark.parametrize("sums", [False, True], ids=["no_sums", "sums"])
@pytest.mark.parametrize("lradsw", [True, False], ids=["sw", "no_sw"])
def test_host_built_step_matches_jax_compute(lib, step_setup, lradsw, sums,
                                             monkeypatch):
    """A physics step with every kernel's CPU route replaced by its
    host-built block or body: K9 or, with the shortwave, K9_moist_shortwave;
    K10a_down_surface; K10b; K12 or, with the window's flux sums (a
    leapfrog step), K12_pbl_flux; one of each, against the JAX package's
    PhysicsModel.compute and GCM.leapfrog's sums (gcm.py:273-280)."""
    jbd, jphys, jsfc, jf, bd, phys, tsfc, tf = step_setup
    calls = dict.fromkeys(("K9", "K9_moist_shortwave", "K10a_down_surface",
                           "K10b", "K12", "K12_pbl_flux"), 0)

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    lw = phys.lw_tabs
    monkeypatch.setattr(cm, "column_moist_plain", counted(
        "K9", lambda tg, qg, phig, pslg, tabs: host_moist(
            lib, tg, qg, phig, pslg, tabs, block=True)))
    monkeypatch.setattr(cm, "moist_shortwave_plain", counted(
        "K9_moist_shortwave", lambda *a: host_moist_shortwave(lib, *a)))
    monkeypatch.setattr(clw, "down_surface_plain", counted(
        "K10a_down_surface", lambda **kw: host_down_surface(lib, **kw)))
    monkeypatch.setattr(rad, "radlw_up", counted(
        "K10b", lambda *a, **kw: host_up(lib, *a[:-1], lw)))
    monkeypatch.setattr(cpbl, "column_pbl_plain", counted(
        "K12", lambda *a: host_pbl(lib, *a)))
    monkeypatch.setattr(cpbl, "pbl_flux_plain", counted(
        "K12_pbl_flux", lambda *a: host_pbl_flux(lib, *a)))

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
    fluxes = flux_sums(74, torch.float64)
    jout = jphys.compute(*map(jnp.asarray, args), bd=jbd, sfc=jsfc,
                         forcing=jf, carry=jcarry, lradsw=jnp.asarray(lradsw))
    tout = phys.compute_with_sums(
        *map(_t, args), bd=bd, sfc=tsfc, forcing=tf, carry=tcarry,
        lradsw=lradsw, sums=(fluxes, RSTEPS, DELT2) if sums else None)
    assert calls == dict(K9=int(not lradsw), K9_moist_shortwave=int(lradsw),
                         K10a_down_surface=1, K10b=1, K12=int(not sums),
                         K12_pbl_flux=int(sums))
    assert len(tout) == 7 and (tout[6] is None) == (not sums)
    for got, ref in zip(tout[:4], jout[:4]):
        _close(got, ref, 1e-10)
    for k in tcarry.__dataclass_fields__:
        _close(getattr(tout[4], k), getattr(jout[4], k), 1e-10)
    for got, ref in zip(tout[5], jout[5]):
        _close(got, ref, 1e-10)
    assert float(np.abs(np.asarray(jout[5].hflux_i)).max()) > 0
    if sums:
        # GCM.leapfrog's sums of the JAX package on its own diagnostics
        d, fx = jout[5], {k: _j(v) for k, v in vars(fluxes).items()}
        want = dict(hflux_l=fx["hflux_l"] + d.hflux_l * RSTEPS,
                    hflux_s=fx["hflux_s"] + d.hflux_s * RSTEPS,
                    hflux_i=fx["hflux_i"] + d.hflux_i * RSTEPS,
                    precip=fx["precip"] + (d.precnv + d.precls) * DELT2
                    / 2.0)
        for k, ref in want.items():
            _close(getattr(tout[6], k), ref, 1e-10)


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

    fl = flux_sums(82, torch.float64)
    with pytest.raises(TypeError, match="acc_precip: dtype"):
        cpbl.pbl_flux(*pa, phys.pbl_tabs, dataclasses.replace(
            fl, precip=fl.precip.float()), RSTEPS, DELT2)
    with pytest.raises(ValueError, match="acc_hflux_i: shape"):
        cpbl.pbl_flux(*pa, phys.pbl_tabs, dataclasses.replace(
            fl, hflux_i=fl.hflux_i[:-1]), RSTEPS, DELT2)
    with pytest.raises(ValueError, match="pbl_flux: no kernel"):
        cpbl.pbl_flux(pa[0]._replace(**{k: meta(v) for k, v in
                                        pa[0]._asdict().items()}),
                      meta(pa[1]), type(pa[2])(*[
                          meta(v) if torch.is_tensor(v) else
                          tuple(map(meta, v)) for v in pa[2]]),
                      *map(meta, pa[3:]),
                      phys.pbl_tabs._replace(blob=meta(phys.pbl_tabs.blob)),
                      FluxAccumulator(*map(meta, dataclasses.astuple(fl))),
                      RSTEPS, DELT2)

    sa = shortwave_args(81, phys, m, phig)
    sw = csw.ShortwaveForcing(fmask=sa[2], sol=sa[3], albsfc=sa[4],
                              tabs=phys.sw_tabs)
    mi = moist_inputs(81)
    with pytest.raises(ValueError, match="zenit: must be contiguous"):
        cm.moist_shortwave(*mi, phys.moist_tabs, sw._replace(
            sol=sa[3]._replace(zenit=sa[3].zenit[:, :1].expand(NLAT,
                                                                NLON))))
    with pytest.raises(ValueError, match="fmask: shape"):
        cm.moist_shortwave(*mi, phys.moist_tabs,
                           sw._replace(fmask=sa[2][:-1]))
    with pytest.raises(TypeError, match="albsfc: dtype"):
        cm.moist_shortwave(*mi, phys.moist_tabs,
                           sw._replace(albsfc=sa[4].float()))
    with pytest.raises(TypeError, match="sw.tabs.blob: dtype"):
        cm.moist_shortwave(*mi, phys.moist_tabs, sw._replace(
            tabs=phys_for(torch.float32).sw_tabs))
    with pytest.raises(ValueError, match="moist_shortwave: no kernel"):
        cm.moist_shortwave(*map(meta, mi), phys.moist_tabs._replace(
            blob=meta(phys.moist_tabs.blob)), csw.ShortwaveForcing(
                meta(sa[2]), rad.SolarForcing(*map(meta, sa[3])),
                meta(sa[4]), phys.sw_tabs._replace(
                    blob=meta(phys.sw_tabs.blob))))


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

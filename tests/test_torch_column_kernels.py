"""Port parity of the column kernels K9 (kernels/column_moist.py) and K10
(kernels/column_longwave.py: K10a_down_surface, the downward longwave
with the surface fluxes, and K10b, the upward longwave).

The same plausible random columns (the generator of
tests/test_torch_physics.py at 16 x 32 columns, made from a seed with
numpy) go through
  (a) the JAX package's prologue + qsat_from_t + convmf + lscond
      (speedy_ml_tpu/physics/driver.py:192-216) and `column_moist` on CPU
      tensors (its plain version), float64, 1e-12 of each output's scale,
      itop and icnv equal;
  (b) the JAX package's radlw_down, then suflux on its slrd, and
      radlw_up, on a tau2 from its radsw, and the `column_longwave`
      wrappers (down_surface, radlw_up), float64, 1e-12;
  (c) the column bodies of the CUDA kernels themselves, compiled for the
      host with g++ from kernels/csrc/column_host.cpp (the very headers
      the kernels include), against the plain versions: float64 at 1e-12
      with the integers equal; float32 under the rule of chip_smoke.py
      (chip_smoke.column_errors: columns whose itop/icnv differ at most
      0.5 %, the others within 1e-5 of each output's scale); and K9's
      block, its threads written out as loops, against the per-column
      body bit for bit, and K10a_down_surface's and K10b's blocks against
      their phases run a column at a time (K = 5, 7, 8, both dtypes, 1 to
      100 columns, an aquaplanet and a mixed land mask).
The wrappers' operand checks and the table buffers are tested too.  The
launch code itself runs only on a card (chip_smoke.py).
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.constants import PhysicalConstants as JConst
from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.physics import radiation as jrad
from speedy_ml_tpu.physics.condensation import lscond as jlscond
from speedy_ml_tpu.physics.convection import convmf as jconvmf
from speedy_ml_tpu.physics.driver import PhysicsModel as JPhysics
from speedy_ml_tpu.physics.humidity import qsat_from_t as jqsat
from speedy_ml_tpu.physics.surface import suflux as jsuflux
from speedy_ml_tpu_torch.core.constants import PhysicalConstants
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels import column_longwave as clw
from speedy_ml_tpu_torch.kernels import column_moist as cm
from speedy_ml_tpu_torch.kernels import surface_fluxes as sf
from speedy_ml_tpu_torch.physics import constants as pc
from speedy_ml_tpu_torch.physics import radiation as rad
from speedy_ml_tpu_torch.physics.driver import PhysicsModel

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
sys.path.insert(0, str(REPO))
from chip_smoke import column_errors  # noqa: E402  (the card check's rule)
from torch_lane import one_thread_per_pool  # noqa: E402, F401

NLAT, NLON = 16, 32
NGP = NLAT * NLON
GEOM = dict(trunc=10, nlon=NLON, nlat=NLAT)
# float32, of each output's scale over the columns that agree: the host
# libm's expf is not the vectorized exp of PyTorch's CPU kernels (measured
# here: 1.2e-6 on ttend); on a card both sides call the same expf and
# chip_smoke.py holds the kernels tighter
F32_RTOL = 1e-5
MAX_FLIPPED = 0.005      # share of columns whose itop/icnv may differ
INTS = ("itop", "icnv")


# ------------------------------------------------------------------ inputs

def make_columns(seed, K=8):
    """Physically plausible random columns as (K, NLAT, NLON) grids: a
    stable-ish T profile, q in (-0.02, 1.2) * qsat (the clamp at 0 has
    work to do), psa around 1 with some columns below PSMIN."""
    rng = np.random.default_rng(seed)
    hsg = np.asarray(JGeometry(nlev=K, **GEOM).half_sigma, dtype=np.float64)
    sig = 0.5 * (hsg[1:] + hsg[:-1])
    psa = rng.uniform(0.72, 1.05, NGP)
    tsfc = rng.uniform(255.0, 310.0, NGP)
    ta = np.stack([tsfc - 62.0 * (1.0 - sig[k]) + rng.normal(0, 4.0, NGP)
                   for k in range(K)])
    ta = np.clip(ta, 180.0, 320.0)
    qsat = np.stack([np.asarray(jqsat(jnp.asarray(ta[k]),
                                      sig[k] * jnp.asarray(psa)))
                     for k in range(K)])
    rh = rng.uniform(-0.02, 1.2, (K, NGP))
    rh[-2:] = rng.uniform(0.55, 1.1, (2, NGP))   # moist PBL
    phi = np.zeros((K, NGP))
    phi[K - 1] = 287.0 * ta[K - 1] * (1.0 - sig[K - 1])
    for k in range(K - 2, -1, -1):
        phi[k] = phi[k + 1] + 287.0 * 0.5 * (ta[k] + ta[k + 1]) \
            * np.log(sig[k + 1] / sig[k])
    grid = lambda a: np.ascontiguousarray(a.reshape(-1, NLAT, NLON))
    return dict(tg=grid(ta), qg=grid(rh * qsat), phig=grid(phi),
                pslg=np.log(psa).reshape(NLAT, NLON))


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a, dtype=np.float64)).to(dtype)


def _close(got, ref, rtol=1e-12):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, f"err {err:.3e}, scale {scale:.3e}"


def phys_for(dtype, K=8):
    return PhysicsModel(Geometry(nlev=K, **GEOM), PhysicalConstants(),
                        dtype=dtype, device="cpu")


def moist_inputs(seed, dtype=torch.float64, K=8):
    c = make_columns(seed, K)
    return [_t(c[k], dtype) for k in ("tg", "qg", "phig", "pslg")]


def jax_moist(jphys, tg, qg, phig, pslg):
    """PhysicsModel.compute of the JAX package, lines 192-214."""
    c = jphys.const
    K = tg.shape[0]
    sig, dsig = jphys.sig, jphys.dsig
    psg = jnp.exp(pslg)
    rps = 1.0 / psg
    qg = jnp.maximum(qg, 0.0)
    se = c.cp * tg + phig
    qsat = jqsat(tg, sig[:, None, None] * psg[None])
    rh = qg / qsat
    itop, cbmf, precnv, dfse, dfqa = jconvmf(
        psg, se, qg, qsat, sig=sig, dsig=dsig, wvi2=jnp.asarray(jphys.wvi2),
        p0=c.p0, grav=c.grav, alhc=c.alhc)
    tt_cnv = dfse * rps[None] * jphys.grdscp[:, None, None]
    qt_cnv = dfqa * rps[None] * jphys.grdsig[:, None, None]
    icnv = (K - 1) - itop
    itop, precls, tt_lsc, qt_lsc = jlscond(
        psg, qg, qsat, itop, sig=sig, dsig=dsig, p0=c.p0, grav=c.grav,
        cp=c.cp, alhc=c.alhc)
    return dict(psg=psg, rps=rps, qg=qg, se=se, qsat=qsat, rh=rh, itop=itop,
                icnv=icnv, cbmf=cbmf, precnv=precnv, precls=precls,
                ttend=tt_cnv + tt_lsc, qtend=qt_cnv + qt_lsc)


def longwave_inputs(seed, dtype=torch.float64):
    """(ta, tau2, stratc, ts, slru_sfc) with tau2 and stratc from the JAX
    package's cloud + radsw on the same columns."""
    c = make_columns(seed)
    rng = np.random.default_rng(seed + 100)
    jphys = JPhysics(JGeometry(**GEOM), JConst(), dtype=jnp.float64)
    m = jax_moist(jphys, *(jnp.asarray(c[k])
                           for k in ("tg", "qg", "phig", "pslg")))
    plane = lambda lo, hi: rng.uniform(lo, hi, (NLAT, NLON))
    jc = jrad.cloud(m["qg"], m["rh"], m["precnv"], m["precls"], m["itop"],
                    jnp.asarray(plane(0.0, 0.6)),
                    jnp.asarray(plane(0.0, 1.0)))
    sol = jrad.SolarForcing(*(jnp.asarray(plane(lo, hi)) for lo, hi in (
        (0.0, 420.0), (0.0, 15.0), (0.0, 15.0), (1.0, 4.0), (0.0, 10.0))))
    jsw = jrad.radsw(m["psg"], m["qg"], *jc, sol,
                     jnp.asarray(plane(0.05, 0.6)), sig=jphys.sig,
                     dsig=jphys.dsig)
    ts = plane(230.0, 310.0)
    # some temperatures on a half: the band table rounds half to even
    ta = c["tg"].copy()
    ta[:, 0] = np.floor(ta[:, 0]) + 0.5
    ts[0] = np.floor(ts[0]) + 0.5
    slru = 0.98 * 5.67e-8 * ts ** 4
    return [_t(a, dtype) for a in (ta, jsw[4], jsw[5], ts, slru)]


def _plane(rng, lo, hi):
    return rng.uniform(lo, hi, (NLAT, NLON))


def surface_kwargs(seed, psg, qa, tg, phig, mask, dtype=torch.float64):
    """suflux's operands around the columns (psg, qa from K9): winds, a
    land fraction ("sea", "land" or "mixed"), surface state and forcing
    planes, a random slrd; a quarter of the columns has dry soil
    (evaporation 0 over land)."""
    rng = np.random.default_rng(seed)
    K = tg.shape[0]
    fmask = dict(sea=np.zeros, land=np.ones)[mask]((NLAT, NLON)) \
        if mask != "mixed" else _plane(rng, 0.0, 1.0)
    swav = _plane(rng, 0.0, 1.0)
    swav[rng.uniform(size=swav.shape) < 0.25] = 0.0
    planes = dict(phi0=_plane(rng, 0.0, 3.0e4), fmask=fmask,
                  tland=_plane(rng, 250.0, 315.0),
                  tsea=_plane(rng, 271.0, 304.0), swav=swav,
                  ssrd=_plane(rng, 0.0, 400.0), slrd=_plane(rng, 100.0, 450.0),
                  forog=_plane(rng, 1.0, 1.5), alb_l=_plane(rng, 0.05, 0.7),
                  alb_s=_plane(rng, 0.06, 0.5), snowc=_plane(rng, 0.0, 1.0))
    kw = {k: _t(v, dtype) for k, v in planes.items()}
    kw["clat"] = _t(np.cos(np.linspace(-1.3, 1.3, NLAT)), dtype)
    wind = lambda: _t(rng.uniform(-30.0, 30.0, (K, NLAT, NLON)), dtype)
    return dict(psg=psg, ua=wind(), va=wind(), ta=tg, qa=qa, phi=phig,
                **kw)


def down_surface_args(kw, tau2):
    """down_surface's operands: suflux's (surface_kwargs) but slrd, which
    the kernel forms itself, and tau2."""
    return dict({k: v for k, v in kw.items() if k != "slrd"}, tau2=tau2)


def down_plain(ta, tau2, tabs):
    """The plain downward pass (physics/radiation.py radlw_down)."""
    return rad.radlw_down(ta, tau2, tabs.fband, wvi2=tabs.wvi2,
                          dsig=tabs.dsig, sbc=tabs.sbc)


def down_dict(out):
    slrd, dfabs, flux, (mean, grad) = out
    return dict(slrd=slrd, dfabs=dfabs, flux_bands=flux, st4a_mean=mean,
                st4a_grad=grad)


def sfc_dict(fx):
    """SurfaceFluxes as name -> plane, its (land, sea, blend) tuples
    spread out (ustr0, ustr1, ustr2, ...)."""
    out = {}
    for name, v in fx._asdict().items():
        if isinstance(v, tuple):
            out.update({f"{name}{i}": x for i, x in enumerate(v)})
        else:
            out[name] = v
    return out


def ds_dict(out):
    """down_surface's ((slrd, ...), SurfaceFluxes) as one dict."""
    return {**down_dict(out[0]), **sfc_dict(out[1])}


def up_dict(out):
    return dict(zip(("slr", "olr", "dfabs"), out))


# ------------------------------------------- (a), (b): against the JAX code

@pytest.mark.parametrize("seed", [11, 12])
def test_column_moist_matches_jax(seed):
    tphys = phys_for(torch.float64)
    jphys = JPhysics(JGeometry(**GEOM), JConst(), dtype=jnp.float64)
    args = moist_inputs(seed)
    before = cm.column_moist.launches
    got = cm.column_moist(*args, tphys.moist_tabs)
    assert cm.column_moist.launches == before   # the CPU route counts nothing
    ref = jax_moist(jphys, *(jnp.asarray(a.numpy()) for a in args))
    K = args[0].shape[0]
    assert (np.asarray(ref["icnv"]) >= 0).any(), "no column convects"
    assert (np.asarray(ref["icnv"]) < 0).any(), "every column convects"
    assert (np.asarray(ref["precls"]) > 0).any(), "no column condenses"
    assert (np.asarray(ref["itop"]) < K - 1 - np.asarray(ref["icnv"])).any(), \
        "lscond lowers no column's itop"
    assert float(args[1].min()) < 0 and float(got.qg.min()) == 0
    for name in INTS:
        assert getattr(got, name).dtype == torch.int64
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(ref[name]))
    for name in got._fields:
        if name not in INTS:
            _close(getattr(got, name), ref[name])


def jax_down_surface(jphys, kw, tau2):
    """The JAX package's radlw_down, then suflux on its slrd."""
    j = lambda a: jnp.asarray(a.numpy())
    c = jphys.const
    jd = jrad.radlw_down(j(kw["ta"]), j(tau2), jphys.fband, wvi2=jphys.wvi2,
                         dsig=jphys.dsig, sbc=c.sbc)
    planes = {k: j(kw[k]) for k in clw.SURFACE_PLANES}
    jfx = jsuflux(j(kw["psg"]), j(kw["ua"]), j(kw["va"]), j(kw["ta"]),
                  j(kw["qa"]), None, j(kw["phi"]), slrd=jd[0], **planes,
                  clat_row=j(kw["clat"]), sigl_bot=jphys.sigl_bot,
                  wvi2_bot=jphys.wvi2_bot, rd=287.0, cp=c.cp, alhc=c.alhc,
                  sbc=c.sbc)
    return jd, jfx


@pytest.mark.parametrize("seed", [13, 14])
def test_column_longwave_matches_jax(seed):
    tphys = phys_for(torch.float64)
    ta, tau2, stratc, ts, slru = longwave_inputs(seed)
    c = make_columns(seed)
    kw = surface_kwargs(seed, _t(np.exp(c["pslg"])),
                        _t(np.maximum(c["qg"], 0.0)), ta, _t(c["phig"]),
                        "mixed")
    jphys = JPhysics(JGeometry(**GEOM), JConst(), dtype=jnp.float64)
    j = lambda a: jnp.asarray(a.numpy())
    before = (clw.down_surface.launches, clw.radlw_up.launches)
    td, tfx = clw.down_surface(**down_surface_args(kw, tau2),
                               lw_tabs=tphys.lw_tabs, sfc_tabs=tphys.sfc_tabs)
    jd, jfx = jax_down_surface(jphys, kw, tau2)
    for got, ref in zip(td[:3], jd[:3]):
        _close(got, ref)
    for got, ref in zip(td[3], jd[3]):
        _close(got, ref)
    for nm, ref in sfc_dict(jfx).items():
        _close(sfc_dict(tfx)[nm], ref)
    tu = clw.radlw_up(ta, ts, td[0], slru, td[1], td[2], td[3], tau2, stratc,
                      tphys.lw_tabs)
    ju = jrad.radlw_up(j(ta), j(ts), jd[0], j(slru), jd[1], jd[2], jd[3],
                       j(tau2), j(stratc), jphys.fband, dsig=jphys.dsig,
                       sbc=jphys.const.sbc)
    for got, ref in zip(tu, ju):
        _close(got, ref)
    assert (clw.down_surface.launches, clw.radlw_up.launches) == before
    assert float(tu[1].min()) > 50.0, "olr is not a flux"


# -------------------------- (c): the kernels' column bodies, built for the host

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/column_host.cpp built with g++ and loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the column bodies for the host")
    so = tmp_path_factory.mktemp("column_host") / "libcolumn_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    str(CSRC / "column_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, n_ptr_in in (("column_moist_host", 5),
                           ("radlw_up_host", 11),
                           ("radlw_up_block_host", 11)):
        fn = getattr(lib, name)
        n_out = 2 if name.startswith("column_moist") else 1
        fn.argtypes = [i, i] + [vp] * n_ptr_in + [i] + [vp] * n_out
        fn.restype = i
    # K9's block (shortwave 0) and K9_moist_shortwave's (1), and K9 then
    # K13 over every column: K9's operands, then the shortwave's planes,
    # tables and output
    sw = [ctypes.POINTER(vp), i, vp, vp]
    lib.column_moist_block_host.argtypes = \
        [i, i] + [vp] * 5 + [i, vp, vp, i] + sw
    lib.moist_shortwave_host.argtypes = [i, i] + [vp] * 5 + [i, vp, vp] + sw
    for fn in (lib.column_moist_block_host, lib.moist_shortwave_host):
        fn.restype = i
    for name in ("down_surface_host", "down_surface_block_host"):
        fn = getattr(lib, name)
        fn.argtypes = [i, i, ctypes.POINTER(vp), i, vp, vp, i, i, vp]
        fn.restype = i
    return lib


def _ptrs(*tensors):
    for t in tensors:
        assert t.is_contiguous() and t.device.type == "cpu"
    return [t.data_ptr() for t in tensors]


def host_moist(lib, tg, qg, phig, pslg, tabs, block=False):
    """K9 built for the host: the first design's per-column loop, or
    (block) the kernel's block of 32 columns x K warps."""
    K, nlat, nlon = tg.shape
    out = torch.full((cm.N_LEVEL_FIELDS * K + cm.N_PLANES, nlat, nlon),
                     float("nan"), dtype=tg.dtype)
    out_i = torch.full((2, nlat, nlon), -99, dtype=torch.int64)
    args = (K, int(tg.dtype == torch.float64),
            *_ptrs(tg, qg, phig, pslg, tabs.blob), nlat * nlon,
            *_ptrs(out, out_i))
    if block:
        rc = lib.column_moist_block_host(*args, 0, None, 0, None, None)
    else:
        rc = lib.column_moist_host(*args)
    assert rc == 0
    return cm.unpack(out, out_i, K)


def host_down_surface_buffer(lib, *, lw_tabs, sfc_tabs, block=False,
                             **named):
    """K10a_down_surface built for the host: its phases run a column at a
    time (down_surface_at, C = 1), or (block) the kernel's block of 32
    columns x K warps.  named: down_surface's operands.  Returns the
    output buffer (3K + 28, lat, lon)."""
    ta = named["ta"]
    K, nlat, nlon = ta.shape
    ins = [named[nm] for nm in clw.INPUTS]
    _ptrs(*ins)
    out = torch.full((3 * K + 5 + sf.N_PLANES, nlat, nlon), float("nan"),
                     dtype=ta.dtype)
    entry = lib.down_surface_block_host if block else lib.down_surface_host
    rc = entry(K, int(ta.dtype == torch.float64), kb.pointer_array(ins),
               len(ins), lw_tabs.blob.data_ptr(), sfc_tabs.blob.data_ptr(),
               nlat * nlon, nlon, out.data_ptr())
    assert rc == 0
    return out


def host_down_surface(lib, **kw):
    """host_down_surface_buffer as down_surface's ((slrd, ...),
    SurfaceFluxes)."""
    return clw.unpack_down_surface(host_down_surface_buffer(lib, **kw),
                                   kw["ta"].shape[0])


def host_up(lib, ta, ts, slrd, slru, dfabs, flux, st4a, tau2, stratc, tabs):
    K, nlat, nlon = ta.shape
    out = torch.full((K + 2, nlat, nlon), float("nan"), dtype=ta.dtype)
    rc = lib.radlw_up_host(
        K, int(ta.dtype == torch.float64),
        *_ptrs(ta, ts, slrd, slru, dfabs, flux, st4a[0], st4a[1], tau2,
               stratc, tabs.blob), nlat * nlon, *_ptrs(out))
    assert rc == 0
    return out[0], out[1], out[2:]


def host_up_block(lib, ta, ts, slrd, slru, dfabs, flux, st4a, tau2, stratc,
                  tabs):
    """K10b's block (32 columns x K warps) built for the host: (slr, olr,
    dfabs) as host_up's."""
    K, nlat, nlon = ta.shape
    out = torch.full((K + 2, nlat, nlon), float("nan"), dtype=ta.dtype)
    rc = lib.radlw_up_block_host(
        K, int(ta.dtype == torch.float64),
        *_ptrs(ta, ts, slrd, slru, dfabs, flux, st4a[0], st4a[1], tau2,
               stratc, tabs.blob), nlat * nlon, *_ptrs(out))
    assert rc == 0
    return out[0], out[1], out[2:]


def up_block_case(seed, K, ncols, surface, dtype):
    """radlw_up's operands on one row of `ncols` columns: a lapse-rate
    profile with noise (some temperatures on a half, where the band table
    rounds half to even), tau2 in (0.05, 1), stratc in (0, 2), and the
    surface of an aquaplanet (SST in 271-303 K) or of a seeded mixed land
    mask (land in 230-320 K beside the same sea); slrd, dfabs, flux_bands
    and st4a from the plain downward pass."""
    rng = np.random.default_rng(seed)
    sig = np.linspace(0.5 / K, 1 - 0.5 / K, K)
    sst = rng.uniform(271.0, 303.0, ncols)
    if surface == "aquaplanet":
        ts = sst
    else:
        land = rng.random(ncols) < 0.4
        ts = np.where(land, rng.uniform(230.0, 320.0, ncols), sst)
    ts[::3] = np.floor(ts[::3]) + 0.5
    ta = np.stack([ts - 62.0 * (1.0 - sig[k]) + rng.normal(0, 4.0, ncols)
                   for k in range(K)])
    ta[:, 1::4] = np.floor(ta[:, 1::4]) + 0.5
    row = lambda a: _t(a, dtype).reshape(*a.shape[:-1], 1, ncols) \
        .contiguous()
    ta_, ts_ = row(ta), row(ts)
    tau2 = row(rng.uniform(0.05, 1.0, (K, 4, ncols)))
    stratc = row(rng.uniform(0.0, 2.0, (2, ncols)))
    slru = row(0.98 * 5.67e-8 * ts ** 4)
    tabs = phys_for(dtype, K).lw_tabs
    slrd, dfabs, flux, st4a = down_plain(ta_, tau2, tabs)
    st4a = tuple(a.contiguous() for a in st4a)
    return (ta_, ts_, slrd.contiguous(), slru, dfabs.contiguous(),
            flux.contiguous(), st4a, tau2, stratc, tabs)


ROWS = {1: 1, 31: 1, 33: 3, 100: 4}   # a case's columns in latitude rows


def down_surface_case(seed, K, ncols, surface, dtype):
    """down_surface's operands on `ncols` columns in ROWS[ncols] latitude
    rows: up_block_case's lapse-rate profile over the blended surface
    temperature (some temperatures on a half), tau2 in (0.05, 1), winds,
    humidity and the hydrostatic geopotential, and the surface of an
    aquaplanet (fmask 0, SST in 271-303 K) or of a seeded mixed land mask
    (40 % of the columns land, their land fraction in (0.3, 1), land in
    230-320 K, orography); a quarter of the columns with dry soil.
    Returns (operands, LongwaveTables, SurfaceTables)."""
    rng = np.random.default_rng(seed)
    nlat = ROWS[ncols]
    sig = np.linspace(0.5 / K, 1 - 0.5 / K, K)
    sst = rng.uniform(271.0, 303.0, ncols)
    if surface == "aquaplanet":
        fmask, tland = np.zeros(ncols), sst.copy()
    else:
        land = rng.random(ncols) < 0.4
        fmask = np.where(land, rng.uniform(0.3, 1.0, ncols), 0.0)
        tland = rng.uniform(230.0, 320.0, ncols)
    tsfc = sst + fmask * (tland - sst)
    ta = np.stack([tsfc - 62.0 * (1.0 - sig[k]) + rng.normal(0, 4.0, ncols)
                   for k in range(K)])
    ta[:, 1::4] = np.floor(ta[:, 1::4]) + 0.5
    phi = np.zeros((K, ncols))
    phi[K - 1] = 287.0 * ta[K - 1] * (1.0 - sig[K - 1])
    for k in range(K - 2, -1, -1):
        phi[k] = phi[k + 1] + 287.0 * 0.5 * (ta[k] + ta[k + 1]) \
            * np.log(sig[k + 1] / sig[k])
    swav = rng.uniform(0.0, 1.0, ncols)
    swav[rng.random(ncols) < 0.25] = 0.0
    u = lambda lo, hi, *lead: rng.uniform(lo, hi, lead + (ncols,))
    arrays = dict(
        ta=ta, tau2=u(0.05, 1.0, K, 4), psg=u(0.72, 1.05),
        ua=u(-30.0, 30.0, K), va=u(-30.0, 30.0, K),
        qa=u(0.0, 18.0, K) * sig[:, None] ** 3, phi=phi,
        phi0=u(0.0, 3.0e4) * fmask, fmask=fmask, tland=tland, tsea=sst,
        swav=swav, ssrd=u(0.0, 400.0), forog=u(1.0, 1.5),
        alb_l=u(0.05, 0.7), alb_s=u(0.06, 0.5), snowc=u(0.0, 1.0))
    named = {k: _t(a, dtype).reshape(*a.shape[:-1], nlat, ncols // nlat)
             .contiguous() for k, a in arrays.items()}
    named["clat"] = _t(np.cos(np.linspace(-1.3, 1.3, nlat)), dtype)
    phys = phys_for(dtype, K)
    return named, phys.lw_tabs, phys.sfc_tabs


@pytest.mark.parametrize("surface", ["aquaplanet", "mixed_land"])
@pytest.mark.parametrize("ncols", [1, 31, 33, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("K", [5, 7, 8])
def test_host_down_surface_block_matches_column_body(host_lib, K, dtype,
                                                     ncols, surface):
    """K10a_down_surface's block (32 columns x K level warps and a
    surface warp: the Planck and band terms a level to a warp, the four
    band recursions a band to a warp, the sums a level to a warp; the
    surface fluxes up to slrd on the surface warp beside all of that,
    slrd and the rest after the last barrier; handed on through shared
    memory and surface registers that start as NaN) gives its phases run
    for one column at a time (down_surface_at, C = 1) bit for bit, every
    plane of its buffer, and the plain version's values; 1, 31, 33 and
    100 columns in 1, 1, 3 and 4 latitude rows leave the last block
    partly empty and read clat by row."""
    named, lw, sfc = down_surface_case(700 + 10 * K + ncols, K, ncols,
                                       surface, dtype)
    tabs = dict(lw_tabs=lw, sfc_tabs=sfc)
    ref = host_down_surface_buffer(host_lib, **named, **tabs)
    got = host_down_surface_buffer(host_lib, **named, **tabs, block=True)
    assert not got.isnan().any()
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    # and the plain version's values (float64 to 1e-12; float32 by
    # chip_smoke's rule: the host's libm is not PyTorch's)
    _hold(ds_dict(clw.unpack_down_surface(got, K)),
          ds_dict(clw.down_surface_plain(**named, **tabs)), dtype)


@pytest.mark.parametrize("surface", ["aquaplanet", "mixed_land"])
@pytest.mark.parametrize("ncols", [1, 31, 33, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("K", [5, 7, 8])
def test_host_longwave_up_block_matches_column_body(host_lib, K, dtype,
                                                    ncols, surface):
    """K10b's block (32 columns x K warps: the loads and the sums a level
    to a warp, the four band recursions a band to a warp, handed on
    through shared memory that starts as NaN) gives its phases run for
    one column at a time (radlw_up_at, C = 1) bit for bit, and the plain
    version's values; 1, 31, 33 and 100 columns leave the last block
    partly empty."""
    args = up_block_case(900 + 10 * K + ncols, K, ncols, surface, dtype)
    ref = host_up(host_lib, *args)
    got = host_up_block(host_lib, *args)
    for name, a, b in zip(("slr", "olr", "dfabs"), got, ref):
        assert not a.isnan().any(), name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    # and the plain version's values (float64 to 1e-12; float32 by
    # chip_smoke's rule: the host's libm is not PyTorch's)
    _hold(up_dict(got), up_dict(clw.radlw_up(*args)), dtype)


def _hold(got: dict, ref: dict, dtype, ints=()):
    """float64: 1e-12 and the integers equal; float32: chip_smoke's rule."""
    flipped, rel, worst = column_errors(got, ref, ints)
    if dtype == torch.float64:
        assert flipped == 0
        assert rel <= 1e-12, (worst, rel)
    else:
        assert flipped <= MAX_FLIPPED * NGP, flipped
        assert rel <= F32_RTOL, (worst, rel)
    for nm, r in ref.items():
        assert torch.isfinite(got[nm].to(torch.float64)).all(), nm
        assert got[nm].dtype == r.dtype and got[nm].shape == r.shape, nm


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("seed", [21, 22])
def test_host_column_moist_matches_plain(host_lib, seed, dtype):
    tabs = phys_for(dtype).moist_tabs
    args = moist_inputs(seed, dtype)
    ref = cm.column_moist_plain(*args, tabs)
    got = host_moist(host_lib, *args, tabs)
    assert (ref.icnv >= 0).any() and (ref.precls > 0).any()
    _hold(got._asdict(), ref._asdict(), dtype, INTS)


@pytest.mark.parametrize("ncols", [NGP, NGP - 12], ids=["grid", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("K", [5, 7, 8])
def test_host_moist_block_matches_column_body(host_lib, K, dtype, ncols):
    """K9's block (32 columns x K warps: the prologue and lscond a level
    to a warp, convmf and the column's close on one warp, handed on
    through shared memory that starts as NaN) gives the first design's
    per-column body bit for bit, the integers too; on the whole grid and
    on NGP - 12 columns, whose last block is ragged."""
    tabs = phys_for(dtype, K).moist_tabs
    tg, qg, phig, pslg = moist_inputs(50 + K, dtype, K=K)
    cols = lambda a: a.reshape(-1, NGP)[:, :ncols].reshape(-1, 1, ncols) \
        .contiguous()
    args = [cols(a) for a in (tg, qg, phig)] + [cols(pslg)[0]]
    ref = host_moist(host_lib, *args, tabs)
    got = host_moist(host_lib, *args, tabs, block=True)
    # convmf's trigger looks at levels K-4 down to 2: none at K = 5
    assert (ref.icnv >= 0).any() == (K > 5) and (ref.precls > 0).any()
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert not a.to(torch.float64).isnan().any(), name
        assert (a != -99).all(), name
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def grid_down_surface_args(seed, dtype, mask, ta=None, tau2=None, K=8):
    """down_surface's operands on the random columns of make_columns(seed)
    (K9's clamp of q, psg from pslg) with surface_kwargs' planes and
    tables in `dtype`; ta and tau2 default to the columns' and a seeded
    uniform (0.05, 1)."""
    c = make_columns(seed, K)
    phys = phys_for(dtype, K)
    if ta is None:
        ta = _t(c["tg"], dtype)
    if tau2 is None:
        rng = np.random.default_rng(seed + 200)
        tau2 = _t(rng.uniform(0.05, 1.0, (K, 4, NLAT, NLON)), dtype)
    kw = surface_kwargs(seed, _t(np.exp(c["pslg"]), dtype),
                        _t(np.maximum(c["qg"], 0.0), dtype), ta,
                        _t(c["phig"], dtype), mask, dtype)
    return dict(down_surface_args(kw, tau2), lw_tabs=phys.lw_tabs,
                sfc_tabs=phys.sfc_tabs)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mask", ["sea", "land", "mixed"])
def test_host_down_surface_matches_plain(host_lib, mask, dtype):
    """K10a_down_surface's phases run a column at a time
    (down_surface_at, C = 1) against its plain version (radlw_down, then
    suflux on its slrd) on the 16 x 32 random columns: float64 to 1e-12,
    float32 by chip_smoke's rule; both stability branches and, over land,
    evaporation 0 and > 0 are taken."""
    args = grid_down_surface_args(25, dtype, mask)
    ref = clw.down_surface_plain(**args)
    K = args["ta"].shape[0]
    unstable = args["ta"][K - 1] > args["ta"][K - 2]
    assert unstable.any() and not unstable.all()
    if mask != "sea":
        assert (ref[1].evap[0] == 0).any() and (ref[1].evap[0] > 0).any()
    _hold(ds_dict(host_down_surface(host_lib, **args)), ds_dict(ref), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("seed", [23, 24])
def test_host_column_longwave_matches_plain(host_lib, seed, dtype):
    tabs = phys_for(dtype).lw_tabs
    ta, tau2, stratc, ts, slru = longwave_inputs(seed, dtype)
    args = grid_down_surface_args(seed, dtype, "mixed", ta, tau2)
    ref_d, ref_fx = clw.down_surface_plain(**args)
    _hold(ds_dict(host_down_surface(host_lib, **args)),
          ds_dict((ref_d, ref_fx)), dtype)
    # the upward pass on the plain version's downward results, both sides
    up_args = (ta, ts, ref_d[0], slru, ref_d[1], ref_d[2], ref_d[3], tau2,
               stratc, tabs)
    _hold(up_dict(host_up(host_lib, *up_args)),
          up_dict(clw.radlw_up(*up_args)), dtype)


@pytest.mark.parametrize("K", [5, 7])
def test_host_columns_at_other_level_counts(host_lib, K):
    """The bodies are templates on K; 5 and 7 levels are compiled too."""
    phys = phys_for(torch.float64, K)
    args = moist_inputs(31, K=K)
    _hold(host_moist(host_lib, *args, phys.moist_tabs)._asdict(),
          cm.column_moist_plain(*args, phys.moist_tabs)._asdict(),
          torch.float64, INTS)
    rng = np.random.default_rng(K)
    ta = args[0]
    tau2 = _t(rng.uniform(0.05, 1.0, (K, 4, NLAT, NLON)))
    stratc = _t(rng.uniform(0.0, 2.0, (2, NLAT, NLON)))
    ts = _t(rng.uniform(230.0, 310.0, (NLAT, NLON)))
    slru = 0.98 * 5.67e-8 * ts ** 4
    ds_args = grid_down_surface_args(31, torch.float64, "mixed", ta, tau2, K)
    ref_d, ref_fx = clw.down_surface_plain(**ds_args)
    _hold(ds_dict(host_down_surface(host_lib, **ds_args)),
          ds_dict((ref_d, ref_fx)), torch.float64)
    up_args = (ta, ts, ref_d[0], slru, ref_d[1], ref_d[2], ref_d[3], tau2,
               stratc, phys.lw_tabs)
    _hold(up_dict(host_up(host_lib, *up_args)),
          up_dict(clw.radlw_up(*up_args)), torch.float64)
    assert host_lib.column_moist_host(6, 1, *([None] * 5), 1, None, None) == 1
    null = ctypes.POINTER(ctypes.c_void_p)()
    for entry in (host_lib.down_surface_host,
                  host_lib.down_surface_block_host):
        assert entry(6, 1, null, len(clw.INPUTS), None, None, 1, 1,
                     None) == 1
        assert entry(8, 1, null, 3, None, None, 1, 1, None) == 1


# ------------------------------------------------ (d): the operand checks

def _moist_call(**bad):
    tabs = phys_for(torch.float64).moist_tabs
    a = dict(zip(("tg", "qg", "phig", "pslg"), moist_inputs(41)), tabs=tabs)
    a.update(bad)
    return cm.column_moist(a["tg"], a["qg"], a["phig"], a["pslg"], a["tabs"])


def test_column_moist_refuses_bad_operands():
    tg, qg, phig, pslg = moist_inputs(41)
    tabs = phys_for(torch.float64).moist_tabs
    with pytest.raises(TypeError, match="dtype"):
        _moist_call(tg=tg.to(torch.float16))
    with pytest.raises(TypeError, match="qg: dtype"):
        _moist_call(qg=qg.float())
    with pytest.raises(TypeError, match="tabs.blob: dtype"):
        _moist_call(tabs=phys_for(torch.float32).moist_tabs)
    with pytest.raises(ValueError, match="phig: shape"):
        _moist_call(phig=phig[:-1].contiguous())
    with pytest.raises(ValueError, match="pslg: shape"):
        _moist_call(pslg=pslg[None])
    with pytest.raises(ValueError, match="tg"):
        _moist_call(tg=tg[0])
    with pytest.raises(ValueError, match="qg: must be contiguous"):
        _moist_call(qg=qg.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError, match="expected a tensor"):
        _moist_call(pslg=pslg.numpy())
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cm.column_moist(meta(tg), meta(qg), meta(phig), meta(pslg),
                        tabs._replace(blob=meta(tabs.blob)))
    with pytest.raises(ValueError, match="phig: on cpu"):
        cm.column_moist(meta(tg), meta(qg), phig, meta(pslg), tabs)


def test_column_longwave_refuses_bad_operands():
    tabs = phys_for(torch.float64).lw_tabs
    ta, tau2, stratc, ts, slru = longwave_inputs(42)
    args = grid_down_surface_args(42, torch.float64, "mixed", ta, tau2)
    down = lambda **bad: clw.down_surface(**{**args, **bad})
    (slrd, dfabs, flux, st4a), _ = down()
    with pytest.raises(TypeError, match="ta: dtype"):
        down(ta=ta.to(torch.bfloat16))
    with pytest.raises(TypeError, match="tau2: dtype"):
        down(tau2=tau2.float())
    with pytest.raises(ValueError, match="tau2: shape"):
        down(tau2=tau2[:, :3].contiguous())
    with pytest.raises(ValueError, match="tau2: must be contiguous"):
        down(tau2=tau2.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="lw_tabs.blob: shape"):
        down(lw_tabs=tabs._replace(blob=tabs.blob[:-1]))
    up = lambda **kw: clw.radlw_up(**{**dict(
        ta=ta, ts=ts, slrd=slrd, slru_sfc=slru, dfabs=dfabs,
        flux_bands=flux, st4a=st4a, tau2=tau2, stratc=stratc, tabs=tabs),
        **kw})
    with pytest.raises(TypeError, match="ts: dtype"):
        up(ts=ts.float())
    with pytest.raises(ValueError, match="flux_bands: shape"):
        up(flux_bands=flux[:2])
    with pytest.raises(ValueError, match="stratc: shape"):
        up(stratc=stratc[0])
    with pytest.raises(ValueError, match=r"st4a\[1\]: must be contiguous"):
        up(st4a=(st4a[0], st4a[1].transpose(1, 2).contiguous()
                 .transpose(1, 2)))
    meta = lambda t: t.to("meta")
    mtabs = tabs._replace(blob=meta(tabs.blob))
    with pytest.raises(ValueError, match="down_surface: no kernel for device"):
        down(**{k: meta(v) for k, v in args.items() if torch.is_tensor(v)},
             lw_tabs=mtabs, sfc_tabs=args["sfc_tabs"]._replace(
                 blob=meta(args["sfc_tabs"].blob)))
    with pytest.raises(ValueError, match="radlw_up: no kernel for device"):
        clw.radlw_up(meta(ta), meta(ts), meta(slrd), meta(slru), meta(dfabs),
                     meta(flux), tuple(map(meta, st4a)), meta(tau2),
                     meta(stratc), mtabs)


# ----------------------------------------------------- (e): the table blobs

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_table_blobs_hold_the_plain_versions_tables(dtype):
    """Each blob entry is the Python float (or the model's table value)
    the plain version multiplies with, cast to the model's dtype.  The
    expected values repeat the formulas of the JAX package's convmf
    (convection.py:36-44) and lscond (condensation.py:26-38)."""
    K = 8
    phys = phys_for(dtype)
    c = phys.const
    sig, dsig = phys.sig, phys.dsig
    cast = lambda x: torch.tensor([float(v) for v in x],
                                  dtype=torch.float64).to(dtype)
    entr = [max(0.0, float(s) - 0.5) ** 2 for s in sig]
    entr[0] = entr[K - 1] = 0.0
    norm = sum(entr[1:K - 1])
    entr = [e * (pc.ENTMAX / norm) for e in entr]
    rtlsc = 1.0 / (pc.TRLSC * 3600.0)
    rhref, dqmax = [0.0], [0.0]
    for k in range(1, K):
        sig2 = float(sig[k]) ** 2
        r = pc.RHLSC + pc.DRHLSC * (sig2 - 1.0)
        rhref.append(max(r, pc.RHBLSC) if k == K - 1 else r)
        dqmax.append(10.0 * sig2 * rtlsc)
    scalars = [c.cp, c.alhc,
               c.p0 * float(dsig[K - 1]) / (c.grav * pc.TRCNV * 3600.0),
               2.0 / (1.0 - pc.PSMIN), pc.PSMIN, pc.RHBL, pc.RHIL, pc.SMF,
               rtlsc, c.alhc / c.cp, c.p0 / c.grav]
    want = torch.cat([phys.sig_t, phys.wvi2_t, cast(entr), phys.grdsig,
                      phys.grdscp, cast(rhref), cast(dqmax), cast(dsig),
                      cast(scalars)])
    blob = phys.moist_tabs.blob
    assert blob.dtype == dtype and blob.is_contiguous()
    assert blob.shape == (cm.N_TABLES * K + cm.N_SCALARS,)
    assert torch.equal(blob, want)
    # the tables the JAX package multiplies with are the same numbers
    jphys = JPhysics(JGeometry(**GEOM), JConst(),
                     dtype=jnp.float64 if dtype == torch.float64
                     else jnp.float32)
    np.testing.assert_array_equal(phys.grdsig.numpy(), jphys.grdsig)
    np.testing.assert_array_equal(phys.grdscp.numpy(), jphys.grdscp)
    np.testing.assert_array_equal(phys.wvi2_t.numpy(), jphys.wvi2)

    want_lw = cast([float(v) for v in phys.wvi2] + [float(v) for v in dsig]
                   + [c.sbc, 1.0 - pc.EPSLW, pc.EMISFC, 1.0 - pc.EMISFC,
                      pc.EPSLW, pc.EPSLW * pc.EMISFC])
    blob = phys.lw_tabs.blob
    assert blob.dtype == dtype and blob.is_contiguous()
    assert blob.shape == (clw.N_TABLES * K + clw.N_SCALARS,)
    assert torch.equal(blob, want_lw)

"""Port parity of the column physics (physics/), scheme by scheme.

The JAX package's schemes and the port's take the same plausible random
columns (the generator of tests/test_physics_oracle.py, copied here),
float64 on the CPU.  Tolerances: 1e-12 of each output's scale per scheme
(its largest magnitude); the full driver (`PhysicsModel.compute`) on the
aquaplanet and on land, with and without the shortwave step, 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.constants import PhysicalConstants as JConst
from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.physics import radiation as jrad
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu.physics.condensation import lscond as jlscond
from speedy_ml_tpu.physics.convection import convmf as jconvmf
from speedy_ml_tpu.physics.driver import PhysicsModel as JPhysics
from speedy_ml_tpu.physics.driver import RadiationCarry as JCarry
from speedy_ml_tpu.physics.humidity import qsat_from_t as jqsat
from speedy_ml_tpu.physics.humidity import rh_to_spec_hum as jrh2q
from speedy_ml_tpu.physics.humidity import spec_hum_to_rh as jq2rh
from speedy_ml_tpu.physics.land_sea import forin5 as jforin5
from speedy_ml_tpu.physics.land_sea import forint as jforint
from speedy_ml_tpu.physics.land_sea import \
    init_surface_state as jinit_sfc
from speedy_ml_tpu.physics.surface import sflset as jsflset
from speedy_ml_tpu.physics.surface import suflux as jsuflux
from speedy_ml_tpu.physics.vdiff import vdifsc as jvdifsc
from speedy_ml_tpu_torch.convert import boundary_from_numpy
from speedy_ml_tpu_torch.core.constants import PhysicalConstants
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.core.spectral import SpectralTransform
from speedy_ml_tpu_torch.physics import land_sea
from speedy_ml_tpu_torch.physics import radiation as rad
from speedy_ml_tpu_torch.physics.boundaries import (load_npz, save_npz,
                                                    synthetic_boundary_data)
from speedy_ml_tpu_torch.physics.condensation import lscond
from speedy_ml_tpu_torch.physics.convection import convmf
from speedy_ml_tpu_torch.physics.driver import PhysicsModel, RadiationCarry
from speedy_ml_tpu_torch.physics.humidity import (qsat_from_t,
                                                  rh_to_spec_hum,
                                                  spec_hum_to_rh)
from speedy_ml_tpu_torch.physics.surface import sflset, suflux
from speedy_ml_tpu_torch.physics.vdiff import vdifsc
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
KX = 8
NLAT, NLON = 6, 8
NGP = NLAT * NLON
P0, GG, CP, ALHC = 1.0e5, 9.81, 1004.0, 2501.0


# ---------------------------------------- inputs (after the oracle file)

def vertical_tables():
    hsg = np.asarray(JGeometry().half_sigma, dtype=np.float64)
    sig = 0.5 * (hsg[1:] + hsg[:-1])
    dsig = hsg[1:] - hsg[:-1]
    sigl = np.log(sig)
    wvi = np.zeros((KX, 2))
    for k in range(KX - 1):
        wvi[k, 0] = 1.0 / (sigl[k + 1] - sigl[k])
        wvi[k, 1] = (np.log(hsg[k + 1]) - sigl[k]) * wvi[k, 0]
    wvi[KX - 1, 1] = (np.log(0.99) - sigl[KX - 1]) * wvi[KX - 2, 0]
    return sig, dsig, hsg, wvi


def make_columns(seed=0):
    """Physically plausible random columns: a stable-ish T profile, q in
    (0, 1.2*qsat), psa around 1."""
    rng = np.random.default_rng(seed)
    sig, dsig, hsg, wvi = vertical_tables()
    psa = rng.uniform(0.72, 1.05, NGP)
    tsfc = rng.uniform(255.0, 310.0, NGP)
    ta = np.zeros((NGP, KX))
    for k in range(KX):
        ta[:, k] = tsfc - 62.0 * (1.0 - sig[k]) + rng.normal(0, 4.0, NGP)
    ta = np.clip(ta, 180.0, 320.0)
    qsat = np.stack([np.asarray(jqsat(jnp.asarray(ta[:, k]),
                                      sig[k] * jnp.asarray(psa)))
                     for k in range(KX)], axis=1)
    rh = rng.uniform(0.05, 1.2, (NGP, KX))
    rh[:, -2:] = rng.uniform(0.55, 1.1, (NGP, 2))   # moist PBL
    qa = rh * qsat
    phi = np.zeros((NGP, KX))
    phi[:, KX - 1] = 287.0 * ta[:, KX - 1] * (1.0 - sig[KX - 1])
    for k in range(KX - 2, -1, -1):
        phi[:, k] = phi[:, k + 1] + 287.0 * 0.5 \
            * (ta[:, k] + ta[:, k + 1]) * np.log(sig[k + 1] / sig[k])
    se = CP * ta + phi
    return dict(sig=sig, dsig=dsig, hsg=hsg, wvi=wvi, psa=psa, ta=ta,
                qsat=qsat, qa=qa, rh=rh, phi=phi, se=se)


def to_grid(a):
    """(ngp, K) -> (K, NLAT, NLON); (ngp,) -> (NLAT, NLON)."""
    a = np.asarray(a)
    return a.T.reshape(KX, NLAT, NLON) if a.ndim == 2 \
        else a.reshape(NLAT, NLON)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _close(got, ref, rtol=1e-12):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, f"err {err:.3e}, scale {scale:.3e}"


# ------------------------------------------------------------- schemes

def test_humidity_matches():
    c = make_columns(1)
    ta, ps = to_grid(c["ta"]), to_grid(c["psa"])
    _close(qsat_from_t(_t(ta), _t(ps)), jqsat(jnp.asarray(ta),
                                              jnp.asarray(ps)))
    q = to_grid(c["qa"])
    for sig in (0.95, -1.0):
        for got, ref in zip(spec_hum_to_rh(_t(ta[0]), _t(ps), sig,
                                           _t(q[0])),
                            jq2rh(jnp.asarray(ta[0]), jnp.asarray(ps), sig,
                                  jnp.asarray(q[0]))):
            _close(got, ref)
        for got, ref in zip(rh_to_spec_hum(_t(ta[0]), _t(ps), sig,
                                           _t(c["rh"][:, 0].reshape(NLAT,
                                                                   NLON))),
                            jrh2q(jnp.asarray(ta[0]), jnp.asarray(ps), sig,
                                  jnp.asarray(c["rh"][:, 0]
                                              .reshape(NLAT, NLON)))):
            _close(got, ref)


@pytest.mark.parametrize("seed", [2, 3])
def test_convection_and_condensation_match(seed):
    c = make_columns(seed)
    psa = to_grid(c["psa"])
    se, qa, qs = to_grid(c["se"]), to_grid(c["qa"]), to_grid(c["qsat"])
    wvi2 = c["wvi"][:, 1]
    kw = dict(sig=c["sig"], dsig=c["dsig"], p0=P0, grav=GG)
    jout = jconvmf(jnp.asarray(psa), jnp.asarray(se), jnp.asarray(qa),
                   jnp.asarray(qs), wvi2=jnp.asarray(wvi2), alhc=ALHC, **kw)
    tout = convmf(_t(psa), _t(se), _t(qa), _t(qs), wvi2=_t(wvi2), alhc=ALHC,
                  **kw)
    assert (np.asarray(jout[0]) < KX).any(), "no column convects"
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for got, ref in zip(tout[1:], jout[1:]):
        _close(got, ref)
    jl = jlscond(jnp.asarray(psa), jnp.asarray(qa), jnp.asarray(qs),
                 jout[0], cp=CP, alhc=ALHC, **kw)
    tl = lscond(_t(psa), _t(qa), _t(qs), tout[0], cp=CP, alhc=ALHC, **kw)
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl[0]))
    for got, ref in zip(tl[1:], jl[1:]):
        _close(got, ref)


def test_vertical_diffusion_matches():
    c = make_columns(4)
    icnv = np.random.default_rng(4).integers(0, 3, (NLAT, NLON))
    args = [to_grid(c[k]) for k in ("ta", "ta", "se", "rh", "qa", "qsat",
                                    "phi")]
    args[0] = args[0] * 0.1
    args[1] = -args[1] * 0.05
    kw = dict(sig=c["sig"], sigh=c["hsg"], dsig=c["dsig"], cp=CP, alhc=ALHC)
    jout = jvdifsc(*map(jnp.asarray, args), jnp.asarray(icnv), **kw)
    tout = vdifsc(*map(_t, args), torch.as_tensor(icnv), **kw)
    for got, ref in zip(tout, jout):
        _close(got, ref)


def _solar(seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, (NLAT, NLON)) for lo, hi in (
        (0.0, 420.0), (0.0, 15.0), (0.0, 15.0), (1.0, 4.0), (0.0, 10.0))]


def test_radiation_matches():
    c = make_columns(5)
    rng = np.random.default_rng(5)
    psa = to_grid(c["psa"])
    qa, rh, ta = to_grid(c["qa"]), to_grid(c["rh"]), to_grid(c["ta"])
    precnv = rng.uniform(0.0, 0.02, (NLAT, NLON))
    precls = rng.uniform(0.0, 0.02, (NLAT, NLON))
    iptop = rng.integers(2, KX + 1, (NLAT, NLON))
    gse = rng.uniform(0.0, 0.6, (NLAT, NLON))
    fmask = rng.uniform(0.0, 1.0, (NLAT, NLON))
    jc = jrad.cloud(*map(jnp.asarray, (qa, rh, precnv, precls, iptop, gse,
                                       fmask)))
    tc = rad.cloud(_t(qa), _t(rh), _t(precnv), _t(precls),
                   torch.as_tensor(iptop), _t(gse), _t(fmask))
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc[0]))
    for got, ref in zip(tc[1:], jc[1:]):
        _close(got, ref)
    sol = _solar(6)
    alb = rng.uniform(0.05, 0.6, (NLAT, NLON))
    kw = dict(sig=c["sig"], dsig=c["dsig"])
    jsw = jrad.radsw(jnp.asarray(psa), jnp.asarray(qa), jc[0], jc[1], jc[2],
                     jc[3], jrad.SolarForcing(*map(jnp.asarray, sol)),
                     jnp.asarray(alb), **kw)
    tsw = rad.radsw(_t(psa), _t(qa), tc[0], tc[1], tc[2], tc[3],
                    rad.SolarForcing(*map(_t, sol)), _t(alb), **kw)
    for got, ref in zip(tsw, jsw):
        _close(got, ref)
    # longwave, down then up, on the transmissivities radsw made
    wvi2 = c["wvi"][:, 1]
    fband = jrad.build_fband()
    np.testing.assert_array_equal(rad.build_fband(), fband)
    jd = jrad.radlw_down(jnp.asarray(ta), jsw[4], fband, wvi2=wvi2,
                         dsig=c["dsig"], sbc=5.67e-8)
    td = rad.radlw_down(_t(ta), tsw[4], fband, wvi2=wvi2, dsig=c["dsig"],
                        sbc=5.67e-8)
    for got, ref in zip(td[:3], jd[:3]):
        _close(got, ref)
    ts = rng.uniform(230.0, 310.0, (NLAT, NLON))
    slru = 0.98 * 5.67e-8 * ts ** 4
    ju = jrad.radlw_up(jnp.asarray(ta), jnp.asarray(ts), jd[0],
                       jnp.asarray(slru), jd[1], jd[2], jd[3], jsw[4],
                       jsw[5], fband, dsig=c["dsig"], sbc=5.67e-8)
    tu = rad.radlw_up(_t(ta), _t(ts), td[0], _t(slru), td[1], td[2], td[3],
                      tsw[4], tsw[5], fband, dsig=c["dsig"], sbc=5.67e-8)
    for got, ref in zip(tu, ju):
        _close(got, ref)
    for jb in range(4):
        _close(rad._fband_lookup(fband, _t(ta), jb),
               jrad._fband_lookup(fband, jnp.asarray(ta), jb))


def test_solar_forcing_matches():
    g = JGeometry(**GEOM)
    slat, clat = g.sin_lat, g.cos_lat
    for tyear in (0.01, 0.37, 0.8):
        j = jrad.sol_oz_traced(jnp.asarray(tyear), jnp.asarray(slat),
                               jnp.asarray(clat), g.nlon)
        t = rad.sol_oz_traced(torch.tensor(tyear, dtype=torch.float64),
                              _t(slat), _t(clat), g.nlon)
        for got, ref in zip(t, j):
            _close(got, ref)


@pytest.mark.parametrize("fmask", ["sea", "land", "mixed"])
def test_surface_fluxes_match(fmask):
    c = make_columns(7)
    rng = np.random.default_rng(7)
    f = dict(sea=np.zeros, land=np.ones)[fmask]((NLAT, NLON)) \
        if fmask != "mixed" else rng.uniform(0.0, 1.0, (NLAT, NLON))
    g2 = lambda lo, hi: rng.uniform(lo, hi, (NLAT, NLON))
    kw = dict(phi0=g2(0.0, 3.0e4), fmask=f, tland=g2(250.0, 315.0),
              tsea=g2(271.0, 304.0), swav=g2(0.0, 1.0), ssrd=g2(0.0, 400.0),
              slrd=g2(100.0, 450.0), forog=g2(1.0, 1.5),
              alb_l=g2(0.05, 0.7), alb_s=g2(0.06, 0.5), snowc=g2(0.0, 1.0),
              clat_row=np.cos(np.linspace(-1.3, 1.3, NLAT)))
    const = dict(sigl_bot=float(np.log(c["sig"][-1])),
                 wvi2_bot=float(c["wvi"][-1, 1]), rd=287.0, cp=CP,
                 alhc=ALHC, sbc=5.67e-8)
    ua = rng.uniform(-30.0, 30.0, (KX, NLAT, NLON))
    va = rng.uniform(-30.0, 30.0, (KX, NLAT, NLON))
    args = (to_grid(c["psa"]), ua, va, to_grid(c["ta"]), to_grid(c["qa"]),
            to_grid(c["rh"]), to_grid(c["phi"]))
    j = jsuflux(*map(jnp.asarray, args),
                **{k: jnp.asarray(v) for k, v in kw.items()}, **const)
    t = suflux(*map(_t, args), **{k: _t(v) for k, v in kw.items()}, **const)
    for name in j._fields:
        a, b = getattr(t, name), getattr(j, name)
        if isinstance(b, tuple):
            for x, y in zip(a, b):
                _close(x, y)
        else:
            _close(a, b)
    np.testing.assert_allclose(sflset(kw["phi0"], GG),
                               jsflset(kw["phi0"], GG), rtol=1e-15)


def test_monthly_interpolation_matches():
    rng = np.random.default_rng(8)
    for12 = rng.normal(size=(12, 3, 4))
    for imon, fmon in ((0, 0.2), (5, 0.5), (11, 0.9)):
        for tf, jf in ((land_sea.forint, jforint),
                       (land_sea.forin5, jforin5)):
            _close(tf(_t(for12), imon, fmon),
                   jf(jnp.asarray(for12), jnp.asarray(imon),
                      jnp.asarray(fmon)))


# ---------------------------------------------------- driver and forcing

@pytest.fixture(scope="module", params=["aquaplanet", "land"])
def setup(request):
    land = request.param == "land"
    jg = JGeometry(**GEOM)
    jsht = JST(jg, dtype=jnp.float64, zonal="dft")
    jbd = jsynthetic(jg, jsht, land=land)
    jphys = JPhysics(jg, JConst(), dtype=jnp.float64)
    g = Geometry(**GEOM)
    sht = SpectralTransform(g, dtype=torch.float64, device="cpu")
    bd = boundary_from_numpy(jbd, device="cpu", dtype=torch.float64)
    phys = PhysicsModel(g, PhysicalConstants(), dtype=torch.float64,
                        device="cpu")
    return land, jsht, jbd, jphys, sht, bd, phys


def test_boundaries_match(setup, tmp_path):
    land, jsht, jbd, _, sht, bd, _ = setup
    own = synthetic_boundary_data(sht.geom, sht, land=land)
    for k in bd.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(own, k).numpy(),
                                      np.asarray(getattr(jbd, k)), k)
    save_npz(own, str(tmp_path / "bd.npz"))
    back = load_npz(str(tmp_path / "bd.npz"), dtype=torch.float64,
                    device="cpu")
    for k in bd.__dataclass_fields__:
        assert torch.equal(getattr(back, k), getattr(own, k))


def _surface_and_forcing(setup, imon=6, fmon=0.3, tyear=0.52):
    land, jsht, jbd, jphys, sht, bd, phys = setup
    sst = np.asarray(jbd.sst12[imon]) + 1.5
    jsfc = jinit_sfc(jbd, jnp.asarray(imon), jnp.asarray(fmon),
                     jnp.asarray(sst), 0.25)
    tsfc = land_sea.init_surface_state(bd, imon, fmon, _t(sst), 0.25)
    jf = jphys.daily_forcing(jbd, jsfc, tyear, jsht)
    tf = phys.daily_forcing(bd, tsfc, tyear, sht)
    return jsfc, tsfc, jf, tf


def test_surface_state_and_daily_forcing_match(setup):
    jsfc, tsfc, jf, tf = _surface_and_forcing(setup)
    for k in tsfc.__dataclass_fields__:
        _close(getattr(tsfc, k), getattr(jsfc, k))
    for k in tf.__dataclass_fields__:
        _close(getattr(tf, k), getattr(jf, k))


@pytest.mark.parametrize("lradsw", [True, False])
def test_physics_compute_matches(setup, lradsw):
    land, jsht, jbd, jphys, sht, bd, phys = setup
    jsfc, tsfc, jf, tf = _surface_and_forcing(setup)
    g = sht.geom
    rng = np.random.default_rng(9 + lradsw)
    c = make_columns(9)
    # the random columns tiled over the T10 grid
    tile = lambda a: np.resize(np.asarray(a).T, (KX, g.nlat * g.nlon)) \
        .reshape(KX, g.nlat, g.nlon)
    tg, qg, phig = tile(c["ta"]), tile(c["qa"]), tile(c["phi"])
    ug = rng.uniform(-25.0, 25.0, tg.shape)
    vg = rng.uniform(-25.0, 25.0, tg.shape)
    pslg = np.log(rng.uniform(0.75, 1.03, (g.nlat, g.nlon)))
    jcarry = JCarry.zeros(KX, g.nlat, g.nlon, jnp.float64)
    tcarry = RadiationCarry.zeros(KX, g.nlat, g.nlon, torch.float64)
    if not lradsw:
        # a carry with content, as after a shortwave step
        fill = lambda a: rng.uniform(0.1, 1.0, a.shape)
        vals = {k: fill(np.asarray(getattr(jcarry, k)))
                for k in tcarry.__dataclass_fields__}
        jcarry = JCarry(**{k: jnp.asarray(v) for k, v in vals.items()})
        tcarry = RadiationCarry(**{k: _t(v) for k, v in vals.items()})
    args = (ug, vg, tg, qg, phig, pslg)
    jout = jphys.compute(*map(jnp.asarray, args), bd=jbd, sfc=jsfc,
                         forcing=jf, carry=jcarry, lradsw=jnp.asarray(lradsw))
    tout = phys.compute(*map(_t, args), bd=bd, sfc=tsfc, forcing=tf,
                        carry=tcarry, lradsw=lradsw)
    for got, ref in zip(tout[:4], jout[:4]):
        _close(got, ref, 1e-10)
    for k in tcarry.__dataclass_fields__:
        _close(getattr(tout[4], k), getattr(jout[4], k), 1e-10)
    for got, ref in zip(tout[5], jout[5]):
        _close(got, ref, 1e-10)
    assert float(np.abs(np.asarray(jout[5].precnv)).max()) > 0


@pytest.mark.parametrize("lradsw", [True, False], ids=["sw", "no_sw"])
def test_compute_unpacks_as_the_jax_caller(setup, lradsw):
    """compute returns the JAX package's six values, so the JAX GCM's own
    unpacking (speedy_ml_tpu/gcm.py: ut, vt, tt, qt, carry2, diag) works
    on the port; each value within 1e-10 of JAX's in float64.  The flux
    sums of a leapfrog step come from compute_with_sums, whose first six
    values are compute's."""
    land, jsht, jbd, jphys, sht, bd, phys = setup
    jsfc, tsfc, jf, tf = _surface_and_forcing(setup)
    g = sht.geom
    c = make_columns(11)
    tile = lambda a: np.resize(np.asarray(a).T, (KX, g.nlat * g.nlon)) \
        .reshape(KX, g.nlat, g.nlon)
    rng = np.random.default_rng(12)
    args = (rng.uniform(-25.0, 25.0, (KX, g.nlat, g.nlon)),
            rng.uniform(-25.0, 25.0, (KX, g.nlat, g.nlon)), tile(c["ta"]),
            tile(c["qa"]), tile(c["phi"]),
            np.log(rng.uniform(0.75, 1.03, (g.nlat, g.nlon))))
    kw = dict(bd=bd, sfc=tsfc, forcing=tf, lradsw=lradsw,
              carry=RadiationCarry.zeros(KX, g.nlat, g.nlon, torch.float64))
    ut, vt, tt, qt, carry2, diag = phys.compute(*map(_t, args), **kw)
    jut, jvt, jtt, jqt, jcarry2, jdiag = jphys.compute(
        *map(jnp.asarray, args), bd=jbd, sfc=jsfc, forcing=jf,
        carry=JCarry.zeros(KX, g.nlat, g.nlon, jnp.float64),
        lradsw=jnp.asarray(lradsw))
    for got, ref in ((ut, jut), (vt, jvt), (tt, jtt), (qt, jqt)):
        _close(got, ref, 1e-10)
    for k in carry2.__dataclass_fields__:
        _close(getattr(carry2, k), getattr(jcarry2, k), 1e-10)
    assert diag._fields == jdiag._fields
    for got, ref in zip(diag, jdiag):
        _close(got, ref, 1e-10)
    *six, fluxes = phys.compute_with_sums(*map(_t, args), **kw)
    assert fluxes is None
    for a, b in zip(six, (ut, vt, tt, qt)):
        assert torch.equal(a, b)


def test_unported_physics_options_raise():
    """RDF and SPPT, once unported, are taken
    (tests/test_torch_optional_physics.py holds them against the JAX
    package): randfh is stored in the model's dtype, and a pattern of
    the wrong shape raises."""
    g = Geometry(**GEOM)
    phys = PhysicsModel(g, PhysicalConstants(), randfh=np.zeros((2, 16, 32)),
                        device="cpu")
    assert phys.randfh.dtype == torch.float32
    with pytest.raises(ValueError, match="randfh"):
        PhysicsModel(g, PhysicalConstants(), randfh=np.zeros((2, 16, 31)),
                     device="cpu")
    assert PhysicsModel(g, PhysicalConstants(), device="cpu").randfh is None


def test_slab_coupler_functions_match_jax():
    """The four functions of the daily coupler on the synthetic
    aquaplanet and land planet: sea_domain_mask and build_slab_coeffs
    equal to the JAX package's, couple_daily (default flags, seeded
    fluxes) and sstan_for_window at 1e-12 (tests/test_torch_land_sea.py
    covers every flag branch)."""
    from speedy_ml_tpu.physics import land_sea as jls
    g = Geometry(**GEOM)
    jg = JGeometry(**GEOM)
    lat = np.rad2deg(g.lat_radians)
    np.testing.assert_array_equal(
        land_sea.sea_domain_mask("elnino", lat, g.nlon),
        jls.sea_domain_mask("elnino", lat, g.nlon))
    rng = np.random.default_rng(19)
    fx = {k: rng.normal(0, 30.0, (g.nlat, g.nlon))
          for k in ("hflux_l", "hflux_s", "hflux_i")}
    for land in (False, True):
        jbd = jsynthetic(jg, JST(jg, dtype=jnp.float64), land=land)
        bd = boundary_from_numpy(jbd, device="cpu", dtype=torch.float64)
        jco = jls.build_slab_coeffs(jbd, lat, jnp.float64)
        co = land_sea.build_slab_coeffs(bd, lat, torch.float64)
        for a, b in zip(co, jco):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jsfc = jls.init_surface_state(jbd, jnp.asarray(2), jnp.asarray(0.3))
        sfc = land_sea.init_surface_state(bd, 2, 0.3)
        ref = jls.couple_daily(jsfc, jco, jbd,
                               {k: jnp.asarray(v) for k, v in fx.items()},
                               jnp.asarray(2), jnp.asarray(0.3))
        got = land_sea.couple_daily(
            sfc, co, bd, {k: torch.as_tensor(v) for k, v in fx.items()},
            2, 0.3)
        for k in ref.__dataclass_fields__:
            _close(getattr(got, k), getattr(ref, k))
    win = rng.normal(0, 1.0, (3, g.nlat, g.nlon))
    _close(land_sea.sstan_for_window(torch.as_tensor(win), 0.7),
           jls.sstan_for_window(jnp.asarray(win), jnp.asarray(0.7)))

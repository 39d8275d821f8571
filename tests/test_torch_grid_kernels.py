"""The arithmetic of K7 (kernels/grid_dynamics.py) without a card.

kernels/csrc/grid_host.cpp compiles the header the CUDA kernel includes
(grid_dynamics.cuh) for the host with g++: the first design's loop, one
column after the other, and the kernel's block of 16 columns x K levels
with its threads written out as loops in phase order (load, the column
sums on the threads of level 0, the level outputs) and its shared memory
starting as NaN.  At K = 5, 7 and 8, on T10 grids whose fields are made from a seed
with numpy:
  - the per-column body, with and without the physics tendencies, is
    within 1e-12 of each output field's scale of grid_dynamics_plain in
    float64, and within chip_smoke's K7_ULPS in float32;
  - the block equals the per-column body bit for bit, in float32 and
    float64, on the whole grid and on a column count whose last block is
    ragged, and writes every output;
  - sigdt summed from the bottom up, or read one half level off, makes
    the block differ (negative controls);
  - on the synthesized stack of a T10 state, the body agrees with the JAX
    package's grid_tendencies (float64, 1e-10 of each field level's
    signal: the transforms sum in other orders).
The launch code itself runs only on a card (chip_smoke.py).
"""

import ctypes
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.dycore.init import rest_state as jrest
from speedy_ml_tpu.dycore.model import DycoreModel as JDycore
from speedy_ml_tpu_torch.convert import spectral_state_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.dycore.model import DycoreModel, GridTendencies
from speedy_ml_tpu_torch.kernels.grid_dynamics import (column_blob,
                                                       grid_dynamics_plain)

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
sys.path.insert(0, str(REPO))
from chip_smoke import K7_ULPS  # noqa: E402  (the card check's tolerance)
from torch_lane import one_thread_per_pool  # noqa: E402, F401

NLAT, NLON = 16, 32
RAGGED = (15, 31)   # 465 columns: the last block of the kernel's 16 holds 1
RTOL_F64 = 1e-12
FAULTS = {"sigdt_reversed": 1, "sigdt_one_level_off": 2}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/grid_host.cpp built with g++ and loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    so = tmp_path_factory.mktemp("grid_host") / "libgrid_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    str(CSRC / "grid_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    call = [i, i] + [vp] * 6 + [d, d, i, i, vp]
    lib.grid_column_host.argtypes = call
    lib.grid_block_host.argtypes = call + [i]
    lib.grid_column_host.restype = lib.grid_block_host.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def tables(K: int, dtype, nlat: int = NLAT):
    """The column tables of a T10 dycore (its semi-implicit step's tref,
    the Coriolis parameter of its first nlat latitudes) and the kernel's
    blob of them in `dtype` (column_blob's layout; in float32 on the whole
    grid the blob the wrapper passes)."""
    dyn = DycoreModel(Geometry(trunc=10, nlon=NLON, nlat=NLAT, nlev=K),
                      dtype=dtype, device="cpu")
    tabs = dyn.column_tables(dyn.imp_double)
    blob = torch.cat([tabs.coriol, tabs.dhs, tabs.dhsr, tabs.fsgr,
                      tabs.tref, tabs.tref3]).to(dtype).contiguous()
    if dtype == torch.float32:
        assert torch.equal(blob, tabs.blob) and torch.equal(
            blob, column_blob(tabs))
    tabs = tabs._replace(coriol=tabs.coriol[:nlat])
    return tabs, torch.cat([blob[:nlat], blob[NLAT:]])


def fields(seed, K, dtype, shape=(NLAT, NLON), phys=True):
    """A synthesized stack gall (6K + 2, *shape) of plausible magnitudes
    and the physics tendencies (or None), from the seed."""
    rng = np.random.default_rng(seed)
    lev = lambda lo, hi: rng.uniform(lo, hi, (K, *shape))
    gall = np.concatenate([
        lev(-1e-4, 1e-4), lev(-1e-5, 1e-5), lev(190.0, 310.0),
        lev(0.0, 18.0), lev(-40.0, 40.0), lev(-40.0, 40.0),
        rng.uniform(-3e-7, 3e-7, (2, *shape))])
    t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    ptend = None
    if phys:
        ptend = GridTendencies(u=t(lev(-1e-4, 1e-4)), v=t(lev(-1e-4, 1e-4)),
                               t=t(lev(-1e-4, 1e-4)),
                               tr=t(lev(-1e-6, 1e-6)[None]))
    return t(gall), ptend


def _ptr(a):
    if a is None:
        return None
    assert a.is_contiguous() and a.device.type == "cpu"
    return a.data_ptr()


def run_host(lib, gall, ptend, K, block=False, fault=0):
    """K7's arithmetic built for the host: the per-column body or the
    block (fault: a FAULTS value, 0 for none).  Every output starts as
    NaN."""
    dtype = gall.dtype
    _, nlat, nlon = gall.shape
    tabs, blob = tables(K, dtype, nlat)
    out = torch.full((1 + 9 * K, nlat, nlon), float("nan"), dtype=dtype)
    ps = [None] * 4 if ptend is None else \
        [ptend.u, ptend.v, ptend.t, ptend.tr]
    args = [K, int(dtype == torch.float64), _ptr(gall),
            *[_ptr(p) for p in ps], _ptr(blob), float(tabs.rgas),
            float(tabs.akap), nlat, nlon, _ptr(out)]
    rc = (lib.grid_block_host(*args, fault) if block
          else lib.grid_column_host(*args))
    assert rc == 0
    return out


def field_err(got, ref):
    """max over the output fields of |got - ref| / the field's scale."""
    g, r = got.reshape(got.shape[0], -1), ref.reshape(ref.shape[0], -1)
    scale = r.abs().amax(dim=1).clamp(min=1e-300)
    return float(((g - r).abs().amax(dim=1) / scale).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("phys", [True, False], ids=["physics", "dry"])
@pytest.mark.parametrize("K", [5, 7, 8])
def test_column_body_matches_plain(lib, K, phys, dtype):
    gall, ptend = fields(10 + K, K, dtype, phys=phys)
    got = run_host(lib, gall, ptend, K)
    ref = grid_dynamics_plain(gall, ptend, tables(K, dtype)[0], K, 1)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = field_err(got, ref)
    if dtype == torch.float64:
        assert err <= RTOL_F64, err
    else:
        assert err <= K7_ULPS * torch.finfo(dtype).eps, err


@pytest.mark.parametrize("shape", [(NLAT, NLON), RAGGED],
                         ids=["grid", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("phys", [True, False], ids=["physics", "dry"])
@pytest.mark.parametrize("K", [5, 7, 8])
def test_block_matches_column_body(lib, K, phys, dtype, shape):
    """The kernel's block (the threads of level k load and write level k,
    those of level 0 form the column sums, each level forms the fluxes on
    both of its half levels) gives the first design's bits, psfield
    included."""
    gall, ptend = fields(20 + K, K, dtype, shape, phys)
    ref = run_host(lib, gall, ptend, K)
    got = run_host(lib, gall, ptend, K, block=True)
    assert not got.isnan().any()
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("fault", list(FAULTS))
def test_block_faults_are_seen(lib, fault):
    """Negative controls: sigdt summed from the bottom half level up (the
    same terms in the other order), or read one half level off, must
    change the block's bits; the second also breaks the 1e-12 against the
    plain version."""
    K = 8
    gall, ptend = fields(31, K, torch.float64, RAGGED)
    ref = run_host(lib, gall, ptend, K)
    got = run_host(lib, gall, ptend, K, block=True, fault=FAULTS[fault])
    assert not got.isnan().any()
    assert (got != ref).any()
    if fault == "sigdt_one_level_off":
        plain = grid_dynamics_plain(
            gall, ptend, tables(K, torch.float64, RAGGED[0])[0], K, 1)
        assert field_err(got, plain) > 1e3 * RTOL_F64


def test_levels_not_compiled_are_refused(lib):
    for K in (4, 6, 9):
        args = (K, 1, *[None] * 6, 1.0, 1.0, 1, 1, None)
        assert lib.grid_column_host(*args) == 1
        assert lib.grid_block_host(*args, 0) == 1


def test_column_body_matches_jax_grid_tendencies(lib):
    """The body on the port's synthesized stack of a T10 state against
    the JAX package's grid_tendencies on the same state: the tendencies,
    psfield, the kinetic energy and the advection products."""
    K = 8
    geom = dict(trunc=10, nlon=NLON, nlat=NLAT, nlev=K)
    jd = JDycore(JGeometry(**geom), dtype=jnp.float64, zonal="dft")
    td = DycoreModel(Geometry(**geom), dtype=torch.float64, device="cpu")
    g = td.geom
    lat, lon = g.lat_radians[:, None], g.lon_radians[None, :]
    orog = 9.81 * 1500.0 * np.exp(-((lat - 0.6) ** 2 + (lon - 2.0) ** 2)
                                  / 0.2)
    js, _ = jrest(jd, jnp.asarray(orog))
    rng = np.random.default_rng(5)
    ll = np.add.outer(np.arange(g.mx), np.arange(g.nx))
    red = (ll <= g.trunc) / (1.0 + ll)
    scale = dict(vor=2e-6, div=5e-7, t=0.3, ps=1e-3, tr=0.05)
    pert = {}
    for k, s in scale.items():
        a = np.asarray(getattr(js, k))
        z = (rng.normal(size=a.shape) + 1j * rng.normal(size=a.shape)) * red
        z[..., 0, :] = z[..., 0, :].real
        pert[k] = jnp.asarray(a + s * z)
    js = type(js)(**pert)
    ts = spectral_state_from_numpy(js, device="cpu", dtype=torch.float64)

    (ju, jv, jt, jq, _), gf = jd.grid_tendencies(js, 0, jd.imp_double)
    stk, ncos = td.dynamics_stack(ts, 0)
    out = run_host(lib, td.sht.synthesis(stk, ncos), None, K).numpy()
    ug, vg, tgg, qg = (np.asarray(gf[k]) for k in ("ug", "vg", "tgg", "trg"))
    ref = {
        "psfield": (out[:1], -np.asarray(gf["umean"] * gf["px"]
                                         + gf["vmean"] * gf["py"])[None]),
        "ke": (out[1:1 + K], 0.5 * (ug * ug + vg * vg)),
        "ttend": (out[1 + K:1 + 2 * K], np.asarray(jt)),
        "qtend": (out[1 + 2 * K:1 + 3 * K], np.asarray(jq)[0]),
        "utend": (out[1 + 3 * K:1 + 4 * K], np.asarray(ju)),
        "-u tgg": (out[1 + 4 * K:1 + 5 * K], -ug * tgg),
        "-u q": (out[1 + 5 * K:1 + 6 * K], -ug * qg[0]),
        "vtend": (out[1 + 6 * K:1 + 7 * K], np.asarray(jv)),
        "-v tgg": (out[1 + 7 * K:1 + 8 * K], -vg * tgg),
        "-v q": (out[1 + 8 * K:], -vg * qg[0])}
    for name, (got, want) in ref.items():
        assert got.shape == want.shape, name
        floor = 1e-3 * np.abs(want).max()
        for a, b in zip(got, want):
            sig = max(np.abs(b - b.mean()).max(), floor)
            assert np.abs(a - b).max() <= 1e-10 * sig, name

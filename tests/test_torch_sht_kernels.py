"""The arithmetic of K6 (kernels/sht_synthesis.py) and K5
(kernels/sht_analysis.py) without a card.

kernels/csrc/sht_host.cpp compiles the header the CUDA kernels include
(sht.cuh) for the host with g++, with every thread of every block written
out as loops and the tile picked as a launch on a 132-SM H100 picks it,
beside a naive loop in the first designs' order.  At T30 and T10, at
every stack size and 1/cos split of the coupled cycle (K6: 50 fields from
32 on, 41 from 25, 32 from 16, 33 from 17; K5: 73 from 25, 33 from 17, 2
unscaled) and at one size that is not a multiple of the field tile, on
inputs made from a seed with numpy:
  - the tiled result equals the naive loop bit for bit;
  - every output is written exactly once;
  - it is within chip_smoke's SHT_RTOL of each field's scale of the plain
    PyTorch version (float32) and of the JAX package's spec_to_grid /
    grid_to_spec (float32 on the CPU).
K6_inject (the injection's synthesis with K18's glue as its phase 0,
inject_spectral.cuh) is built into the same library: at T30 with K = 8
and at T10 with K = 5 (and on tiles picked for fewer SMs), on
K5's analysis of seeded fields, its state and grid equal K18's
first-design blocks (glue_host.cpp) followed by K6's tiles bit for bit,
every grid output written once and every state element set (all start
as NaN).
The launch code itself runs only on a card (chip_smoke.py).
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

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.core.spectral import SpectralTransform
from speedy_ml_tpu_torch.kernels.sht_analysis import sht_analysis_plain
from speedy_ml_tpu_torch.kernels.sht_synthesis import sht_synthesis_plain

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
sys.path.insert(0, str(REPO))
from chip_smoke import SHT_RTOL  # noqa: E402  (the card check's tolerance)
from torch_lane import one_thread_per_pool  # noqa: E402, F401

GEOMS = {"T30": dict(trunc=30, nlon=96, nlat=48, nlev=8),
         "T10": dict(trunc=10, nlon=32, nlat=16, nlev=8)}
# an H100 SXM: its SMs and the opt-in shared memory of a block
SMS = 132
SMEM_MAX = 232448
# (B, fields scaled from) of the cycle's calls, and one size that is not a
# multiple of any field tile the launch picks at these shapes
SYN_CASES = [(50, 32), (41, 25), (32, 16), (33, 17), (13, 5)]
ANA_CASES = [(73, 25), (33, 17), (2, None), (11, 4)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/sht_host.cpp built with g++ and loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' arithmetic for the host")
    so = tmp_path_factory.mktemp("sht_host") / "libsht_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    str(CSRC / "sht_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sht_synthesis_host.argtypes = ([vp] * 4 + [i] * 6 + [vp, vp, i, ll,
                                                             vp])
    lib.sht_synthesis_naive.argtypes = [vp] * 4 + [i] * 6 + [vp]
    lib.sht_analysis_host.argtypes = ([vp] * 5 + [i] * 6 + [vp, vp, i, ll,
                                                            vp])
    lib.sht_analysis_naive.argtypes = [vp] * 5 + [i] * 6 + [vp]
    lib.sht_synthesis_host.restype = i
    lib.sht_analysis_host.restype = i
    lib.sht_synthesis_naive.restype = None
    lib.sht_analysis_naive.restype = None
    lib.inject_synthesis_host.argtypes = ([i] + [vp] * 5 + [i] * 4 + [vp] * 7
                                          + [i, ll, vp])
    lib.inject_synthesis_host.restype = i
    return lib


@pytest.fixture(scope="module")
def glue_lib(tmp_path_factory):
    """csrc/glue_host.cpp (K18's first-design blocks) built with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' arithmetic for the host")
    so = tmp_path_factory.mktemp("glue_host") / "libglue_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    str(CSRC / "glue_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.inject_block_host.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8
    return lib


@pytest.fixture(scope="module", params=sorted(GEOMS))
def tables(request):
    """The port's float32 transform and the JAX package's, one geometry."""
    kw = GEOMS[request.param]
    return (SpectralTransform(Geometry(**kw), dtype=torch.float32,
                              device="cpu"),
            JST(JGeometry(**kw), dtype=jnp.float32, zonal="dft"))


@pytest.fixture(scope="module")
def jax_refs(tables):
    """The JAX package's float32 transforms of every case's inputs, each
    kind in one call on all the cases' fields (one compile per shape)."""
    sht, jsht = tables
    g = sht.geom
    specs = np.concatenate([_spec(g, B, 10 + B).numpy()
                            for B, _ in SYN_CASES])
    v = jnp.asarray(specs)
    g1 = np.asarray(jsht.spec_to_grid(v, kcos=1))
    g2 = np.asarray(jsht.spec_to_grid(v, kcos=2))
    grids = []
    for B, n0 in ANA_CASES:
        x = _grid(g, B, 20 + B).numpy().copy()
        if n0 is not None:
            x[n0:] = x[n0:] * sht.cosgr.numpy()[:, None]
        grids.append(x)
    a = np.asarray(jsht.grid_to_spec(jnp.asarray(np.concatenate(grids))))
    refs, k = {}, 0
    for B, ncos in SYN_CASES:
        refs["syn", B] = np.concatenate([g1[k:k + ncos], g2[k + ncos:k + B]])
        k += B
    k = 0
    for B, _ in ANA_CASES:
        refs["ana", B] = np.stack([a[k:k + B].real, a[k:k + B].imag], -1)
        k += B
    return refs


def _ptr(t):
    if t is None:
        return None
    assert t.is_contiguous() and t.device.type == "cpu"
    return t.data_ptr()


def _close(got, ref, what):
    """max |got - ref| over each field, as a fraction of its max |ref|."""
    g = np.asarray(got).reshape(got.shape[0], -1)
    r = np.asarray(ref).reshape(ref.shape[0], -1)
    rel = (np.abs(g - r).max(axis=1) / np.abs(r).max(axis=1)).max()
    assert rel <= SHT_RTOL, f"{what}: {rel:.3e} of the field's scale"


def _spec(geom, B, seed):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(B, geom.mx, geom.nx))
         + 1j * rng.normal(size=(B, geom.mx, geom.nx)))
    return torch.as_tensor(v.astype(np.complex64))


def _grid(geom, B, seed):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(B, geom.nlat, geom.nlon)) * 10.0 + 3.0
    return torch.as_tensor(g.astype(np.float32))


def _same_bits(a, b):
    return np.array_equal(a.numpy().view(np.uint32), b.numpy().view(np.uint32))


@pytest.mark.parametrize("B,ncos", SYN_CASES)
def test_synthesis_tiles(host_lib, tables, jax_refs, B, ncos):
    sht, _ = tables
    g = sht.geom
    spec = _spec(g, B, 10 + B)
    args = (_ptr(spec), _ptr(sht.dft_inv), _ptr(sht.cpol_g), _ptr(sht.cosgr),
            ncos, B, g.nlat, g.nlon, g.mx, g.nx)
    out = torch.full((B, g.nlat, g.nlon), float("nan"))
    count = torch.zeros((B, g.nlat, g.nlon), dtype=torch.int32)
    tile = (ctypes.c_int * 4)()
    assert host_lib.sht_synthesis_host(*args, _ptr(out), _ptr(count), SMS,
                                       SMEM_MAX, tile) == 0
    naive = torch.empty_like(out)
    host_lib.sht_synthesis_naive(*args, _ptr(naive))
    assert bool((count == 1).all()), (
        f"outputs written {int(count.min())}..{int(count.max())} times, "
        f"tile {list(tile)}")
    assert _same_bits(out, naive), f"tile {list(tile)} differs from the loop"
    plain = sht_synthesis_plain(spec, sht.dft_inv, sht.cpol_even_g,
                                sht.cpol_odd_g, sht.cosgr, ncos)
    _close(out, plain, "against sht_synthesis_plain")
    _close(out, jax_refs["syn", B], "against the JAX package's spec_to_grid")


@pytest.mark.parametrize("B,n0", ANA_CASES)
def test_analysis_tiles(host_lib, tables, jax_refs, B, n0):
    sht, _ = tables
    g = sht.geom
    grid = _grid(g, B, 20 + B)
    pre = None if n0 is None else sht.cosgr
    args = (_ptr(grid), _ptr(sht.dft_fwd), _ptr(sht.wt), _ptr(sht.cpol_s),
            _ptr(pre), B if n0 is None else n0, B, g.nlat, g.nlon, g.mx,
            g.nx)
    out = torch.full((B, g.mx, g.nx), complex("nan+nanj"),
                     dtype=torch.complex64)
    count = torch.zeros((B, g.mx, g.nx), dtype=torch.int32)
    tile = (ctypes.c_int * 4)()
    assert host_lib.sht_analysis_host(*args, _ptr(out), _ptr(count), SMS,
                                      SMEM_MAX, tile) == 0
    naive = torch.empty_like(out)
    host_lib.sht_analysis_naive(*args, _ptr(naive))
    assert bool((count == 1).all()), (
        f"outputs written {int(count.min())}..{int(count.max())} times, "
        f"tile {list(tile)}")
    assert _same_bits(torch.view_as_real(out), torch.view_as_real(naive)), (
        f"tile {list(tile)} differs from the loop")
    plain = sht_analysis_plain(grid, sht.dft_fwd, sht.wt, sht.cpol_even_s,
                               sht.cpol_odd_s, pre, B if n0 is None else n0)
    _close(torch.view_as_real(out), torch.view_as_real(plain),
           "against sht_analysis_plain")
    _close(torch.view_as_real(out), jax_refs["ana", B],
           "against the JAX package's grid_to_spec")


# (geometry, K, SMs the tile is picked for): the card's 132 SMs (at T30L8
# 3 latitude pairs a block, 8 latitude groups); at T30L8 90 SMs give 5
# pairs a block in 5 groups, the last one ragged, and at K = 7 100 SMs 4
# pairs in 6 groups
INJECT_CASES = [("T30", 8, SMS), ("T10", 5, SMS), ("T30", 8, 90),
                ("T30", 7, 100)]


@pytest.mark.parametrize("geom,K,sms", INJECT_CASES)
def test_inject_synthesis_block(host_lib, glue_lib, geom, K, sms):
    """K6_inject's blocks (a warp per row m forming the block's field's
    coefficients from K5's rows and the tables, the neighbours exchanged,
    the state stored by two latitude groups, then K6's phases) against
    K18's blocks and K6's tiles one after the other, bit for bit."""
    g = Geometry(**dict(GEOMS[geom], nlev=K))
    sht = SpectralTransform(g, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(40 + K)
    field = lambda mean, sd: mean + sd * rng.normal(size=(K, g.nlat, g.nlon))
    grid = np.concatenate([field(250.0, 20.0),
                           np.maximum(field(5.0, 4.0), 0.0),
                           0.05 * rng.normal(size=(1, g.nlat, g.nlon)),
                           field(0.0, 15.0), field(0.0, 10.0)])
    spec = sht.analysis(torch.as_tensor(grid.astype(np.float32)),
                        2 * K + 1).contiguous()
    mx, nx, nlat, nlon, B = g.mx, g.nx, g.nlat, g.nlon, 4 * K
    nan = complex("nan+nanj")
    new = lambda *sh: torch.full(sh, nan, dtype=torch.complex64)
    shapes = dict(vor=(2, K, mx, nx), div=(2, K, mx, nx), t=(2, K, mx, nx),
                  ps=(2, mx, nx), tr=(2, 1, K, mx, nx))
    ref = {k: new(*v) for k, v in shapes.items()}
    stk = new(B, mx, nx)
    assert glue_lib.inject_block_host(
        K, 0, mx, nx, _ptr(spec), *(_ptr(ref[k]) for k in shapes), _ptr(stk),
        _ptr(sht.inject_blob)) == 0
    tabs = (_ptr(sht.dft_inv), _ptr(sht.cpol_g), _ptr(sht.cosgr))
    ref_grid = torch.full((B, nlat, nlon), float("nan"))
    count = torch.zeros((B, nlat, nlon), dtype=torch.int32)
    tile6 = (ctypes.c_int * 4)()
    assert host_lib.sht_synthesis_host(
        _ptr(stk), *tabs, 2 * K, B, nlat, nlon, mx, nx, _ptr(ref_grid),
        _ptr(count), sms, SMEM_MAX, tile6) == 0
    got = {k: new(*v) for k, v in shapes.items()}
    got_grid = torch.full((B, nlat, nlon), float("nan"))
    count.zero_()
    tile = (ctypes.c_int * 4)()
    assert host_lib.inject_synthesis_host(
        K, _ptr(spec), _ptr(sht.inject_blob), *tabs, nlat, nlon, mx, nx,
        *(_ptr(got[k]) for k in shapes), _ptr(got_grid), _ptr(count), sms,
        SMEM_MAX, tile) == 0
    # K6's tile at 4K fields, at 512 threads
    assert list(tile) == [tile6[0], tile6[1], 512, tile6[3]]
    assert bool((count == 1).all()), (
        f"outputs written {int(count.min())}..{int(count.max())} times, "
        f"tile {list(tile)}")
    assert not torch.isnan(got_grid).any()
    assert _same_bits(got_grid, ref_grid)
    for k in shapes:
        assert not torch.isnan(torch.view_as_real(got[k])).any(), k
        assert _same_bits(torch.view_as_real(got[k]),
                          torch.view_as_real(ref[k])), k

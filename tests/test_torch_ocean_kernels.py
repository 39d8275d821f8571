"""K22 slab_ocean's arithmetic without a card, and its ring.

kernels/csrc/glue_host.cpp compiles slab_ocean.cuh, the header K22
includes, for the host with g++ -ffp-contract=off; the tests hold its
per-element bodies (the push forms, a loop over every class's slot
elements; the SST form, a loop over the grid points) bit for bit against
slab_ocean_plain in float32 and float64, on the T10 layout of 128 regions
and on the T30 layout of 1,152 (the main path's shapes: W = 27 slots,
three classes), at steps whose logical order starts at each end of the
ring.  A mean summed in slot order instead of the logical order (oldest
first) must differ: the fault the order guards against.  The ring itself:
pushes into it are the JAX package's shifted buffer, rolled by step mod
W (ring_to_buffer, buffer_to_ring).  The launch code runs only on a card
(chip_smoke.py phase 13).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.esn.ocean import ocean_index_map
from speedy_ml_tpu_torch.kernels import slab_ocean as k22
from torch_lane import one_thread_per_pool  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
LAYOUTS = {"T10": (dict(trunc=10, nlon=32, nlat=16, nlev=8), 128),
           "T30": (dict(), 1152)}


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
    vp, i, ll, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_double)
    pv = ctypes.POINTER(vp)
    lib.slab_ocean_push_host.argtypes = [
        i, i, pv, pv, pv, pv, ctypes.POINTER(ll), ctypes.POINTER(i),
        ctypes.POINTER(i), i, i, d]
    lib.slab_ocean_sst_host.argtypes = [
        i, i, pv, pv, pv, ctypes.POINTER(ll), ctypes.POINTER(i), vp, vp, vp,
        ll, d, vp]
    return lib


@pytest.fixture(scope="module", params=list(LAYOUTS))
def layout(request):
    geom, n = LAYOUTS[request.param]
    return RegionLayout(Geometry(**geom), n_regions=n)


def operands(layout, dtype, W=27, seed=0):
    """Seeded operands of every form: per class the bottom feedback
    (Rc, I), the index map, a ring (W, Rc, I_o) and a standardized
    readout (Rc, 4) with its mean_sst and std_sst; the SstTable with a
    land fill on a seeded mask."""
    g = layout.geom
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a).to(dtype).contiguous()
    fbs, idx, bufs, outs, means, stds = [], [], [], [], [], []
    for cls in layout.classes:
        xi, yi = cls.input_shape
        I = (4 * g.nlev + 4) * xi * yi
        im = ocean_index_map(cls, g.nlev)
        fbs.append(t(rng.normal(0.0, 1.0, (cls.count, I))))
        idx.append(torch.as_tensor(im))
        bufs.append(t(rng.normal(0.0, 1.0, (W, cls.count, len(im)))))
        xc, yc = cls.core_shape
        outs.append(t(rng.normal(0.0, 1.0, (cls.count, xc * yc))))
        means.append(t(rng.uniform(280.0, 290.0, (cls.count, 1))))
        stds.append(t(rng.uniform(2.0, 6.0, (cls.count, 1))))
    land = rng.random((g.nlat, g.nlon)) < 0.3
    base = rng.uniform(250.0, 300.0, (g.nlat, g.nlon))
    table = k22.sst_table(layout, layout.classes, t(base),
                          torch.as_tensor(land), device="cpu", dtype=dtype)
    return fbs, idx, bufs, outs, means, stds, table


def _arr(ts):
    return (ctypes.c_void_p * len(ts))(*[None if x is None else x.data_ptr()
                                         for x in ts])


def host_push(lib, fbs, idx, bufs, step, mean):
    """K22's push forms built for the host; the means start as NaN."""
    dt = bufs[0].dtype
    W = bufs[0].shape[0]
    means = [torch.full(b.shape[1:], float("nan"), dtype=dt) for b in bufs] \
        if mean else [None] * len(bufs)
    ints = lambda xs: (ctypes.c_int * len(xs))(*xs)
    assert lib.slab_ocean_push_host(
        int(dt == torch.float64), len(bufs), _arr(fbs), _arr(idx), _arr(bufs),
        _arr(means), (ctypes.c_longlong * len(bufs))(
            *[b[0].numel() for b in bufs]),
        ints([b.shape[2] for b in bufs]), ints([f.shape[1] for f in fbs]), W,
        step % W, 1.0 / W) == 0
    return means if mean else None


def host_sst(lib, outs, means, stds, table):
    dt = outs[0].dtype
    sst = torch.full(table.shape, float("nan"), dtype=dt)
    assert lib.slab_ocean_sst_host(
        int(dt == torch.float64), len(outs), _arr(outs), _arr(means),
        _arr(stds), (ctypes.c_longlong * len(outs))(
            *[o.numel() for o in outs]),
        (ctypes.c_int * len(outs))(*[o.shape[1] for o in outs]),
        table.src.data_ptr(),
        None if table.base is None else table.base.data_ptr(),
        None if table.land is None else table.land.data_ptr(),
        table.shape[0] * table.shape[1], k22.SST_MIN, sst.data_ptr()) == 0
    return sst


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("step", [0, 26, 30])
@pytest.mark.parametrize("form", ["push", "push_mean"])
def test_host_push_forms_match_plain(lib, layout, dtype, step, form):
    """Bit for bit: the ring after the push (every slot) and the means."""
    fbs, idx, bufs, *_ = operands(layout, dtype)
    i32 = [i.to(torch.int32) for i in idx]
    ring_h = [b.clone() for b in bufs]
    ring_p = [b.clone() for b in bufs]
    got = host_push(lib, fbs, i32, ring_h, step, form == "push_mean")
    ref = k22.slab_ocean_plain(form, bufs=ring_p, step=step, fbs=fbs,
                               idx_maps=i32)
    for a, b in zip(ring_h, ring_p):
        assert torch.equal(a, b)
    if form == "push_mean":
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_host_sst_form_matches_plain(lib, layout, dtype):
    """Bit for bit, with a NaN output kept by the floor, a value below it
    raised to 272 K, and land points given the fill (floored too)."""
    *_, outs, means, stds, table = operands(layout, dtype)
    outs[1][0, 0] = float("nan")
    outs[1][0, 1] = -1e3
    got = host_sst(lib, outs, means, stds, table)
    ref = k22.slab_ocean_plain("sst", outs=outs, mean_sst=means,
                               std_sst=stds, table=table)
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert int(torch.isnan(got).sum()) <= 1
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    assert float(torch.nan_to_num(got, nan=300.0).min()) >= k22.SST_MIN
    assert torch.equal(got[table.land],
                       torch.clamp_min(table.base[table.land], k22.SST_MIN))
    # without the land fill the cores alone, every point covered once
    bare = table._replace(base=None, land=None)
    got = host_sst(lib, outs, means, stds, bare)
    ref = k22.slab_ocean_plain("sst", outs=outs, mean_sst=means,
                               std_sst=stds, table=bare)
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(ref))
    assert int((table.src < 0).sum()) == 0


def test_mean_in_slot_order_differs(lib, layout):
    """The negative control: at step 5 the logical order starts at slot
    6; summed from slot 0 the float32 means differ."""
    fbs, idx, bufs, *_ = operands(layout, torch.float32)
    i32 = [i.to(torch.int32) for i in idx]
    got = host_push(lib, fbs, i32, [b.clone() for b in bufs], 5, True)
    ring = [b.clone() for b in bufs]
    k22.slab_ocean_plain("push", bufs=ring, step=5, fbs=fbs, idx_maps=i32)
    W = ring[0].shape[0]
    wrong = []
    for b in ring:
        s = b[0].clone()
        for o in range(1, W):
            s = s + b[o]
        wrong.append(s * (1.0 / W))
    assert any(not torch.equal(a, w) for a, w in zip(got, wrong))


def test_host_refuses_arguments_that_do_not_fit(lib):
    fbs, idx, bufs, *_ = operands(t10_layout(), torch.float64, W=4)
    i32 = [i.to(torch.int32) for i in idx]
    mixed = [torch.zeros(b.shape[1:], dtype=torch.float64) for b in bufs]
    mixed[1] = None
    W = bufs[0].shape[0]
    ints = lambda xs: (ctypes.c_int * len(xs))(*xs)
    args = lambda means, slot, n: (
        1, n, _arr(fbs), _arr(i32), _arr(bufs), _arr(means),
        (ctypes.c_longlong * 3)(*[b[0].numel() for b in bufs]),
        ints([b.shape[2] for b in bufs]), ints([f.shape[1] for f in fbs]), W,
        slot, 1.0 / W)
    assert lib.slab_ocean_push_host(*args(mixed, 0, 3)) == 1
    assert lib.slab_ocean_push_host(*args([None] * 3, W, 3)) == 1
    assert lib.slab_ocean_push_host(*args([None] * 3, 0, 0)) == 1
    assert lib.slab_ocean_push_host(*args([None] * 3, W - 1, 3)) == 0


def t10_layout():
    return RegionLayout(Geometry(**LAYOUTS["T10"][0]),
                        n_regions=LAYOUTS["T10"][1])


def test_ring_is_the_jax_buffer_rolled():
    """Pushes into a ring from step 0 against the JAX package's buffer
    (concatenate(buffer[1:], new)): equal after every push, rolled by the
    next step mod W; and the slots' logical order."""
    W, R, I = 5, 3, 4
    rng = np.random.default_rng(1)
    buf = torch.as_tensor(rng.normal(size=(W, R, I)))
    ring = buf.clone()
    assert torch.equal(k22.buffer_to_ring(buf, 0), buf)
    idx = torch.arange(I, dtype=torch.int32)
    for step in range(13):
        fb = torch.as_tensor(rng.normal(size=(R, I)))
        buf = torch.cat([buf[1:], fb[None]])
        k22.slab_ocean_plain("push", bufs=[ring], step=step, fbs=[fb],
                             idx_maps=[idx])
        assert torch.equal(k22.ring_to_buffer(ring, step + 1), buf)
        assert torch.equal(k22.buffer_to_ring(buf, step + 1), ring)
        order = k22.ring_order(step, W)
        assert order[-1] == step % W and sorted(order) == list(range(W))
        assert torch.equal(ring[order], buf)

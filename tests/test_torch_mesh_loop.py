"""Port parity of the rest of the distributed code on the CPU in float64:
the slab ocean on a mesh (HybridAtmosphere.set_mesh with ocean packs,
slab_step), the cycle's row of scalars on a mesh, the batched prediction
loop on a meshed hybrid (run_prediction with cycles_per_dispatch > 1,
hybrid/graph.py), cgrate and RDF on a meshed GCM (K26's rows and range
forms, K25's sums and band forms), the mesh's move helpers
(parallel/mesh.py ShardMoves) and the training dry run
(parallel/train_dryrun.py); against the unsharded port and against the
JAX package on its 8-device host mesh.

The set-up is tests/test_torch_sharded_gcm.py's: T10 on a 32 x 16 grid
with 8 levels, nsteps_day = 8 (2 GCM steps a window), the synthetic
aquaplanet, an untrained coupled hybrid of 128 regions at m = 300, here
with seeded slab-ocean packs (m = 100, the hybrid slab readout), a land
fill on a seeded mask and SLAB_STRIDE 3 (slab steps at steps 2 and 5).
The port's meshes are Mesh(["cpu"] * D): the GCM at D = 8 and D = 3
(uneven m ranges and bands), the hybrid at D = 8 and D = 4 (its 16
longitude blocks do not split into 3 sectors).  The JAX side loads the
port's checkpoint and runs in one subprocess with one XLA thread, started
before the module's first case, while the port's cases run.

Tolerances:
- K25's and K26's mesh forms on the host build (optional_host.cpp, the
  kernels' headers; its blocks in both orders, also at T30's widths with
  levels, m ranges and band rows that do not divide into the kernels'
  8 blocks or chunks) against their plain versions, and the plain forms
  of every shard against the whole plain version's rows, ranges and
  bands: bit for bit;
- the slab ocean on a mesh with the GCM whole (shard_gcm=False), the
  meshed cycle with the row of scalars against it without, and the
  batched meshed loop against the eager meshed loop: bit for bit (none
  sums across shards in a new order); with the GCM sharded, cycles 1e-9
  of each variable's signal against the unsharded port;
- a meshed GCM window with cgrate_on and RDF: 1e-10 of each level's
  signal against the unsharded port (tests/test_torch_sharded_gcm.py's
  window bound: the plain versions' products of a sliced table round in
  the last bit on the CPU);
- against the JAX package's meshed runs: 1e-9 of each variable's signal
  for 7 coupled cycles with the slab ocean through two slab steps (the
  port's eager cycles and its run_prediction(cycles_per_dispatch=3),
  dispatches of 3, 3 and 1, against the JAX package's batched run of the
  same cycles, both hybrids with the GCM on the first device: the final
  states), and for the
  window with cgrate and RDF (each level's signal); the streams on disk
  at test_torch_dispatch.py's 1e-5 (the port's are float32).  The JAX
  batched driver runs with its per-cycle dates in float64: it makes
  them with np.float32 (ROADMAP C), which moves a float64 state by ~5e-9
  of a signal in three cycles against its own per-cycle path and the
  port.
"""

import copy
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from speedy_ml_tpu_torch.convert import ocean_states_to_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.data.checkpoint import save_hybrid
from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.esn.ocean import ocean_index_map
from speedy_ml_tpu_torch.esn.reservoir import (BatchedReservoir, ESNHyper,
                                               generate)
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid.build import build_untrained_hybrid
from speedy_ml_tpu_torch.hybrid.driver import run_prediction
from speedy_ml_tpu_torch.hybrid.model import (HybridAtmosphere, OceanPack,
                                              ocean_snapshot)
from speedy_ml_tpu_torch.kernels import cgrate as k26
from speedy_ml_tpu_torch.kernels import rdf as k25
from speedy_ml_tpu_torch.parallel import train_dryrun
from speedy_ml_tpu_torch.parallel.mesh import (GridShards, Mesh, Sharded,
                                               ShardMoves, band_rows,
                                               gather_rows, join_band_rows,
                                               lat_bands, m_ranges)
from speedy_ml_tpu_torch.physics import randfor
from speedy_ml_tpu_torch.physics.boundaries import synthetic_boundary_data
from torch_lane import one_thread_per_pool  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
N_REGIONS, M, NSD = 128, 300, 8
STEPS = 2
DATE = (1990, 7, 1)
START = (1990, 1, 31, 6)
STRIDE = 3
N_OCEAN, N_BATCHED, K = 3, 7, 3   # through the first slab step; the loops
F64 = torch.float64
ONE_THREAD_ENV = dict(
    XLA_FLAGS="--xla_force_host_platform_device_count=8 "
              "--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1",
    OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")

JAX_SIDE = """
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from speedy_ml_tpu.core.geometry import Geometry
from speedy_ml_tpu.core.spectral import SpectralTransform
from speedy_ml_tpu.data.calendar import ModelDate
from speedy_ml_tpu.data.checkpoint import load_hybrid
from speedy_ml_tpu.esn.domain import RegionLayout
from speedy_ml_tpu.gcm import GCM
from speedy_ml_tpu.hybrid.driver import run_prediction
from speedy_ml_tpu.parallel.mesh import make_mesh
from speedy_ml_tpu.physics.boundaries import synthetic_boundary_data

OUT = sys.argv[1]
prm = json.loads(sys.argv[2])
inp = dict(np.load(f"{OUT}/inputs.npz"))
mesh = make_mesh(prm["d"])
g = Geometry(**prm["geom"])
out, errs = {}, {}

def gcm_of(**kw):
    return GCM(g, dtype=jnp.float64, nsteps_day=prm["nsd"],
               bd=synthetic_boundary_data(
                   g, SpectralTransform(g, dtype=jnp.float64)), **kw)

def window(meshed):
    gcm = gcm_of(cgrate_on=True)
    gcm.phys.randfh = inp["randfh"]
    if meshed:
        gcm.set_mesh(mesh)
    s, f = gcm.init_state(ModelDate(*prm["date"]))
    s = gcm.stepone(s, f)
    s = gcm.run_window(s, f, prm["steps"])
    for k in ("vor", "div", "t", "ps", "tr"):
        out[f"win_{k}"] = np.asarray(getattr(s.spectral, k))
    out["win_randfv"] = np.asarray(s.radiation.randfv)

# the batched driver makes its per-cycle date arrays (fmon, tyear, the
# bias) with np.float32 before casting them to the model's dtype
# (hybrid/driver.py:243-248), which its per-cycle path does not
# (:164-168): read as float64 here, as the per-cycle path and the port
# carry the dates
import types
import speedy_ml_tpu.hybrid.driver as jdrv
jdrv.np = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                   if not k.startswith("__")})
jdrv.np.float32 = np.float64

def hybrid(meshed):
    layout = RegionLayout(g, n_regions=prm["regions"])
    hyb = load_hybrid(gcm_of(), layout, f"{OUT}/ckpt", dtype=jnp.float64)
    hyb.SLAB_STRIDE = prm["stride"]
    hyb.persist_surface = False
    if meshed:
        hyb.set_mesh(mesh, shard_gcm=False)
    s = hyb.init_state(jnp.asarray(inp["sst"]))
    fin, dates = run_prediction(
        hyb, s, ModelDate(*prm["start"]), prm["n"],
        output_path=f"{OUT}/pred", cycles_per_dispatch=prm["k"])
    out["run_dates"] = np.asarray(len(dates))
    out["run_sst"] = np.asarray(fin.sst_grid)
    out["run_safe"] = np.asarray(fin.safe)
    for i, cs in enumerate(fin.classes):
        for nm in ("x", "feedback", "local_model"):
            out[f"run_{i}_{nm}"] = np.asarray(getattr(cs, nm))
    for i, o in enumerate(fin.ocean):
        for nm in ("x", "buffer", "lm"):
            out[f"run_o{i}_{nm}"] = np.asarray(getattr(o, nm))

# each part on the host mesh; where the meshed run fails, the unsharded
# run of the same part (the failure is recorded)
for name, fn in (("window", window), ("hybrid", hybrid)):
    for meshed in (True, False):
        try:
            fn(meshed)
            out[f"{name}_meshed"] = np.asarray(meshed)
            break
        except Exception as e:
            errs[f"{name}_{'mesh' if meshed else 'whole'}"] = repr(e)[-3000:]
np.savez(f"{OUT}/outputs.npz", **out)
with open(f"{OUT}/errors.json", "w") as f:
    json.dump(errs, f)
"""


# ---------------------------------------------------------------- set-up

def _mesh(n):
    return Mesh(["cpu"] * n)


def _gcm(**kw):
    g = Geometry(**GEOM)
    return GCM(g, dtype=F64, nsteps_day=NSD, device="cpu",
               bd=synthetic_boundary_data(g, dtype=F64, device="cpu"), **kw)


def seeded_ocean_packs(hyb, seed: int = 9, hybrid_readout: bool = True):
    """Seeded untrained slab-ocean packs (m = 100) for hyb's classes; with
    hybrid_readout the readout also sees the previous output."""
    hyper = ESNHyper(m=100, sigma=0.6)
    out = []
    for i, cls in enumerate(hyb.layout.classes):
        idx = ocean_index_map(cls, hyb.nz)
        R, I = cls.count, len(idx)
        cols, vals, win, shifts = generate(seed + i, R, I, hyper, 0.9,
                                           dtype=F64, radius_iters=5,
                                           device="cpu")
        xc, yc = cls.core_shape
        O = xc * yc
        rng = np.random.default_rng(seed + 50 + i)
        A = vals.shape[2] + (O if hybrid_readout else 0)
        res = BatchedReservoir(
            cols=cols, vals=vals, win_vals=win,
            wout=torch.as_tensor(rng.normal(0.0, 1e-3, (R, O, A))),
            mean=torch.zeros((R, I), dtype=F64),
            std=torch.ones((R, I), dtype=F64), n_in=I, shifts=shifts)
        out.append(OceanPack(
            cls=cls, res=res, hyper=hyper, idx_map=idx,
            mean_sst=torch.full((R, 1), 288.0, dtype=F64),
            std_sst=torch.ones((R, 1), dtype=F64),
            hybrid_readout=hybrid_readout))
    return out


def with_ocean(hyb, seed: int = 9, hybrid_readout: bool = True):
    """hyb's atmosphere with seeded ocean packs, a land fill on a seeded
    mask and SLAB_STRIDE 3."""
    g = hyb.geom
    rng = np.random.default_rng(4)
    land = torch.as_tensor(rng.uniform(size=(g.nlat, g.nlon)) < 0.3)
    h = HybridAtmosphere(hyb.gcm, hyb.layout, hyb.packs, ml_only=hyb.ml_only,
                         ocean_packs=seeded_ocean_packs(hyb, seed,
                                                        hybrid_readout),
                         base_sst=torch.as_tensor(
                             287.0 + rng.normal(0.0, 2.0, (g.nlat, g.nlon))),
                         sea_mask=land.double(), device="cpu")
    h.SLAB_STRIDE = STRIDE
    return h


@pytest.fixture(scope="module")
def port():
    """The port's untrained coupled hybrid with the slab ocean."""
    base = build_untrained_hybrid(_gcm(), n_regions=N_REGIONS, m=M,
                                  radius_iters=10, device="cpu")
    return with_ocean(base)


@pytest.fixture(scope="module")
def randfh(port):
    return randfor.init_randfh(11, port.geom, port.gcm.sht)


@pytest.fixture(scope="module", autouse=True)
def jax_run(port, randfh, tmp_path_factory):
    """The JAX side in a subprocess, started before the module's first
    case; the cases that read it come last."""
    tmp = tmp_path_factory.mktemp("jax_mesh_loop")
    save_hybrid(port, str(tmp / "ckpt"))
    np.savez(tmp / "inputs.npz", sst=np.asarray(port.gcm.bd.sst12[0]),
             randfh=np.asarray(randfh, dtype=np.float64))
    prm = dict(d=8, geom=GEOM, nsd=NSD, regions=N_REGIONS, date=DATE,
               steps=STEPS, start=START, stride=STRIDE, n=N_BATCHED, k=K)
    with open(tmp / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SIDE, str(tmp), json.dumps(prm)],
            cwd=REPO, env=dict(os.environ, **ONE_THREAD_ENV),
            stdout=subprocess.DEVNULL, stderr=err)
    yield proc, tmp
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_out(jax_run):
    proc, tmp = jax_run
    rc = proc.wait(timeout=1200)
    assert rc == 0, (tmp / "stderr.txt").read_text()[-4000:]
    return dict(np.load(tmp / "outputs.npz")), tmp


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _signal_close(got, ref, rtol, variable=0):
    """|got - ref| <= rtol * signal + 2 ulps of ref, the signal of a
    variable its largest |ref - mean| (tests/test_torch_cycle.py's rule)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    label = np.broadcast_to(variable, ref.shape)
    signal = np.empty(ref.shape)
    for v in np.unique(label):
        sel = label == v
        signal[sel] = np.abs(ref[sel] - ref[sel].mean()).max()
    tol = rtol * signal + 2 * np.finfo(ref.dtype).eps * np.abs(ref)
    assert (np.abs(got - ref) <= tol).all(), float(
        (np.abs(got - ref) - tol).max())


def _level_close(got, ref, rtol):
    """Each (..., m, n) level within rtol of its signal, floored at 1e-3
    of the array's magnitude (tests/test_torch_sharded_gcm.py's rule)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    r = ref.reshape(-1, *ref.shape[-2:]) if ref.ndim > 2 else ref[None]
    g = got.reshape(r.shape)
    floor = 1e-3 * np.abs(r).max()
    for a, b in zip(g, r):
        scale = max(np.abs(b - b.mean()).max(), floor, 1e-300)
        assert np.abs(a - b).max() <= rtol * scale, (
            f"err {np.abs(a - b).max():.3e}, scale {scale:.3e}")


def _whole_ocean(state):
    """The ocean states gathered (the rings along their region axis) as
    numpy dicts in the JAX package's buffer order."""
    if state.ocean and isinstance(state.ocean[0].x, Sharded):
        state = type(state)(**{**state.__dict__, "ocean": tuple(
            type(o)(x=gather_rows(o.x, "cpu"),
                    buffer=gather_rows(o.buffer, "cpu", dim=1),
                    lm=None if o.lm is None else gather_rows(o.lm, "cpu"))
            for o in state.ocean)})
    return ocean_states_to_numpy(state.ocean, state.step)


def _same_states(a, b):
    """Two hybrid states (either sharded) equal bit for bit."""
    assert a.step == b.step
    assert torch.equal(a.sst_grid, b.sst_grid)
    for ca, cb in zip(a.classes, b.classes):
        for nm in ("x", "feedback", "local_model"):
            x, y = getattr(ca, nm), getattr(cb, nm)
            x = gather_rows(x, "cpu") if isinstance(x, Sharded) else x
            y = gather_rows(y, "cpu") if isinstance(y, Sharded) else y
            assert torch.equal(x, y), nm
    for oa, ob in zip(_whole_ocean(a), _whole_ocean(b)):
        for nm in ("x", "buffer", "lm"):
            np.testing.assert_array_equal(oa[nm], ob[nm], err_msg=nm)
    assert bool(a.safe) == bool(b.safe)


def _meshed(hyb, n, shard_gcm):
    h = copy.copy(hyb)
    h.set_mesh(_mesh(n), shard_gcm=shard_gcm)
    return h


def _dates(n):
    d, out = ModelDate(*START), []
    for _ in range(n):
        out.append((d.month - 1, d.tmonth, d.tyear))
        d = d.advance_hours(6)
    return out


# ------------------------------------------------------------- the helpers

def test_shard_moves_split_gather_and_count():
    """split_rows along a region axis that is not the first (the ocean
    ring's dim 1), gather_pieces onto one shard and all_gather_pieces
    onto every shard, in shard order; each move onto another shard
    counted, none within a shard."""
    mv = ShardMoves(_mesh(4))
    ring = torch.arange(2 * 8 * 3.0).reshape(2, 8, 3)
    parts = mv.split_rows(ring, dim=1)
    assert isinstance(parts, Sharded) and len(parts) == 4
    assert all(p.shape == (2, 2, 3) and p.is_contiguous() for p in parts)
    assert torch.equal(mv.gather_pieces(parts, dim=1), ring)
    pieces = [torch.full((2, 1), float(d)) for d in range(4)]
    for w in mv.all_gather_pieces(pieces, dim=1):
        assert torch.equal(w, torch.arange(4.0).expand(2, 4))
    assert mv.copies == 3 + 3 + 4 * 3
    assert mv.copy_bytes == (3 * 2 * 2 * 3 + 3 * 2 * 2 * 3 + 12 * 2) * 4
    with pytest.raises(ValueError, match="divisible"):
        mv.split_rows(ring, dim=2)


# ----------------------------------------------- K25 and K26, form by form

@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/optional_host.cpp built with g++ and loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' arithmetic for the host")
    so = tmp_path_factory.mktemp("optional_host") / "liboptional_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    str(CSRC / "optional_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pv = ctypes.POINTER(vp)
    lib.rdf_sums_host.argtypes = [i, i, i, i] + [vp] * 7 + [i]
    lib.rdf_band_host.argtypes = [i] * 7 + [vp] * 5 + [i]
    lib.cgrate_rows_host.argtypes = [i] * 5 + [pv, pv, vp, vp, i]
    lib.cgrate_range_host.argtypes = [i] * 6 + [pv, pv, vp, vp, pv, i, d, d,
                                               d, d, i]
    return lib


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


DTYPES = {"f64": (torch.float64, torch.complex128),
          "f32": (torch.float32, torch.complex64)}
# the host build's block orders: first to last, last to first
ORDERS = (0, 1)


def _rdf_sums_host(lib, x, order):
    K, rows, nlon = x.ttm.shape
    got = torch.full((2, K, rows), float("nan"), dtype=x.ttm.dtype)
    lib.rdf_sums_host(int(x.ttm.dtype == F64), K, rows, nlon,
                      *[a.data_ptr() for a in x], got.data_ptr(), order)
    return got


def _rdf_band_host(lib, tt_b, h_b, v_in, band, sums, order):
    K, _, nlon = tt_b.shape
    nlat = v_in.shape[1]
    got_tt = tt_b.clone()
    got_v = torch.full_like(v_in, float("nan"))
    lib.rdf_band_host(int(tt_b.dtype == F64), K, nlat, nlon, band[0],
                      band[1] - band[0], int(sums is not None),
                      got_tt.data_ptr(), h_b.data_ptr(), v_in.data_ptr(),
                      0 if sums is None else sums.data_ptr(),
                      got_v.data_ptr() if sums is not None else 0, order)
    return got_tt, got_v


def _cgrate_rows_host(lib, dv, s, o, order):
    K, mr, nx = s.vor.shape[1:]
    got = torch.full((2, 2, K, mr), float("nan"), dtype=dv.sht.elm2.dtype)
    lib.cgrate_rows_host(int(got.dtype == F64), K, mr, nx, dv.m0,
                         _ptrs([s.vor[0], s.div[0]]), _ptrs([o.vor, o.div]),
                         dv.sht.elm2.data_ptr(), got.data_ptr(), order)
    return got


def _cgrate_range_host(lib, dv, s, o, rows, j1, dt, eps, order):
    K, mr, nx = s.vor.shape[1:]
    got = [o.vor.clone(), o.div.clone()]
    lib.cgrate_range_host(
        int(rows.dtype == F64), K, rows.shape[-1], mr, nx, dv.m0,
        _ptrs([s.vor[0], s.div[0]]), _ptrs([s.vor[j1 - 1], s.div[j1 - 1]]),
        rows.data_ptr(), dv.sht.trfilt.data_ptr(), _ptrs(got),
        int(dv.geom.nlon == 4 * dv.geom.nlat_half), dt, dv.wil * eps,
        (1.0 - dv.wil) * eps, k26.GRMAX, order)
    return got


def _heating(g, rt, seed):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a).to(rt).contiguous()
    K = g.nlev
    sh = (K, g.nlat, g.nlon)
    sig = 0.5 * (np.asarray(g.half_sigma)[1:] + np.asarray(g.half_sigma)[:-1])
    return k25.RdfHeating(t(rng.normal(0, 1e-5, sh)),
                          t(rng.normal(0, 1e-5, sh)),
                          t(rng.normal(0, 1.0, sh)),
                          t(1.0 / rng.uniform(0.6, 1.0, sh[1:])),
                          t(np.linspace(1e-3, 2e-3, K)),
                          randfor.rdf_weights(sig, g.nlon, rt))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", [3, 8])
def test_k25_forms_bit_for_bit(lib, port, randfh, dt, D):
    """K25 on the bands of D shards: the sums form of each band and the
    band form (with the gathered sums on a shortwave step, the carried
    randfv on another), host build against the plain forms and the plain
    forms against the whole plain version's bands, bit for bit; the new
    randfv whole and the same on every band."""
    rt, _ = DTYPES[dt]
    g = port.geom
    K, nlat, nlon = g.nlev, g.nlat, g.nlon
    grid = GridShards(_mesh(D), nlat, g.mx)
    xs = _heating(g, rt, 31)
    h = torch.as_tensor(randfh).to(rt)
    v_in = torch.as_tensor(np.random.default_rng(32).normal(
        0, 1e-5, (2, nlat, K))).to(rt)
    tt = torch.as_tensor(np.random.default_rng(33).normal(
        0, 1e-5, (K, nlat, nlon))).to(rt)
    for shortwave in (True, False):
        ref_tt, ref_v = k25.rdf_plain(tt.clone(), h, v_in,
                                      xs if shortwave else None)
        band_xs = [k25.RdfHeating(*(
            band_rows(a, b, nlat) if a.dim() >= 2 and a.shape[-2] == nlat
            else a for a in xs)) for b in grid.bands]
        sums = None
        if shortwave:
            parts = [k25.rdf_sums_plain(x) for x in band_xs]
            for x, p in zip(band_xs, parts):
                for order in ORDERS:
                    assert torch.equal(_rdf_sums_host(lib, x, order), p)
            sums = grid.all_bands(parts, dim=-1)
        outs = []
        for d, b in enumerate(grid.bands):
            tt_b, h_b = band_rows(tt, b, nlat), band_rows(h, b, nlat)
            sm = None if sums is None else sums[d]
            pt, pv = k25.rdf_band_plain(tt_b.clone(), h_b, v_in, b, sm)
            for order in ORDERS:
                got_tt, got_v = _rdf_band_host(lib, tt_b, h_b, v_in, b, sm,
                                               order)
                assert torch.equal(got_tt, pt)
                if shortwave:
                    assert torch.equal(got_v, pv)
            assert torch.equal(pv, ref_v)
            outs.append(pt)
        assert torch.equal(grid.join_bands(outs), ref_tt)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", [3, 8])
def test_k26_forms_bit_for_bit(lib, port, dt, D):
    """K26 on the m ranges of D shards (the ranges' views of a meshed
    GCM's dycore): the rows form of each range and the range form from
    the gathered rows, host build against the plain forms and the plain
    forms against the whole plain version's ranges, bit for bit; the
    damping triggers (vor grows fast)."""
    rt, ct = DTYPES[dt]
    gcm = _gcm(cgrate_on=True) if rt == F64 else GCM(
        port.geom, dtype=rt, nsteps_day=NSD, device="cpu", cgrate_on=True,
        bd=synthetic_boundary_data(port.geom, dtype=rt, device="cpu"))
    m = copy.copy(gcm)
    m.set_mesh(_mesh(D))
    g = gcm.geom
    rng = np.random.default_rng(41)
    shp = (2, g.nlev, g.mx, g.nx)
    c = lambda a: torch.as_tensor(a).to(ct).contiguous()
    f = rng.normal(0, 1e-5, shp) + 1j * rng.normal(0, 1e-5, shp)
    state = SpectralState(vor=c(f), div=c(f[::-1].copy()), t=c(f), ps=c(f[0]),
                          tr=c(f[None]))
    tend = lambda a: torch.stack([c(a), torch.zeros_like(c(a))])
    fdt = 3e-5 * f[0] + 1e-9 * rng.normal(size=shp[1:])
    out = SpectralState(vor=tend(fdt), div=tend(1e-9 * f[1]), t=c(f),
                        ps=c(f[0]), tr=c(f[None]))
    ref = k26.cgrate_plain(gcm.dyn, state, copy.deepcopy(out), 2, 900.0, 0.05)
    _, cd = k26.damp_plain(state.vor[0], out.vor[0], gcm.dyn.sht.elm2)
    assert float(cd) > 0
    rng_ = lambda s, m0, m1: type(s)(**{
        k: getattr(s, k)[..., m0:m1, :].contiguous()
        for k in SpectralState.FIELDS})
    dyns, grid = m.sdyn.dyns, m.grid
    parts = [rng_(state, *r) for r in grid.ranges]
    outs = [rng_(out, *r) for r in grid.ranges]
    rows = [k26.cgrate_rows_plain(dv, s, o) for dv, s, o in
            zip(dyns, parts, outs)]
    for dv, s, o, r in zip(dyns, parts, outs, rows):
        for order in ORDERS:
            assert torch.equal(_cgrate_rows_host(lib, dv, s, o, order), r)
    whole = grid.all_ranges(rows, dim=-1)
    assert torch.equal(whole[0], k26.cgrate_rows_plain(gcm.dyn, state, out))
    for d, (dv, s, o) in enumerate(zip(dyns, parts, outs)):
        new = k26.cgrate_range_plain(dv, s, copy.deepcopy(o), whole[d], 2,
                                     900.0, 0.05)
        m0, m1 = grid.ranges[d]
        for nm in ("vor", "div"):
            assert torch.equal(getattr(new, nm),
                               getattr(ref, nm)[..., m0:m1, :])
        for order in ORDERS:
            got = _cgrate_range_host(lib, dv, s, o, whole[d], 2, 900.0, 0.05,
                                     order)
            assert torch.equal(got[0], new.vor)
            assert torch.equal(got[1], new.div)


def _t30_dycore(rt, K, m0=0, m1=31):
    """A stand-in for a T30 DycoreModel with K levels, or its view of the
    m range [m0, m1): what K26's plain forms and the host build read."""
    rng = np.random.default_rng(50 + K)
    elm2 = torch.as_tensor(rng.uniform(0.1, 1.0, (31, 32))).to(rt)
    trfilt = torch.as_tensor(rng.uniform(0.0, 1.0, (31, 32))).to(rt)
    sht = SimpleNamespace(elm2=elm2[m0:m1].contiguous(),
                          trfilt=trfilt[m0:m1].contiguous())
    geom = SimpleNamespace(nlon=96, nlat_half=24, nlev=K, mx=31, nx=32)
    return SimpleNamespace(sht=sht, geom=geom, wil=0.53, m0=m0)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("K,D", [(3, 3), (11, 8)])
def test_k26_forms_uneven(lib, dt, K, D):
    """K26's rows and range forms at T30's widths on the m ranges of D
    shards (uneven: 11, 10, 10 or 4 and 3), with K levels that underfill
    or overfill the range form's cluster: host build in both block orders
    against the plain forms, and the plain ranges against the whole plain
    version, bit for bit; vor's damping triggers."""
    rt, ct = DTYPES[dt]
    whole = _t30_dycore(rt, K)
    ranges = m_ranges(31, D)
    dyns = [_t30_dycore(rt, K, *r) for r in ranges]
    rng = np.random.default_rng(80 + K)
    shp = (2, K, 31, 32)
    c = lambda a: torch.as_tensor(a).to(ct).contiguous()
    f = rng.normal(0, 1e-5, shp) + 1j * rng.normal(0, 1e-5, shp)
    sp = lambda v, d: SimpleNamespace(vor=v, div=d)
    state = sp(c(f), c(f[::-1].copy()))
    out = sp(c(np.stack([1e-3 * f[0], 0 * f[0]])),
             c(np.stack([1e-9 * f[1], 0 * f[1]])))
    mk = lambda o: SpectralState(vor=o.vor, div=o.div, t=o.vor, ps=o.vor[0],
                                 tr=o.vor[None])
    ref = k26.cgrate_plain(whole, state, mk(copy.deepcopy(out)), 2, 900.0,
                           0.05)
    _, cd = k26.damp_plain(state.vor[0], out.vor[0], whole.sht.elm2)
    assert float(cd) > 0
    cut = lambda x, m0, m1: sp(x.vor[..., m0:m1, :].contiguous(),
                               x.div[..., m0:m1, :].contiguous())
    parts = [(cut(state, *r), cut(out, *r)) for r in ranges]
    rows = [k26.cgrate_rows_plain(dv, s_, o_)
            for dv, (s_, o_) in zip(dyns, parts)]
    gathered = torch.cat(rows, dim=-1).contiguous()
    assert torch.equal(gathered, k26.cgrate_rows_plain(whole, state, out))
    for dv, (s_, o_), r, (m0, m1) in zip(dyns, parts, rows, ranges):
        new = k26.cgrate_range_plain(dv, s_, mk(copy.deepcopy(o_)), gathered,
                                     2, 900.0, 0.05)
        assert torch.equal(new.vor, ref.vor[..., m0:m1, :])
        assert torch.equal(new.div, ref.div[..., m0:m1, :])
        for order in ORDERS:
            assert torch.equal(_cgrate_rows_host(lib, dv, s_, o_, order), r)
            got = _cgrate_range_host(lib, dv, s_, o_, gathered, 2, 900.0,
                                     0.05, order)
            assert torch.equal(got[0], new.vor)
            assert torch.equal(got[1], new.div)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("nlat,D", [(46, 2), (20, 3)])
def test_k25_forms_uneven(lib, dt, nlat, D):
    """K25's sums and band forms on the bands of D shards whose rows do not
    divide into the kernels' 8 chunks (46 latitudes on 2 bands: 24 and 22
    rows, chunks of 3 and a last one of 1; 20 on 3: 8, 6 and 6 rows,
    chunks of 1): host build in both block orders against the plain forms,
    and the plain forms against the whole plain version, bit for bit
    (K = 5, nlon = 96)."""
    rt, _ = DTYPES[dt]
    K, nlon = 5, 96
    rng = np.random.default_rng(90 + nlat)
    t = lambda a: torch.as_tensor(a).to(rt).contiguous()
    sh = (K, nlat, nlon)
    xs = k25.RdfHeating(t(rng.normal(0, 1e-5, sh)), t(rng.normal(0, 1e-5, sh)),
                        t(rng.normal(0, 1.0, sh)),
                        t(1.0 / rng.uniform(0.6, 1.0, sh[1:])),
                        t(np.linspace(1e-3, 2e-3, K)),
                        t(rng.uniform(0.5, 1.5, (2, K)) / nlon))
    h = t(rng.normal(0, 1.0, (2, nlat, nlon)))
    v_in = t(rng.normal(0, 1e-5, (2, nlat, K)))
    tt = t(rng.normal(0, 1e-5, sh))
    bands = lat_bands(nlat, D)
    cut = lambda a, b: band_rows(a, b, nlat).contiguous()
    band_xs = [k25.RdfHeating(*(cut(a, b) if a.dim() >= 2
                                and a.shape[-2] == nlat else a for a in xs))
               for b in bands]
    parts = [k25.rdf_sums_plain(x) for x in band_xs]
    for x, p in zip(band_xs, parts):
        for order in ORDERS:
            assert torch.equal(_rdf_sums_host(lib, x, order), p)
    sums = join_band_rows(parts, bands, dim=-1).contiguous()
    assert torch.equal(sums, k25.rdf_sums_plain(xs))
    for shortwave in (True, False):
        ref_tt, ref_v = k25.rdf_plain(tt.clone(), h, v_in,
                                      xs if shortwave else None)
        outs = []
        for b in bands:
            sm = sums if shortwave else None
            pt, pv = k25.rdf_band_plain(cut(tt, b), cut(h, b), v_in, b, sm)
            assert torch.equal(pv, ref_v)
            for order in ORDERS:
                got_tt, got_v = _rdf_band_host(lib, cut(tt, b), cut(h, b),
                                               v_in, b, sm, order)
                assert torch.equal(got_tt, pt)
                if shortwave:
                    assert torch.equal(got_v, pv)
            outs.append(pt)
        assert torch.equal(join_band_rows(outs, bands), ref_tt)


# ------------------------------------------------- cgrate and RDF on a mesh

@pytest.fixture(scope="module")
def cg_rdf(randfh):
    """An unsharded GCM with cgrate and RDF, and its window from stepone
    (the shortwave) and STEPS leapfrog steps."""
    gcm = _gcm(cgrate_on=True)
    gcm.phys.randfh = randfh
    s0, f = gcm.init_state(ModelDate(*DATE))
    return gcm, s0, f, gcm.run_window(gcm.stepone(s0, f), f, STEPS)


def _close_window(got, ref, rtol):
    for k in SpectralState.FIELDS:
        _level_close(getattr(got.spectral, k), getattr(ref.spectral, k),
                     rtol)
    _level_close(got.radiation.randfv.permute(0, 2, 1),
                 ref.radiation.randfv.permute(0, 2, 1), rtol)


@pytest.mark.parametrize("D", [3, 8])
def test_cgrate_rdf_window_matches_unsharded(cg_rdf, D):
    """GCM.set_mesh with cgrate_on and randfh set: stepone and STEPS
    leapfrog steps on D shards against the unsharded window, 1e-10 of
    each level's signal; randfv whole and the same on every shard, and
    nonzero (RDF ran)."""
    gcm, s0, f, ref = cg_rdf
    m = copy.copy(gcm)
    m.set_mesh(_mesh(D))
    assert [p.band for p in m.phys_bands] == [tuple(b)
                                              for b in m.grid.bands]
    s = m.run_window(m.stepone(s0, f), f, STEPS)
    v = s.radiation[0].randfv
    assert v.shape == (2, 16, 8) and float(v.abs().max()) > 0
    assert all(torch.equal(r.randfv, v) for r in s.radiation)
    _close_window(m.gather_state(s), ref, 1e-10)


# ------------------------------------------------ the slab ocean on a mesh

@pytest.mark.parametrize("D", [4, 8])
def test_slab_ocean_on_a_mesh_bit_for_bit(port, D):
    """set_mesh(mesh, shard_gcm=False) with the slab ocean: N_OCEAN + 1
    cycles through the slab step at step 2 (K22's pushes, K1 and K2 of
    the ocean on each shard, K22's SST form whole) against the unsharded
    cycles, bit for bit; the rings, x and lm sharded by regions; the
    ocean's parameters sharded as the atmosphere's."""
    sh = _meshed(port, D, False)
    assert all(len(sp) == D for sp in sh._sharded_opacks)
    for sp, op in zip(sh._sharded_opacks, port.ocean_packs):
        assert torch.equal(torch.cat([p.mean_sst for p in sp]), op.mean_sst)
        assert [p.res.vals.shape[1] for p in sp] == [op.cls.count // D] * D
    sst = port.gcm.bd.sst12[0]
    a, b = port.init_state(sst), sh.init_state(sst)
    assert isinstance(b.ocean[0].buffer, Sharded)
    assert b.ocean[0].buffer[0].shape[1] == port.ocean_packs[0].cls.count // D
    for imon, fmon, tyear in _dates(N_OCEAN + 1):
        a, da = port.cycle(a, imon, fmon, tyear)
        b, db = sh.cycle(b, imon, fmon, tyear)
        for k in ("atmo", "logp", "precip", "speedy_atmo", "speedy_logp"):
            assert torch.equal(da[k], db[k]), k
        _same_states(a, b)
    assert not torch.equal(b.sst_grid, sst)


def test_slab_ocean_with_the_gcm_sharded_matches_unsharded(port):
    """set_mesh(mesh) (the GCM sharded too) with the slab ocean on 8
    shards through the slab step: 1e-9 of each variable's signal against
    the unsharded cycles."""
    sh = _meshed(port, 8, True)
    sst = port.gcm.bd.sst12[0]
    a, b = port.init_state(sst), sh.init_state(sst)
    for imon, fmon, tyear in _dates(N_OCEAN):
        a, da = port.cycle(a, imon, fmon, tyear)
        b, db = sh.cycle(b, imon, fmon, tyear)
    _signal_close(b.sst_grid, a.sst_grid, 1e-9)
    for oa, ob in zip(_whole_ocean(a), _whole_ocean(b)):
        for nm in ("x", "buffer", "lm"):
            _signal_close(ob[nm], oa[nm], 1e-9)
    _signal_close(db["atmo"], da["atmo"], 1e-9,
                  np.arange(32).reshape(4, 8, 1, 1))


def test_the_vertical_groups_still_refuse_the_slab_ocean(port):
    """The JAX package refuses the slab ocean with vertical localization
    (train_hybrid), and so does the port, mesh or no mesh."""
    packs = [p._replace(zspec=object()) for p in port.packs]
    with pytest.raises(NotImplementedError, match="vertical"):
        HybridAtmosphere(port.gcm, port.layout, packs,
                         ocean_packs=port.ocean_packs,
                         base_sst=port.base_sst, sea_mask=port.sea_mask,
                         device="cpu")


# ------------------------------------------------ the row of scalars on a mesh

def _tables(g):
    rng = np.random.default_rng(17)
    return (287.0 + rng.normal(0, 1, (365, g.nlat, g.nlon)),
            300.0 + 50 * rng.uniform(size=(16, g.nlat, g.nlon)))


@pytest.mark.parametrize("case", ["ocean", "tables_persist", "ml_only"])
def test_the_row_on_a_mesh_equals_the_host_numbers(port, case):
    """The meshed cycle handed the row of scalars (K17, K21 and K23 read
    it on the first device, each shard's K3 and K22 its slices copied
    there) against the meshed cycle without it, bit for bit over four
    cycles: with the slab ocean through its slab step (K22's slot), with
    the SST and TISR tables and the persistent surface (K23, K3's table
    row on the haloed sectors, K21), and the ML-only cycle (each shard's
    K3 the date)."""
    if case == "ocean":
        h = port
    elif case == "ml_only":
        h = build_untrained_hybrid(port.gcm, n_regions=N_REGIONS, m=M,
                                   ml_only=True, radius_iters=10,
                                   device="cpu")
    else:
        h = HybridAtmosphere(port.gcm, port.layout, port.packs,
                             device="cpu")
    if case == "tables_persist":
        sst_t, tisr_t = _tables(port.geom)
        h.set_sst_table(sst_t)
        h.set_tisr_table(tisr_t, hours_per_entry=6)
        h.persist_surface = True
    sh = _meshed(h, 4, False)
    sst = port.gcm.bd.sst12[0]
    a = sh.init_state(sst)
    b = ocean_snapshot(a)
    d = ModelDate(*START)
    from speedy_ml_tpu_torch.data.calendar import hour_of_year_365
    for _ in range(4):
        args = (d.month - 1, d.tmonth, d.tyear, hour_of_year_365(d), 0.5)
        row = torch.tensor(sh.scalar_row(*args, step=b.step), dtype=F64)
        a, da = sh.cycle_with_params(sh.params, a, *args)
        b, db = sh.cycle_with_params(sh.params, b, *args, scalars=row)
        for k in ("atmo", "logp", "precip"):
            assert torch.equal(da[k], db[k]), k
        _same_states(a, b)
        d = d.advance_hours(6)


# ---------------------------------------- the batched loop on a meshed hybrid

@pytest.mark.parametrize("shard_gcm", [False, True])
def test_batched_meshed_loop_matches_eager(port, tmp_path, shard_gcm):
    """run_prediction(cycles_per_dispatch=3) on the meshed hybrid with the
    slab ocean, 7 cycles (dispatches of 3, 3 and 1, slab steps at 2 and
    5), against the eager meshed loop: the streams and the final state
    (Sharded, as the eager loop's) bit for bit; with the GCM whole also
    against the unsharded loop, bit for bit."""
    sh = _meshed(port, 8, shard_gcm)
    sst = port.gcm.bd.sst12[0]
    runs = []
    for h, k in ((sh, K), (sh, 1)) + (((port, 1),) if not shard_gcm else ()):
        out = tmp_path / f"{h is sh}_{k}"
        fin, dates = run_prediction(h, h.init_state(sst), ModelDate(*START),
                                    N_BATCHED, output_path=str(out / "p"),
                                    cycles_per_dispatch=k)
        assert len(dates) == N_BATCHED and fin.step == N_BATCHED
        runs.append((fin, dict(np.load(out / "p.npz"))))
    assert isinstance(runs[0][0].classes[0].x, Sharded)
    assert isinstance(runs[0][0].ocean[0].buffer, Sharded)
    for fin, stream in runs[1:]:
        _same_states(runs[0][0], fin)
        for k, v in runs[0][1].items():
            np.testing.assert_array_equal(v, stream[k], err_msg=k)


def test_a_meshed_copy_gets_its_own_dispatcher(port, tmp_path):
    """A hybrid that has run the batched loop and its copy on a mesh
    (set_mesh runs on copy.copy(hyb)) each dispatch their own cycle: the
    copy kept the original's CycleDispatch, whose cycles are the
    unsharded hybrid's, before graph.dispatcher checked its owner."""
    from speedy_ml_tpu_torch.hybrid.graph import dispatcher
    sst = port.gcm.bd.sst12[0]
    h = copy.copy(port)
    run_prediction(h, h.init_state(sst), ModelDate(*START), 2,
                   cycles_per_dispatch=2)
    sh = _meshed(h, 4, False)
    assert dispatcher(sh).hyb is sh and dispatcher(h).hyb is h
    fin, _ = run_prediction(sh, sh.init_state(sst), ModelDate(*START), 2,
                            cycles_per_dispatch=2)
    assert isinstance(fin.classes[0].x, Sharded)


# --------------------------------------------------- the training dry run

def test_train_dryrun_on_the_cpu():
    """dryrun_m6000 at m = 600 on 2 CPU shards (2 interior regions a
    shard): each Gram shard (1, A, A)-sized on its device, Wout finite and
    sharded; the residency check refuses a view of a larger block."""
    mesh = _mesh(2)
    out = train_dryrun.dryrun_m6000(mesh, m=600, regions_per_shard=2,
                                    log=lambda *_: None)
    assert out["regions"] == 4 and out["A"] == out["S"] + out["n"]
    assert out["gram_shard_bytes"] == 2 * out["A"] ** 2 * 4
    big = torch.zeros((4, 3, 3))
    train_dryrun.check_residency(Sharded((torch.zeros((2, 3, 3)),
                                          torch.zeros((2, 3, 3)))),
                                 mesh, 2, 3)
    with pytest.raises(AssertionError, match="view"):
        train_dryrun.check_residency(Sharded((big[:2], big[2:])), mesh, 2, 3)
    with pytest.raises(AssertionError, match="sharded"):
        train_dryrun.check_residency(big, mesh, 2, 3)


# ------------------------------------------------------- against the JAX package

def test_jax_side_ran_on_its_mesh(jax_out):
    """The JAX package's meshed window and hybrid runs both ran on its
    host mesh (where one fails, the cases below compare with its
    unsharded run and this case fails with its error)."""
    out, tmp = jax_out
    errs = json.loads((tmp / "errors.json").read_text())
    assert bool(out["window_meshed"]) and bool(out["hybrid_meshed"]), errs


def test_meshed_ocean_cycles_match_jax(port, jax_out):
    """N_BATCHED eager coupled cycles with the slab ocean through its slab
    steps at steps 2 and 5 on 8 shards against the JAX package's meshed
    batched run of the same cycles: the new SST grid, the ocean states
    and every class's states, 1e-9 of each variable's signal.  Both
    hybrids keep the GCM on the first device (shard_gcm=False): inside
    the JAX package's batched loop its sharded GCM takes twice as long
    to compile, and the sharded GCM is held against the JAX package's
    here in the window with cgrate and RDF and in
    tests/test_torch_sharded_gcm.py's cycles."""
    out, _ = jax_out
    sh = _meshed(port, 8, False)
    s = sh.init_state(port.gcm.bd.sst12[0])
    for imon, fmon, tyear in _dates(N_BATCHED):
        s, _ = sh.cycle(s, imon, fmon, tyear)
    _close_to_jax(s, out)


def _close_to_jax(s, out):
    assert s.step == N_BATCHED == int(out["run_dates"])
    _signal_close(s.sst_grid, out["run_sst"], 1e-9)
    for i, o in enumerate(_whole_ocean(s)):
        for nm in ("x", "buffer", "lm"):
            _signal_close(o[nm], out[f"run_o{i}_{nm}"], 1e-9)
    for i, cs in enumerate(s.classes):
        for nm in ("x", "feedback", "local_model"):
            _signal_close(gather_rows(getattr(cs, nm), "cpu"),
                          out[f"run_{i}_{nm}"], 1e-9)
    assert bool(s.safe) == bool(out["run_safe"])


def test_meshed_batched_loop_matches_jax(port, jax_out, tmp_path):
    """run_prediction(cycles_per_dispatch=3) over 7 cycles on the meshed
    hybrid (8 shards, the GCM on the first device as the JAX side's, the
    slab ocean) against the JAX package's batched run on its mesh: the
    final states 1e-9 of each variable's signal, the streams at 1e-5."""
    out, tmp = jax_out
    sh = _meshed(port, 8, False)
    fin, dates = run_prediction(sh, sh.init_state(port.gcm.bd.sst12[0]),
                                ModelDate(*START), N_BATCHED,
                                output_path=str(tmp_path / "p"),
                                cycles_per_dispatch=K)
    assert len(dates) == N_BATCHED
    _close_to_jax(fin, out)
    got = np.load(tmp_path / "p.npz")
    ref = np.load(tmp / "pred.npz")
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[k]).max(),
                                   err_msg=k)


def test_meshed_cgrate_rdf_window_matches_jax(cg_rdf, jax_out):
    """The window with cgrate and RDF on 8 shards against the JAX
    package's meshed GCM with both: 1e-9 of each level's signal, the
    carried randfv included."""
    out, _ = jax_out
    gcm, s0, f, _ = cg_rdf
    m = copy.copy(gcm)
    m.set_mesh(_mesh(8))
    s = m.gather_state(m.run_window(m.stepone(s0, f), f, STEPS))
    for k in SpectralState.FIELDS:
        _level_close(getattr(s.spectral, k), out[f"win_{k}"], 1e-9)
    _level_close(s.radiation.randfv.permute(0, 2, 1),
                 np.moveaxis(out["win_randfv"], 1, 2), 1e-9)

"""Port parity of the hub-free sharded cycle (speedy_ml_tpu_torch/parallel,
hybrid/sharded.py, HybridAtmosphere.set_mesh, solve_wout_sharded and
dryrun_multichip) against the JAX package on its 8-device host mesh, on
the CPU in float64.

The port's mesh is D torch.device("cpu") shards (Mesh(["cpu"] * D)); the
JAX package's is make_mesh(D) over the host devices of tests/conftest.py.
The set-up is T10 on a 32 x 16 grid with 8 levels, 128 regions of 2 x 2
points (classes of 16, 96 and 16, 16 lon blocks), m = 300, 2 GCM steps a
window, the synthetic aquaplanet: tests/test_torch_cycle.py's (32
regions at m <= 600 would leave the interior class no nodes).  The port
builds the hybrid and saves it; the JAX side loads that checkpoint and
runs, in one subprocess with one XLA thread, while the port's own cases
run.  Tolerances:
- halo_lon and halo_exchange_lat for overlaps 1 and 2: exact;
- assemble (with and without the clamps), feedback and local_model, with
  and without vertical groups: 1e-12 of the reference's scale;
- two sharded cycles against the JAX sharded cycle (set_mesh(mesh,
  shard_gcm=False)): 1e-9 of each variable's signal (test_torch_cycle's
  rule); against the port's own unsharded cycle: exact, for D = 2, 4, 8
  and with the ML-only cycle, the persistent surface, the climatology
  tables and the readout's components;
- solve_wout_sharded: Wout 1e-8 of its scale at a ridge of 1e-2;
- the error paths raise the JAX package's messages; the captured loop
  and the slab ocean run on a mesh.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.data.checkpoint import save_hybrid
from speedy_ml_tpu_torch.esn.domain import vert_specs
from speedy_ml_tpu_torch.esn.reservoir import BatchedReservoir, ESNHyper
from speedy_ml_tpu_torch.esn.standardize import Standardizer
from speedy_ml_tpu_torch.esn.train import NormalEq, solve_wout, \
    solve_wout_sharded
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid import sharded
from speedy_ml_tpu_torch.hybrid.build import build_untrained_hybrid
from speedy_ml_tpu_torch.hybrid.driver import run_prediction
from speedy_ml_tpu_torch.hybrid.model import ClassPack
from speedy_ml_tpu_torch.parallel import halo, mesh as tmesh
from speedy_ml_tpu_torch.parallel.dryrun import dryrun_multichip
from speedy_ml_tpu_torch.parallel.mesh import Mesh, gather_rows
from speedy_ml_tpu_torch.physics.boundaries import synthetic_boundary_data
from torch_lane import one_thread_per_pool  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
NZ = 8
N_REGIONS, M, NSD = 128, 300, 8
D = 8
GROUPS, OVERLAP = 2, 1
DATES = [(0, 0.5, 0.05), (0, 0.5 + 0.25 / 31, 0.05 + 0.25 / 365)]
HYPER = dict(beta_res=0.1, beta_model=1.0)   # a ridge of 1e-2
F64 = torch.float64
ONE_THREAD_ENV = dict(
    XLA_FLAGS="--xla_force_host_platform_device_count=8 "
              "--xla_cpu_multi_thread_eigen=false "
              "intra_op_parallelism_threads=1",
    OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")

JAX_SIDE = """
import dataclasses, json, sys, types
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P
from speedy_ml_tpu.core.geometry import Geometry
from speedy_ml_tpu.core.spectral import SpectralTransform
from speedy_ml_tpu.data.checkpoint import load_hybrid
from speedy_ml_tpu.esn.domain import RegionLayout, vert_specs
from speedy_ml_tpu.esn.reservoir import ESNHyper
from speedy_ml_tpu.esn.train import NormalEq, solve_wout_sharded
from speedy_ml_tpu.gcm import GCM
from speedy_ml_tpu.hybrid.model import ClassPack
from speedy_ml_tpu.hybrid.sharded import (ShardedCycleOps, _PackTables,
                                          halo_lon)
from speedy_ml_tpu.parallel.halo import halo_exchange_lat, lat_sharding
from speedy_ml_tpu.parallel.mesh import make_mesh
from speedy_ml_tpu.physics.boundaries import synthetic_boundary_data

OUT = sys.argv[1]
prm = json.loads(sys.argv[2])
inp = dict(np.load(f"{OUT}/inputs.npz"))
D, nz = prm["d"], prm["nz"]
mesh = make_mesh(D)
out, msgs = {}, {}
for o in (1, 2):
    f = jax.device_put(jnp.asarray(inp["lat_field"]), lat_sharding(mesh, 2))
    out[f"lat_{o}"] = np.asarray(halo_exchange_lat(f, o, mesh))
    spec = P(None, None, "regions")
    out[f"lon_{o}"] = np.asarray(shard_map(
        lambda a, o=o: halo_lon(a, o, "regions", D), mesh=mesh,
        in_specs=(spec,), out_specs=spec)(jnp.asarray(inp["lon_field"])))

g = Geometry(**prm["geom"])
gcm = GCM(g, dtype=jnp.float64, nsteps_day=prm["nsd"],
          bd=synthetic_boundary_data(g, SpectralTransform(g,
                                                          dtype=jnp.float64)))
layout = RegionLayout(g, n_regions=prm["regions"])
hyb = load_hybrid(gcm, layout, f"{OUT}/ckpt", dtype=jnp.float64)

zpacks = []
for c, cls in enumerate(layout.classes):
    for z, vs in enumerate(vert_specs(nz, prm["groups"], prm["overlap"])):
        k = f"z{c}_{z}_"
        std = types.SimpleNamespace(**{
            nm: jnp.asarray(inp[k + nm])
            for nm in ("in_mean", "in_std", "out_mean", "out_std")})
        zpacks.append(ClassPack(
            cls=cls, res=types.SimpleNamespace(n_speedy=int(inp[k + "S"])),
            hyper=None, std=std, zspec=vs))
fields = [jnp.asarray(inp[k]) for k in ("atmo", "logp", "precip", "sst",
                                        "tisr")]
for tag, packs in (("full", hyb.packs), ("z", zpacks)):
    ops = ShardedCycleOps(layout, packs, mesh)
    vecs = [jnp.asarray(inp[f"ov_{tag}_{i}"]) for i in range(len(packs))]
    # jitted: an eager shard_map compiles each of its operations
    for clamp in (True, False):
        a, l, p = jax.jit(lambda v, clamp=clamp: ops.assemble(
            packs, v, nz, jnp.float64, clamp=clamp))(vecs)
        for nm, v in zip(("atmo", "logp", "precip"), (a, l, p)):
            out[f"asm_{tag}_{int(clamp)}_{nm}"] = np.asarray(v)
    fb = jax.jit(lambda *f: ops.feedback(packs, *f))(*fields)
    for i, v in enumerate(fb):
        out[f"fb_{tag}_{i}"] = np.asarray(v)
    lm = jax.jit(lambda a, l: ops.local_model(packs, a, l, nz))(
        jnp.asarray(inp["fc_atmo"]), fields[1])
    for i, v in enumerate(lm):
        out[f"lm_{tag}_{i}"] = np.asarray(v)

eq = NormalEq(ss=jnp.asarray(inp["ss"]), st=jnp.asarray(inp["st"]))
out["wout"] = np.asarray(solve_wout_sharded(
    eq, ESNHyper(**prm["hyper"]), int(inp["S"]), mesh))

def message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None
cls = layout.classes[1]
msgs["devices"] = message(lambda: ShardedCycleOps(layout, hyb.packs,
                                                  make_mesh(3)))
msgs["count"] = message(lambda: _PackTables(layout, cls, 5))
msgs["order"] = message(lambda: _PackTables(layout, dataclasses.replace(
    cls, region_ids=cls.region_ids[::-1]), D))
msgs["blocks"] = message(lambda: _PackTables(layout, dataclasses.replace(
    cls, iy_core=np.zeros_like(cls.iy_core)), D))
with open(f"{OUT}/messages.json", "w") as f:
    json.dump(msgs, f)

hyb.set_mesh(mesh, shard_gcm=False)
s = hyb.init_state(jnp.asarray(inp["sst"]))
for c, (imon, fmon, tyear) in enumerate(prm["dates"]):
    s, d = hyb.cycle(s, jnp.asarray(imon), jnp.asarray(fmon),
                     jnp.asarray(tyear))
    for k in ("atmo", "logp", "precip", "speedy_atmo", "speedy_logp"):
        out[f"cyc{c}_{k}"] = np.asarray(d[k])
    for i, cs in enumerate(s.classes):
        for nm in ("x", "feedback", "local_model"):
            out[f"cyc{c}_{i}_{nm}"] = np.asarray(getattr(cs, nm))
    # uncommitted inputs again, as in the first call: no second compile
    s = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)), s)
np.savez(f"{OUT}/outputs.npz", **out)
"""


def _mesh(n=D):
    return Mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def port():
    """The port's GCM and untrained coupled hybrid (float64, on the CPU)."""
    g = Geometry(**GEOM)
    gcm = GCM(g, dtype=F64, nsteps_day=NSD, device="cpu",
              bd=synthetic_boundary_data(g, dtype=F64, device="cpu"))
    hyb = build_untrained_hybrid(gcm, n_regions=N_REGIONS, m=M,
                                 radius_iters=10, device="cpu")
    assert [p.cls.count for p in hyb.packs] == [16, 96, 16]
    return hyb


def _zspec_arrays(hyb, rng):
    """The vertical groups' statistics (two groups of levels a class): a
    dict of numpy arrays by (class, group)."""
    lay = hyb.layout
    out = {}
    for c, cls in enumerate(lay.classes):
        for z, vs in enumerate(vert_specs(NZ, GROUPS, OVERLAP)):
            b = vs.bottom
            I = lay.pack_table(cls, 4, NZ, logp=b, precip=b, sst=b,
                               tisr=True, levels=(vs.zi0, vs.zi1)).shape[1]
            O = lay.core_table(cls, 4, NZ, vs).shape[1]
            S = lay.pack_table(cls, 4, NZ, logp=b, precip=False, sst=False,
                               tisr=False, core_only=True,
                               levels=(vs.z0, vs.z1)).shape[1]
            k = f"z{c}_{z}_"
            R = cls.count
            out[k + "in_mean"] = rng.normal(size=(R, I))
            out[k + "in_std"] = 0.5 + rng.random((R, I))
            out[k + "out_mean"] = rng.normal(size=(R, O))
            out[k + "out_std"] = 0.5 + rng.random((R, O))
            out[k + "S"] = np.asarray(S)
    return out


@pytest.fixture(scope="module")
def inputs(port):
    """The seeded inputs both sides read."""
    hyb = port
    g = hyb.geom
    rng = np.random.default_rng(26)
    shape = (g.nlat, g.nlon)
    inp = dict(
        lat_field=rng.standard_normal((48, 96)),
        lon_field=rng.standard_normal((2, g.nlat, g.nlon)),
        atmo=rng.standard_normal((4, NZ) + shape),
        logp=rng.standard_normal(shape),
        precip=np.abs(rng.standard_normal(shape)),
        sst=np.asarray(hyb.gcm.bd.sst12[0]),
        tisr=np.abs(rng.standard_normal(shape)),
        fc_atmo=rng.standard_normal((4, NZ) + shape))
    inp.update(_zspec_arrays(hyb, rng))
    for i, p in enumerate(hyb.packs):
        inp[f"ov_full_{i}"] = 250.0 + rng.standard_normal(
            (p.cls.count, p.res.n_outputs))
    for i, (zp, _, _) in enumerate(_zpacks(hyb, inp)):
        # values about the clamps' thresholds, so that both branches run
        inp[f"ov_z_{i}"] = 1e-5 * rng.standard_normal(
            (zp.cls.count, zp.res.n_outputs))
    # normal equations of 16 regions: A = 12 (S = 4), O = 5, 40 samples
    aug = rng.standard_normal((16, 40, 12))
    inp["ss"] = np.einsum("rta,rtb->rab", aug, aug)
    inp["st"] = np.einsum("rto,rta->roa", rng.standard_normal((16, 40, 5)),
                          aug)
    inp["S"] = np.asarray(4)
    return inp


def _zpacks(hyb, inp):
    """(pack, local-model mean, local-model std) of each vertical group:
    _identity_pack's, with the statistics of inp."""
    packs = []
    for c, cls in enumerate(hyb.layout.classes):
        for z, vs in enumerate(vert_specs(NZ, GROUPS, OVERLAP)):
            k = f"z{c}_{z}_"
            S = int(inp[k + "S"])
            packs.append(_identity_pack(cls, inp[k + "out_mean"].shape[1],
                                        inp[k + "in_mean"], inp[k + "in_std"],
                                        inp[k + "out_mean"][:, :S],
                                        inp[k + "out_std"][:, :S], vs))
    return packs


def _identity_pack(cls, O, in_mean, in_std, lm_mean, lm_std, zspec=None):
    """A port ClassPack whose readout returns the vector it is given:
    Wout = [identity | 0] (R, O, O + 2) on a local model of O values and a
    state of two zeros, out_mean 0 and out_std 1; with the input
    statistics (R, I) and the local model's (R, S) given.  Returns (the
    pack, the local model's mean and std)."""
    R = cls.count
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=F64)
    wout = torch.cat([torch.eye(O, dtype=F64).expand(R, O, O),
                      torch.zeros((R, O, 2), dtype=F64)], dim=2)
    zeros = torch.zeros((R, O), dtype=F64)
    res = BatchedReservoir(cols=torch.zeros((2, 1), dtype=torch.int32),
                           vals=torch.zeros((1, R, 2), dtype=F64),
                           win_vals=torch.zeros((R, 2), dtype=F64),
                           wout=wout.contiguous(), mean=t(in_mean),
                           std=t(in_std), n_in=in_mean.shape[1])
    std = Standardizer(comp_mean=zeros, comp_std=zeros, in_mean=t(in_mean),
                       in_std=t(in_std), out_mean=zeros,
                       out_std=torch.ones((R, O), dtype=F64))
    pack = ClassPack(cls=cls, res=res, hyper=ESNHyper(), std=std,
                     zspec=zspec)
    return pack, t(lm_mean), t(lm_std)


@pytest.fixture(scope="module", autouse=True)
def jax_run(port, inputs, tmp_path_factory):
    """The JAX side started in a subprocess on the port's checkpoint and
    inputs, before the module's first case; it runs while the port's own
    cases do (the cases that read it come last).  Yields (the process,
    its directory)."""
    tmp = tmp_path_factory.mktemp("jax_sharded")
    save_hybrid(port, str(tmp / "ckpt"))
    np.savez(tmp / "inputs.npz", **inputs)
    prm = dict(d=D, nz=NZ, geom=GEOM, nsd=NSD, regions=N_REGIONS,
               groups=GROUPS, overlap=OVERLAP, hyper=HYPER,
               dates=[list(d) for d in DATES])
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
    return dict(np.load(tmp / "outputs.npz")), json.loads(
        (tmp / "messages.json").read_text())


def _scale_close(got, ref, rtol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, f"{err:.3e} > {rtol:.0e} x {scale:.3e}"


def _signal_close(got, ref, rtol, variable=0):
    """|got - ref| <= rtol * signal + 2 ulps of ref, the signal of a
    variable its largest |ref - mean| (tests/test_torch_cycle.py's rule)."""
    got, ref = got.detach().numpy(), np.asarray(ref)
    label = np.broadcast_to(variable, ref.shape)
    signal = np.empty(ref.shape)
    for v in np.unique(label):
        sel = label == v
        signal[sel] = np.abs(ref[sel] - ref[sel].mean()).max()
    tol = rtol * signal + 2 * np.finfo(ref.dtype).eps * np.abs(ref)
    assert (np.abs(got - ref) <= tol).all(), float(
        (np.abs(got - ref) - tol).max())


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def test_mesh_and_its_helpers():
    """Mesh, make_mesh (never a silently smaller mesh), shard_rows and
    gather_rows, shard_reservoir and pad_regions."""
    m = _mesh(4)
    assert m.size == 4 and m.axis == "regions"
    assert "4 shards on cpu" in repr(m)
    with pytest.raises(RuntimeError, match="visible"):
        tmesh.make_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match="visible"):
        tmesh.make_mesh(2, device_type="cpu")
    assert tmesh.make_mesh(1, device_type="cpu").devices == (
        torch.device("cpu"),)
    t = torch.arange(24.0).reshape(8, 3)
    sh = tmesh.shard_rows(t, m)
    assert isinstance(sh, tmesh.Sharded) and len(sh) == 4
    assert [tuple(s.shape) for s in sh] == [(2, 3)] * 4
    assert torch.equal(gather_rows(sh, "cpu"), t)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_rows(t, _mesh(3))
    res = BatchedReservoir(
        cols=torch.zeros((5, 2), dtype=torch.int32),
        vals=torch.arange(2 * 8 * 5.0).reshape(2, 8, 5),
        win_vals=torch.ones((8, 5)), wout=torch.ones((8, 3, 7)),
        mean=torch.zeros((8, 4)), std=torch.ones((8, 4)), n_in=4)
    parts = tmesh.shard_reservoir(res, m)
    assert [p.vals.shape for p in parts] == [(2, 2, 5)] * 4
    assert all(p.vals.is_contiguous() for p in parts)
    assert torch.equal(torch.cat([p.vals for p in parts], 1), res.vals)
    assert all(p.cols is res.cols for p in parts)
    per = dataclasses.replace(res, cols=torch.zeros((8, 5, 2),
                                                    dtype=torch.int32))
    assert [p.cols.shape for p in tmesh.shard_reservoir(per, m)] == \
        [(2, 5, 2)] * 4
    assert [tmesh.pad_regions(n, 8) for n in (1, 8, 9, 1056)] == \
        [8, 8, 16, 1056]


def _ops_and_packs(port, inputs, zspec, n=D):
    """(ShardedCycleOps, its ShardedPacks, the JAX tag, the local-model
    statistics) of the main packs or of the vertical groups' identity
    packs."""
    hyb = port
    if zspec:
        z = _zpacks(hyb, inputs)
    else:
        z = [_identity_pack(p.cls, p.res.n_outputs, p.std.in_mean,
                            p.std.in_std, p.std.out_mean[:, :p.res.n_speedy],
                            p.std.out_std[:, :p.res.n_speedy])
             for p in hyb.packs]
    packs = [p for p, _, _ in z]
    ops = sharded.ShardedCycleOps(hyb.layout, packs, _mesh(n), NZ)
    sp = [s._replace(lm_mean=tmesh.shard_rows(a, ops.mesh),
                     lm_std=tmesh.shard_rows(b, ops.mesh))
          for s, (_, a, b) in zip(ops.shard_params(packs), z)]
    return ops, sp, ("z" if zspec else "full")


@pytest.mark.parametrize("zspec", [False, True])
def test_tables_gather_the_plain_windows(port, inputs, zspec):
    """The sector tables K2 stores through and K3 gathers through hold
    the plain windows (_pack_window, the JAX package's gathers): every
    window element is the haloed sector's element the table names."""
    ops, _, _ = _ops_and_packs(port, inputs, zspec)
    g = port.geom
    W, o = ops.W, port.layout.overlap
    rng = np.random.default_rng(3)
    fields = [_t(rng.standard_normal((4, NZ, g.nlat, W + 2 * o)))] + [
        _t(rng.standard_normal((g.nlat, W + 2 * o))) for _ in range(4)]
    src = torch.cat([f.reshape(-1) for f in fields])
    core = [f[..., o:o + W].contiguous() for f in fields]
    csrc = torch.cat([core[0].reshape(-1)] + [core[1].reshape(-1)] * 4)
    specs = ([None] * 3 if not zspec
             else list(vert_specs(NZ, GROUPS, OVERLAP)) * 3)
    for i, (tbl, zs) in enumerate(zip(ops.tables, specs)):
        b = zs is None or zs.bottom
        lo, hi = (0, NZ) if zs is None else (zs.zi0, zs.zi1)
        want = sharded._pack_window(
            tbl, fields[0][:, lo:hi],
            (fields[1] if b else None, fields[2] if b else None,
             fields[3] if b else None, fields[4]), core=False)
        assert torch.equal(src[ops.feedback_index[i][0].long()], want)
        lo, hi = (0, NZ) if zs is None else (zs.z0, zs.z1)
        want = sharded._pack_window(tbl, core[0][:, lo:hi],
                                    (core[1] if b else None,), core=True)
        assert torch.equal(csrc[ops.local_index[i][0].long()], want)
    # the store tables tile the sector once (checked at construction)
    n = sum(t[0].numel() for t in ops.store)
    assert n == ops.sector_size


def _sharded_copy(hyb, n=D):
    h = copy.copy(hyb)
    h.set_mesh(_mesh(n), shard_gcm=False)
    return h


def _same_cycles(h, sh, sst, n=2):
    """n cycles of h and of its sharded twin sh from init_state(sst):
    every diagnostic and every class's state equal bit for bit."""
    a, b = h.init_state(sst), sh.init_state(sst)
    for imon, fmon, tyear in DATES[:n]:
        a, da = h.cycle(a, imon, fmon, tyear, hour_of_year=600)
        b, db = sh.cycle(b, imon, fmon, tyear, hour_of_year=600)
        assert sorted(da) == sorted(db)
        for k in da:
            assert (da[k] is None and db[k] is None) or torch.equal(
                da[k], db[k]), k
        for ca, cb in zip(a.classes, b.classes):
            for nm in ("x", "feedback", "local_model"):
                assert torch.equal(getattr(ca, nm),
                                   gather_rows(getattr(cb, nm), "cpu")), nm
        assert torch.equal(a.sst_grid, b.sst_grid)
        assert bool(a.safe) == bool(b.safe)
    return b


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_cycles_equal_the_unsharded(port, n):
    """The sharded cycle on n shards is the unsharded one bit for bit;
    the shards move the expected tensors between them."""
    sh = _sharded_copy(port, n)
    s = _same_cycles(port, sh, port.gcm.bd.sst12[0])
    assert all(len(cs.x) == n for cs in s.classes)
    # a cycle: the sectors to shard 0, the SST and TISR sectors and the
    # forecast's out, and two halo moves a shard
    assert sh._sharded_ops.copies == 2 * (3 * (n - 1) + 2 * n)


@pytest.mark.parametrize("option", ["ml_only", "persist_surface", "tables",
                                    "components"])
def test_sharded_cycle_options_equal_the_unsharded(port, option):
    """The branches of the cycle the sharded path runs: the ML-only cycle
    (its TISR plane handed to the devices), the persistent surface, the
    SST and TISR tables (K23 and a table's row) and the readout's
    components (their grids joined like the fields)."""
    h = copy.copy(port)
    g = port.geom
    if option == "ml_only":
        h = build_untrained_hybrid(port.gcm, n_regions=N_REGIONS, m=M,
                                   radius_iters=10, ml_only=True,
                                   device="cpu")
    elif option == "persist_surface":
        h.persist_surface = True
    elif option == "tables":
        rng = np.random.default_rng(4)
        sst = np.asarray(port.gcm.bd.sst12[0])
        h.set_sst_table(sst + rng.normal(0, 1, (365, g.nlat, g.nlon)))
        h.set_tisr_table(np.abs(rng.normal(300, 50, (1460, g.nlat, g.nlon))),
                         hours_per_entry=6)
    else:
        h.emit_components = True
    s = _same_cycles(h, _sharded_copy(h, 4), port.gcm.bd.sst12[0])
    if option == "persist_surface":
        assert s.sfc is not None and s.fluxes is not None


def test_start_prediction_shards_its_state(port):
    """start_prediction on a meshed hybrid gives the unsharded state's
    rows, split over the shards."""
    sh = _sharded_copy(port, 4)
    rng = np.random.default_rng(5)
    g = port.geom
    truth = dict(atmo=250 + rng.normal(0, 1, (3, 4, NZ, g.nlat, g.nlon)),
                 logp=rng.normal(0, 0.1, (3, g.nlat, g.nlon)),
                 precip=np.abs(rng.normal(0, 1e-4, (3, g.nlat, g.nlon))),
                 sst=np.tile(np.asarray(port.gcm.bd.sst12[0]), (3, 1, 1)),
                 tisr=np.abs(rng.normal(300, 10, (3, g.nlat, g.nlon))))
    a = port.start_prediction(truth, None, port.gcm.bd.sst12[0])
    b = sh.start_prediction(truth, None, port.gcm.bd.sst12[0])
    for ca, cb in zip(a.classes, b.classes):
        for nm in ("x", "feedback", "local_model"):
            assert torch.equal(getattr(ca, nm),
                               gather_rows(getattr(cb, nm), "cpu"))
    assert sh.shard_state(b) is b


def test_dryrun_multichip_on_cpu():
    """The dry run at the production layout (T30, 1,152 regions, m = 600,
    2 steps a window) on 8 CPU shards: the sharded cycle, the training
    step and the lat halos equal their single-device counterparts."""
    lines = []
    secs = dryrun_multichip(8, _mesh(), m=600, log=lines.append)
    assert sorted(secs) == ["cycle", "halo", "training"]
    assert lines[-1].startswith("dryrun_multichip OK on 8 devices")
    with pytest.raises(ValueError, match="the mesh has 4"):
        dryrun_multichip(8, _mesh(4))


def test_the_mesh_cycle_runs_the_hybrids_own_parameters(port):
    """set_mesh shards the hybrid's parameters once and cast_wout_bf16
    shards them anew; a cycle handed other parameters on a mesh raises
    instead of running the shards of stale ones."""
    sh = _sharded_copy(port, 2)
    assert [r.wout.dtype for r in sh._sharded_packs[1].res] == [F64] * 2
    s = sh.init_state(port.gcm.bd.sst12[0])
    atmo, ocean = sh.params
    other = (tuple((dataclasses.replace(r), st) for r, st in atmo), ocean)
    with pytest.raises(ValueError, match="own parameters"):
        sh.cycle_with_params(other, s, 0, 0.5, 0.05)
    sh.cast_wout_bf16()
    for sp, p in zip(sh._sharded_packs, sh.packs):
        assert torch.equal(torch.cat([r.wout.float() for r in sp.res]),
                           p.res.wout.float())
        assert all(r.wout.dtype == torch.bfloat16 for r in sp.res)


def test_the_distributed_gcm_options_raise(port):
    """What a mesh refused before now runs on a
    mesh, none refused and none falling back: the captured loop
    (run_prediction with cycles_per_dispatch > 1, here the CPU's eager
    dispatch, and a cycle handed the row of scalars), each bit for bit
    the eager meshed cycles, and the slab ocean (set_mesh with ocean
    packs, the GCM whole or sharded), whose rings are then sharded.
    tests/test_torch_mesh_loop.py holds them against the unsharded port
    and the JAX package."""
    from test_torch_mesh_loop import with_ocean
    sh = _sharded_copy(port, 2)
    s = sh.init_state(port.gcm.bd.sst12[0])
    batched, dates = run_prediction(sh, s, ModelDate(1990, 1, 1), 3,
                                    cycles_per_dispatch=2)
    eager, _ = run_prediction(sh, s, ModelDate(1990, 1, 1), 3)
    assert len(dates) == 3 and len(batched.classes[0].x) == 2
    for a, b in zip(batched.classes, eager.classes):
        assert torch.equal(gather_rows(a.x, "cpu"), gather_rows(b.x, "cpu"))
    row = torch.tensor(sh.scalar_row(0, 0.5, 0.05), dtype=F64)
    _, d_row = sh.cycle_with_params(sh.params, s, 0, 0.5, 0.05, scalars=row)
    _, d_host = sh.cycle(s, 0, 0.5, 0.05)
    assert torch.equal(d_row["atmo"], d_host["atmo"])
    ocean = with_ocean(port)
    for shard_gcm in (False, True):
        h = copy.copy(ocean)
        h.set_mesh(_mesh(2), shard_gcm=shard_gcm)
        st, _ = h.cycle(h.init_state(port.gcm.bd.sst12[0]), 0, 0.5, 0.05)
        assert all(len(o.buffer) == 2 for o in st.ocean)


@pytest.mark.parametrize("overlap", [1, 2])
def test_halo_lon_matches_jax(inputs, jax_out, overlap):
    out, _ = jax_out
    f = _t(inputs["lon_field"])
    W = f.shape[-1] // D
    got = sharded.halo_lon(tmesh.shard_rows(f, _mesh(), dim=2), overlap)
    assert torch.equal(torch.cat(list(got), dim=-1),
                       _t(out[f"lon_{overlap}"]))
    # one sector wraps onto itself
    one = sharded.halo_lon([f], overlap)[0]
    assert torch.equal(one[..., overlap:-overlap], f)
    assert torch.equal(one[..., :overlap], f[..., -overlap:])
    assert W + 2 * overlap == got[0].shape[-1]


@pytest.mark.parametrize("overlap", [1, 2])
def test_halo_exchange_lat_matches_jax(inputs, jax_out, overlap):
    out, _ = jax_out
    m = _mesh()
    f = _t(inputs["lat_field"])
    got = halo.halo_exchange_lat(halo.lat_shards(f, m), overlap, m)
    stacked = gather_rows(got, "cpu", dim=0)
    assert torch.equal(stacked, _t(out[f"lat_{overlap}"]))
    band = f.shape[0] // D
    assert torch.equal(halo.haloed_band(stacked, 1, band, overlap), got[1])
    assert bool((got[0][:overlap] == 0).all())


@pytest.mark.parametrize("zspec", [False, True])
def test_assemble_matches_jax(port, inputs, jax_out, zspec):
    """K2's store of each device's regions into its sector (the readout
    of an identity Wout returns the given vectors): the sectors joined
    equal the JAX assemble, with the clamps and (the components form's
    v_p) without them."""
    out, _ = jax_out
    ops, sp, tag = _ops_and_packs(port, inputs, zspec)
    m = ops.mesh
    vecs = [tmesh.shard_rows(_t(inputs[f"ov_{tag}_{i}"]), m)
            for i in range(len(sp))]
    xs = [tmesh.shard_rows(torch.zeros((v.shape[0] * D, 2), dtype=F64), m)
          for v in (vv[0] for vv in vecs)]
    grids = ops.assemble(sp, xs, vecs, components=True)
    flat = ops.gather(grids, "cpu")
    from speedy_ml_tpu_torch.kernels.core_scatter import split_grid
    for clamp, row in ((1, 0), (0, 1)):
        got = split_grid(flat[row], 4, NZ, 16, 32)
        for nm, v in zip(("atmo", "logp", "precip"), got):
            _scale_close(v, out[f"asm_{tag}_{clamp}_{nm}"], 1e-12)
    # the v_ml part of an all-zero state is zero; the sector views are
    # the joined grids'
    assert not bool(flat[2].any())
    a, lp, pr = ops.sector_fields(grids)
    assert torch.equal(torch.cat(list(a), -1),
                       split_grid(flat[0], 4, NZ, 16, 32)[0])


@pytest.mark.parametrize("zspec", [False, True])
def test_feedback_and_local_model_match_jax(port, inputs, jax_out, zspec):
    out, _ = jax_out
    ops, sp, tag = _ops_and_packs(port, inputs, zspec)
    f = [_t(inputs[k]) for k in ("atmo", "logp", "precip", "sst", "tisr")]
    sectors = [ops.lon_sectors(x) for x in f]
    fb = ops.feedback(sp, [s[:4 * NZ].reshape(4, NZ, 16, -1)
                           for s in sectors[0]],
                      *[[s[0] for s in sec] for sec in sectors[1:]])
    for i, v in enumerate(fb):
        _scale_close(gather_rows(v, "cpu"), out[f"fb_{tag}_{i}"], 1e-12)
    lm = ops.local_model(sp, ops.lon_sectors(_t(inputs["fc_atmo"]), f[1]))
    for i, v in enumerate(lm):
        _scale_close(gather_rows(v, "cpu"), out[f"lm_{tag}_{i}"], 1e-12)


def test_two_sharded_cycles_match_jax(port, inputs, jax_out):
    """Two sharded cycles (D = 8) against the JAX sharded cycle
    (set_mesh(mesh, shard_gcm=False)) from the same parameters and
    state: 1e-9 of each variable's signal."""
    out, _ = jax_out
    sh = _sharded_copy(port)
    s = sh.init_state(inputs["sst"])
    levels = np.arange(4 * NZ).reshape(4, NZ, 1, 1)
    for c, (imon, fmon, tyear) in enumerate(DATES):
        s, d = sh.cycle(s, imon, fmon, tyear)
        _signal_close(d["atmo"], out[f"cyc{c}_atmo"], 1e-9, levels)
        _signal_close(d["speedy_atmo"], out[f"cyc{c}_speedy_atmo"], 1e-9,
                      np.arange(4).reshape(4, 1, 1, 1))
        for k in ("logp", "precip", "speedy_logp"):
            _signal_close(d[k], out[f"cyc{c}_{k}"], 1e-9)
        for i, cs in enumerate(s.classes):
            for nm in ("x", "feedback", "local_model"):
                _signal_close(gather_rows(getattr(cs, nm), "cpu"),
                              out[f"cyc{c}_{i}_{nm}"], 1e-9)
    assert bool(s.safe) and s.step == 2


def test_solve_wout_sharded_matches_jax(inputs, jax_out):
    """Each device's regions solved alone: Wout within 1e-8 of the JAX
    solve_wout_sharded at a ridge of 1e-2, and bit for bit solve_wout."""
    out, _ = jax_out
    hyper = ESNHyper(**HYPER)
    S = int(inputs["S"])
    eq = NormalEq(_t(inputs["ss"]), _t(inputs["st"]))
    got = solve_wout_sharded(eq, hyper, S, _mesh())
    assert len(got) == D and tuple(got[0].shape) == (2, 5, 12)
    joined = gather_rows(got, "cpu")
    _scale_close(joined, out["wout"], 1e-8)
    assert torch.equal(joined, solve_wout(eq, hyper, S))
    # shards in, shards out: the accumulation's layout
    pre = NormalEq(tmesh.shard_rows(eq.ss, _mesh(4)),
                   tmesh.shard_rows(eq.st, _mesh(4)))
    assert torch.equal(gather_rows(solve_wout_sharded(pre, hyper, S,
                                                      _mesh(4)), "cpu"),
                       joined)
    with pytest.raises(ValueError, match="shards for a mesh"):
        solve_wout_sharded(pre, hyper, S, _mesh())


def test_error_paths_raise_the_jax_messages(port, jax_out):
    _, msgs = jax_out
    lay = port.layout
    cls = lay.classes[1]

    def message(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    assert message(lambda: sharded.ShardedCycleOps(
        lay, port.packs, _mesh(3), NZ)) == msgs["devices"]
    assert message(lambda: sharded._PackTables(lay, cls, 5)) == \
        msgs["count"]
    assert message(lambda: sharded._PackTables(lay, dataclasses.replace(
        cls, region_ids=cls.region_ids[::-1]), D)) == msgs["order"]
    assert message(lambda: sharded._PackTables(lay, dataclasses.replace(
        cls, iy_core=np.zeros_like(cls.iy_core)), D)) == msgs["blocks"]
    # the mesh's first device must hold the hybrid
    with pytest.raises(ValueError, match="not the hybrid's"):
        copy.copy(port).set_mesh(Mesh(["meta"] * 2), shard_gcm=False)
"""Port parity of the distributed GCM (GCM.set_mesh, SpectralTransform.set_mesh,
dycore/sharded.py, PhysicsModel.band_view, HybridAtmosphere.set_mesh(mesh)
with shard_gcm=True) on the CPU in float64: against the unsharded port,
and against the JAX package's GCM.set_mesh and set_mesh(mesh) on its
8-device host mesh.

The port's mesh is D torch.device("cpu") shards, D = 8 (the JAX mesh's
size) and D = 3 (uneven m ranges, 4/4/3 of mx = 11, and uneven bands,
3/3/2 of the 8 latitude pairs).  The set-up is T10 on a 32 x 16 grid
with 8 levels, nsteps_day = 8 (2 GCM steps a window), the synthetic
aquaplanet; the hybrid is tests/test_torch_sharded.py's (128 regions, m =
300), saved by the port and loaded by the JAX side, which runs in one
subprocess with one XLA thread while the port's own cases run.

Tolerances:
- each shard's column physics (K9, K10a_down_surface, K10b, K12 and their
  shortwave and flux-sum forms) and K7 on its band, K15's m-range form:
  bit for bit the unsharded call's band or range (each column's and
  coefficient's arithmetic is the same);
- K5's m-range and K6's band forms, grid_to_spec, spec_to_grid and
  uv_grid on the mesh: 1e-12 of each field's scale against the unsharded
  port (on the CPU the plain versions' matrix products may round a sliced
  table's product in the last bit; on the card the kernels sum in their
  own order and chip_smoke holds them bit for bit), and against the JAX
  package's m-sharded transforms;
- K8's m-range form: 1e-12 of each field's scale;
- a window (stepone and 2 leapfrog steps), a day of run_days and a
  leapfrog step with SPPT: 1e-10 of each field level's signal against
  the unsharded port; the window 1e-9 against the JAX package's meshed
  GCM;
- two coupled cycles with set_mesh(mesh): 1e-10 of each variable's signal
  against the unsharded port, 1e-9 against the JAX package's
  (tests/test_torch_sharded.py's rule).
"""

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.core.spectral import SpectralTransform
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.data.checkpoint import save_hybrid
from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid.build import build_untrained_hybrid
from speedy_ml_tpu_torch.kernels.grid_dynamics import grid_dynamics
from speedy_ml_tpu_torch.kernels.spectral_stack import (dynamics_ncos,
                                                        spectral_stack)
from speedy_ml_tpu_torch.kernels.spectral_tail import spectral_tail
from speedy_ml_tpu_torch.parallel import mesh as tmesh
from speedy_ml_tpu_torch.parallel.mesh import (GridShards, Mesh, Sharded,
                                               band_rows, gather_rows)
from speedy_ml_tpu_torch.physics.boundaries import synthetic_boundary_data
from torch_lane import one_thread_per_pool  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
N_REGIONS, M, NSD = 128, 300, 8
STEPS = 2
DATE = (1990, 7, 1)
DATES = [(0, 0.5, 0.05), (0, 0.5 + 0.25 / 31, 0.05 + 0.25 / 365)]
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
from speedy_ml_tpu.parallel.mesh import make_mesh
from speedy_ml_tpu.physics.boundaries import synthetic_boundary_data

OUT = sys.argv[1]
prm = json.loads(sys.argv[2])
inp = dict(np.load(f"{OUT}/inputs.npz"))
mesh = make_mesh(prm["d"])
g = Geometry(**prm["geom"])
out = {}

sht = SpectralTransform(g, dtype=jnp.float64, zonal="dft")
sht.set_mesh(mesh)
vor = jnp.asarray(inp["vor"])
div = jnp.asarray(inp["div"])
out["g2s"] = np.asarray(jax.jit(sht.grid_to_spec)(jnp.asarray(inp["grid"])))
out["s2g"] = np.asarray(jax.jit(sht.spec_to_grid)(vor))
out["s2g2"] = np.asarray(jax.jit(lambda v: sht.spec_to_grid(v, kcos=2))(div))
u, v = jax.jit(sht.uv_grid)(vor, div)
out["uv_u"], out["uv_v"] = np.asarray(u), np.asarray(v)

def gcm_of():
    return GCM(g, dtype=jnp.float64, nsteps_day=prm["nsd"],
               bd=synthetic_boundary_data(
                   g, SpectralTransform(g, dtype=jnp.float64)))

gcm = gcm_of()
gcm.set_mesh(mesh)
s, f = gcm.init_state(ModelDate(*prm["date"]))
s = gcm.stepone(s, f)
s = gcm.run_window(s, f, prm["steps"])
for k in ("vor", "div", "t", "ps", "tr"):
    out[f"win_{k}"] = np.asarray(getattr(s.spectral, k))
for k in ("hflux_l", "hflux_s", "hflux_i", "precip"):
    out[f"win_{k}"] = np.asarray(getattr(s.fluxes, k))

layout = RegionLayout(g, n_regions=prm["regions"])
hyb = load_hybrid(gcm_of(), layout, f"{OUT}/ckpt", dtype=jnp.float64)
hyb.set_mesh(mesh)
s = hyb.init_state(jnp.asarray(inp["sst"]))
for c, (imon, fmon, tyear) in enumerate(prm["dates"]):
    s, d = hyb.cycle(s, jnp.asarray(imon), jnp.asarray(fmon),
                     jnp.asarray(tyear))
    for k in ("atmo", "logp", "precip", "speedy_atmo", "speedy_logp"):
        out[f"cyc{c}_{k}"] = np.asarray(d[k])
    for i, cs in enumerate(s.classes):
        for nm in ("x", "feedback", "local_model"):
            out[f"cyc{c}_{i}_{nm}"] = np.asarray(getattr(cs, nm))
    out[f"cyc{c}_safe"] = np.asarray(s.safe)
    s = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a)), s)
np.savez(f"{OUT}/outputs.npz", **out)
"""


def _mesh(n):
    return Mesh(["cpu"] * n)


def _gcm():
    g = Geometry(**GEOM)
    return GCM(g, dtype=F64, nsteps_day=NSD, device="cpu",
               bd=synthetic_boundary_data(g, dtype=F64, device="cpu"))


@pytest.fixture(scope="module")
def port():
    """The port's untrained coupled hybrid (float64, on the CPU)."""
    return build_untrained_hybrid(_gcm(), n_regions=N_REGIONS, m=M,
                                  radius_iters=10, device="cpu")


@pytest.fixture(scope="module")
def inputs(port):
    g = port.geom
    rng = np.random.default_rng(27)
    spec = lambda: (rng.standard_normal((3, g.mx, g.nx))
                    + 1j * rng.standard_normal((3, g.mx, g.nx)))
    # zero where the truncation leaves no coefficient (n >= nx - m)
    keep = (np.arange(g.mx)[:, None] + np.arange(g.nx)[None] <= g.trunc + 1)
    return dict(grid=rng.standard_normal((3, g.nlat, g.nlon)),
                vor=spec() * keep, div=spec() * keep,
                sst=np.asarray(port.gcm.bd.sst12[0]))


@pytest.fixture(scope="module", autouse=True)
def jax_run(port, inputs, tmp_path_factory):
    """The JAX side in a subprocess, started before the module's first
    case; the cases that read it come last."""
    tmp = tmp_path_factory.mktemp("jax_sharded_gcm")
    save_hybrid(port, str(tmp / "ckpt"))
    np.savez(tmp / "inputs.npz", **inputs)
    prm = dict(d=8, geom=GEOM, nsd=NSD, regions=N_REGIONS, date=DATE,
               steps=STEPS, dates=[list(d) for d in DATES])
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
    return dict(np.load(tmp / "outputs.npz"))


def _np(a):
    return a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)


def _scale_close(got, ref, rtol):
    """|got - ref| <= rtol * max |ref| for each field of the leading axis
    (the whole array for one field)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    r = ref.reshape(ref.shape[0], -1) if ref.ndim > 2 else ref.reshape(1, -1)
    g = got.reshape(r.shape)
    for a, b in zip(g, r):
        scale = max(float(np.abs(b).max()), 1e-300)
        err = float(np.abs(a - b).max())
        assert err <= rtol * scale, f"{err:.3e} > {rtol:.0e} x {scale:.3e}"


def _level_close(got, ref, rtol):
    """test_torch_gcm's rule: each (…, lat, lon) or (…, m, n) level within
    rtol of its signal, floored at 1e-3 of the array's magnitude."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    r = ref.reshape(-1, *ref.shape[-2:]) if ref.ndim > 2 else ref[None]
    g = got.reshape(r.shape)
    floor = 1e-3 * np.abs(r).max()
    for a, b in zip(g, r):
        scale = max(np.abs(b - b.mean()).max(), floor, 1e-300)
        assert np.abs(a - b).max() <= rtol * scale, (
            f"err {np.abs(a - b).max():.3e}, scale {scale:.3e}")


def _signal_close(got, ref, rtol, variable=0):
    """|got - ref| <= rtol * signal + 2 ulps of ref, the signal of a
    variable its largest |ref - mean| (tests/test_torch_cycle.py's rule)."""
    got, ref = _np(got), _np(ref)
    label = np.broadcast_to(variable, ref.shape)
    signal = np.empty(ref.shape)
    for v in np.unique(label):
        sel = label == v
        signal[sel] = np.abs(ref[sel] - ref[sel].mean()).max()
    tol = rtol * signal + 2 * np.finfo(ref.dtype).eps * np.abs(ref)
    assert (np.abs(got - ref) <= tol).all(), float(
        (np.abs(got - ref) - tol).max())


def _meshed(gcm, n):
    m = copy.copy(gcm)
    m.set_mesh(_mesh(n))
    return m


@pytest.fixture(scope="module")
def window(port):
    """The unsharded port's window: (init state, forcing, the state after
    stepone and STEPS leapfrog steps)."""
    gcm = port.gcm
    s0, f = gcm.init_state(ModelDate(*DATE))
    return s0, f, gcm.run_window(gcm.stepone(s0, f), f, STEPS)


# -- the splits ---------------------------------------------------------

@pytest.mark.parametrize("D", [3, 8])
def test_lat_bands_and_m_ranges(D):
    """Contiguous blocks of the latitude pairs and of the wavenumbers,
    sizes within one of each other; band_rows and join_band_rows are
    inverse; GridShards moves and counts."""
    for n, blocks in ((8, tmesh.lat_bands(16, D)), (11, tmesh.m_ranges(11,
                                                                        D))):
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        sizes = [b - a for a, b in blocks]
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    assert tmesh.m_ranges(31, 8) == [(0, 4), (4, 8), (8, 12), (12, 16),
                                     (16, 20), (20, 24), (24, 28), (28, 31)]
    with pytest.raises(ValueError, match="non-empty"):
        tmesh.m_ranges(11, 12)
    with pytest.raises(ValueError, match="pairs"):
        tmesh.lat_bands(15, 3)
    grid = GridShards(_mesh(D), 16, 11)
    f = torch.arange(2 * 16 * 32.0).reshape(2, 16, 32)
    bands = grid.split_bands(f)
    assert isinstance(bands, Sharded) and len(bands) == D
    for b, (p0, p1) in zip(bands, grid.bands):
        assert torch.equal(b, torch.cat([f[:, p0:p1], f[:, 16 - p1:16 - p0]],
                                        dim=1))
        assert b.is_contiguous()
    assert torch.equal(grid.join_bands(bands), f)
    assert all(torch.equal(w, f) for w in grid.all_bands(bands))
    s = torch.arange(3 * 11 * 12.0).reshape(3, 11, 12)
    ranges = grid.split_ranges(s)
    assert [r.shape[1] for r in ranges] == [b - a for a, b in grid.ranges]
    assert torch.equal(grid.join_ranges(ranges), s)
    # a move onto another shard is counted, one within a shard is not:
    # split, join and all-gather of each kind
    assert grid.copies == 2 * (D - 1) + D * (D - 1) + 2 * (D - 1)
    assert grid.copy_bytes > 0
    assert torch.equal(band_rows(f, (0, 8), 16), f)


# -- the transforms --------------------------------------------------------

@pytest.mark.parametrize("D", [3, 8])
def test_transform_forms_match_unsharded(port, inputs, D):
    """K5's m-range form (a shard's analysis) and K6's band form (a
    shard's synthesis of the whole spectrum) against the unsharded
    transform's range and band; the meshed grid_to_spec, spec_to_grid and
    uv_grid against the unsharded ones."""
    sht = port.gcm.sht
    msht = copy.copy(sht)
    msht.set_mesh(_mesh(D))
    grid = torch.as_tensor(inputs["grid"])
    vor = torch.as_tensor(inputs["vor"])
    div = torch.as_tensor(inputs["div"])
    whole_a = sht.analysis(grid, 1)
    whole_s = sht.synthesis(vor, 1)
    for sv, (m0, m1), band in zip(msht.shards, msht.grid.ranges,
                                  msht.grid.bands):
        assert sv.m0 == m0 and sv.dft_fwd.shape[1] == m1 - m0
        _scale_close(sv.analysis(grid, 1), whole_a[:, m0:m1], 1e-12)
        _scale_close(sv.synthesis(vor, 1), band_rows(whole_s, band, 16),
                     1e-12)
    _scale_close(msht.grid_to_spec(grid), sht.grid_to_spec(grid), 1e-12)
    _scale_close(msht.spec_to_grid(vor), sht.spec_to_grid(vor), 1e-12)
    _scale_close(msht.spec_to_grid(div, kcos=2),
                 sht.spec_to_grid(div, kcos=2), 1e-12)
    for a, b in zip(msht.uv_grid(vor, div), sht.uv_grid(vor, div)):
        _scale_close(a, b, 1e-12)
    assert sht.mesh is None and msht.grid.copies > 0


@pytest.mark.parametrize("D", [3, 8])
def test_dycore_forms_match_unsharded(port, window, D):
    """One leapfrog step's kernels on every shard, from the window's state:
    K15's m-range form and K7 on a band bit for bit the unsharded calls'
    range and band, K8's m-range form within 1e-12."""
    gcm = port.gcm
    dyn = gcm.dyn
    m = _meshed(gcm, D)
    st = window[2].spectral
    f = window[1]
    K = gcm.geom.nlev
    dstk, pstk = spectral_stack(dyn, st, gcm.phis, 1, 0)
    gall = dyn.sht.synthesis(dstk, dynamics_ncos(K, 1))
    ptend, _ = gcm._physics_fn(st, 0, dyn, window[2].sfc, f,
                               window[2].radiation, False, stack=pstk)
    k7 = grid_dynamics(gall, ptend, dyn.column_tables(dyn.imp_double), K, 1)
    A = dyn.analysis_stack(k7)
    corr = (f.tcorh, f.qcorh)
    new = spectral_tail(dyn, A, st, gcm.phis, corr, dyn.imp_double, 2,
                        dyn.delt2, dyn.rob, 0, True)
    parts = m.sdyn.split_state(st)
    for d, (dv, (m0, m1), band) in enumerate(zip(
            m.sdyn.dyns, m.grid.ranges, m.grid.bands)):
        assert dv.m0 == m0
        rng = lambda t: t[..., m0:m1, :]
        s_d, p_d = spectral_stack(dv, parts[d], m.phis_ranges[d], 1, 0)
        assert torch.equal(s_d, rng(dstk)) and torch.equal(p_d, rng(pstk))
        ga = band_rows(gall, band, 16)
        pt = type(ptend)(*(band_rows(t, band, 16) for t in ptend))
        k7_d = grid_dynamics(ga, pt, dv.column_tables(dv.imp_double), K, 1)
        assert torch.equal(k7_d, band_rows(k7, band, 16))
        n_d = spectral_tail(dv, rng(A).contiguous(), parts[d],
                            m.phis_ranges[d], (rng(f.tcorh), rng(f.qcorh)),
                            dv.imp_double, 2, dyn.delt2, dyn.rob, 0, True)
        for k in SpectralState.FIELDS:
            _scale_close(getattr(n_d, k).reshape(-1, m1 - m0, 12),
                         rng(getattr(new, k)).reshape(-1, m1 - m0, 12),
                         1e-12)


@pytest.mark.parametrize("lradsw", [True, False])
@pytest.mark.parametrize("sums", [False, True])
@pytest.mark.parametrize("D", [3, 8])
def test_column_physics_on_bands_bit_for_bit(port, window, D, lradsw, sums):
    """PhysicsModel.compute_with_sums on each band (band_view, the band's
    boundary data, surface, forcing, carry and flux sums) joins into the
    unsharded call's outputs bit for bit: with and without the shortwave
    (K9 or K9_moist_shortwave) and the window's flux sums (K12 or
    K12_pbl_flux)."""
    gcm = port.gcm
    m = _meshed(gcm, D)
    G = m.grid
    s0, f, s = window
    grid = gcm.physics_grid(s.spectral, 0)
    sm = (s.fluxes, 1.0 / NSD, gcm.dyn.delt2) if sums else None
    ref = gcm.phys.compute_with_sums(
        *grid, bd=gcm.bd, sfc=s.sfc, forcing=f, carry=s.radiation,
        lradsw=lradsw, sums=sm)
    sh = m.shard_state(s)
    fc = m.shard_forcing(f)
    gb = [G.split_bands(x) for x in grid]
    outs = [m.phys_bands[d].compute_with_sums(
        *[x[d] for x in gb], bd=m.bd_bands[d], sfc=sh.sfc[d],
        forcing=fc[d], carry=sh.radiation[d], lradsw=lradsw,
        sums=None if sm is None else (sh.fluxes[d],) + sm[1:])
        for d in range(D)]
    for i in range(4):
        assert torch.equal(G.join_bands([o[i] for o in outs]), ref[i])
    carry = G.join_fields([o[4] for o in outs])
    for k in ("tau2", "stratc", "tt_rsw", "ssrd", "ssr", "tsr", "randfv"):
        assert torch.equal(getattr(carry, k), getattr(ref[4], k)), k
    for k in ref[5]._fields:
        assert torch.equal(G.join_bands([getattr(o[5], k) for o in outs]),
                           getattr(ref[5], k)), k
    if sums:
        fl = G.join_fields([o[6] for o in outs])
        for k in ("hflux_l", "hflux_s", "hflux_i", "precip"):
            assert torch.equal(getattr(fl, k), getattr(ref[6], k)), k


# -- the GCM ------------------------------------------------------------------

def _close_state(got, ref, rtol):
    for k in SpectralState.FIELDS:
        _level_close(getattr(got.spectral, k), getattr(ref.spectral, k),
                     rtol)
    for k in ("hflux_l", "hflux_s", "hflux_i", "precip"):
        _level_close(getattr(got.fluxes, k), getattr(ref.fluxes, k), rtol)
    for k in ("tau2", "stratc", "tt_rsw", "ssrd", "ssr", "tsr"):
        _level_close(getattr(got.radiation, k), getattr(ref.radiation, k),
                     rtol)


@pytest.mark.parametrize("D", [3, 8])
def test_window_matches_unsharded(port, window, D):
    """stepone and STEPS leapfrog steps on the mesh (the state sharded on
    entry, kept sharded between the calls) against the unsharded port's
    window: 1e-10 of each level's signal; grid_state of the sharded
    state equals grid_state of its gathered state."""
    s0, f, ref = window
    m = _meshed(port.gcm, D)
    s = m.run_window(m.stepone(s0, f), f, STEPS)
    assert isinstance(s.spectral, Sharded) and len(s.spectral) == D
    assert isinstance(s.fluxes, Sharded) and s.istep == STEPS
    whole = m.gather_state(s)
    _close_state(whole, ref, 1e-10)
    for a, b in zip(m.grid_state(s.spectral)[:2],
                    m.grid_state(whole.spectral)[:2]):
        assert torch.equal(a, b)


def test_run_days_matches_unsharded(port):
    """A day of run_days (the forcing whole, the day's steps sharded, the
    coupler whole on the first device) against the unsharded day."""
    gcm = port.gcm
    s0, _ = gcm.init_state(ModelDate(*DATE))
    ref, d1 = gcm.run_days(s0, ModelDate(*DATE), 1, stepone_first=True)
    m = _meshed(gcm, 3)
    got, d2 = m.run_days(s0, ModelDate(*DATE), 1, stepone_first=True)
    assert d1 == d2 and got.istep == ref.istep
    whole = m.gather_state(got)
    _close_state(whole, ref, 1e-10)
    for k in ("sst_om", "stl_lm", "tice_om"):
        _level_close(getattr(whole.sfc, k), getattr(ref.sfc, k), 1e-10)


@pytest.mark.parametrize("option", ["plain", "persist_surface"])
def test_hybrid_shard_gcm_cycles_match_unsharded(port, option):
    """set_mesh(mesh) (shard_gcm=True, on a copy of the hybrid and of its
    GCM) on 8 shards: two cycles against the unsharded hybrid's, 1e-10 of
    each variable's signal; the gate safe; the original hybrid's GCM stays
    unsharded."""
    h = copy.copy(port)
    h.persist_surface = option == "persist_surface"
    sh = copy.copy(h)
    sh.set_mesh(_mesh(8))
    assert sh.gcm is not h.gcm and h.gcm.mesh is None
    assert sh.gcm.mesh.size == 8
    a, b = h.init_state(port.gcm.bd.sst12[0]), sh.init_state(
        port.gcm.bd.sst12[0])
    levels = np.arange(4 * 8).reshape(4, 8, 1, 1)
    for imon, fmon, tyear in DATES:
        a, da = h.cycle(a, imon, fmon, tyear)
        b, db = sh.cycle(b, imon, fmon, tyear)
        for k in ("atmo", "speedy_atmo"):
            _signal_close(db[k], da[k], 1e-10, levels)
        for k in ("logp", "precip", "speedy_logp"):
            _signal_close(db[k], da[k], 1e-10)
        for ca, cb in zip(a.classes, b.classes):
            for nm in ("x", "feedback", "local_model"):
                _signal_close(gather_rows(getattr(cb, nm), "cpu"),
                              getattr(ca, nm), 1e-10)
        assert bool(a.safe) and bool(b.safe)
    if h.persist_surface:
        for k in ("hflux_l", "precip"):
            _signal_close(getattr(b.fluxes, k), getattr(a.fluxes, k), 1e-10)
    assert sh.gcm.grid.copies > 0


def test_sppt_leapfrog_on_a_mesh_matches_unsharded():
    """A leapfrog step with SPPT on 3 shards (the pattern stepped whole on
    the first device, K24's AR(1) form, and synthesized into each band
    for the bands' K24 perturbation) against the unsharded step from the
    same draw."""
    g = Geometry(**GEOM)
    gcm = GCM(g, dtype=F64, nsteps_day=NSD, device="cpu", sppt_on=True,
              bd=synthetic_boundary_data(g, dtype=F64, device="cpu"))
    s0, f = gcm.init_state(ModelDate(*DATE), sppt_seed=3)
    eta = gcm.sppt.noise(torch.Generator().manual_seed(5))
    a = gcm.leapfrog(gcm.stepone(s0, f), f, eta=eta)
    m = _meshed(gcm, 3)
    b = m.gather_state(m.leapfrog(m.stepone(s0, f), f, eta=eta))
    _close_state(b, a, 1e-10)
    assert torch.equal(b.sppt_spec, a.sppt_spec)


def test_what_a_mesh_does_not_run_raises(port):
    """The mesh's first device must be the GCM's; cgrate (K26's rows and
    range forms) and RDF (K25's sums and band forms) run on a mesh, as
    tests/test_torch_mesh_loop.py holds them against the unsharded port
    and the JAX package."""
    g = Geometry(**GEOM)
    cg = GCM(g, dtype=F64, nsteps_day=NSD, device="cpu", cgrate_on=True,
             bd=synthetic_boundary_data(g, dtype=F64, device="cpu"))
    cg.phys.randfh = np.full((2, 16, 32), 1e-3)
    s0, f = cg.init_state(ModelDate(*DATE))
    m = _meshed(cg, 2)
    s = m.leapfrog(m.stepone(s0, f), f)
    assert isinstance(s.spectral, Sharded) and s.istep == 1
    assert all(r.randfv.shape == (2, 16, 8) for r in s.radiation)
    sht = SpectralTransform(g, dtype=F64, device="cpu")
    with pytest.raises(ValueError, match="first device"):
        sht.set_mesh(Mesh(["meta", "cpu"]))


# -- against the JAX package ---------------------------------------------------

def test_meshed_transforms_match_jax(port, inputs, jax_out):
    """SpectralTransform.set_mesh's grid_to_spec, spec_to_grid (kcos 1 and
    2) and uv_grid on 8 shards against the JAX package's m-sharded
    transforms on its 8-device mesh: 1e-12 of each field's scale."""
    out = jax_out
    msht = copy.copy(port.gcm.sht)
    msht.set_mesh(_mesh(8))
    vor = torch.as_tensor(inputs["vor"])
    div = torch.as_tensor(inputs["div"])
    _scale_close(msht.grid_to_spec(torch.as_tensor(inputs["grid"])),
                 out["g2s"], 1e-12)
    _scale_close(msht.spec_to_grid(vor), out["s2g"], 1e-12)
    _scale_close(msht.spec_to_grid(div, kcos=2), out["s2g2"], 1e-12)
    u, v = msht.uv_grid(vor, div)
    _scale_close(u, out["uv_u"], 1e-12)
    _scale_close(v, out["uv_v"], 1e-12)


def test_meshed_window_matches_jax(port, window, jax_out):
    """GCM.set_mesh's window (stepone and STEPS leapfrog steps) on 8 shards
    against the JAX package's meshed GCM: 1e-9 of each level's signal."""
    out = jax_out
    s0, f, _ = window
    m = _meshed(port.gcm, 8)
    s = m.gather_state(m.run_window(m.stepone(s0, f), f, STEPS))
    for k in SpectralState.FIELDS:
        _level_close(getattr(s.spectral, k), out[f"win_{k}"], 1e-9)
    for k in ("hflux_l", "hflux_s", "hflux_i", "precip"):
        _level_close(getattr(s.fluxes, k), out[f"win_{k}"], 1e-9)


def test_two_shard_gcm_cycles_match_jax(port, inputs, jax_out):
    """Two coupled cycles with set_mesh(mesh) (shard_gcm=True) on 8 shards
    against the JAX package's set_mesh(mesh) from the same parameters and
    state: 1e-9 of each variable's signal."""
    out = jax_out
    sh = copy.copy(port)
    sh.set_mesh(_mesh(8))
    s = sh.init_state(inputs["sst"])
    levels = np.arange(4 * 8).reshape(4, 8, 1, 1)
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
        assert bool(s.safe) == bool(out[f"cyc{c}_safe"])
    assert s.step == 2

"""Port parity of the checkpoints (data/checkpoint.py) and of the
trainer's atmosphere checkpoint (train_hybrid_production(atmo_ckpt=)).

Both packages write and read one format: a hybrid saved by either loads
in the other, and so does a GCM restart.  The hybrid is the JAX
package's untrained coupled one at T10 (128 regions, m=300, 2 GCM steps
a window, float64), as in tests/test_torch_cycle.py: saved by JAX, loaded
by the port, saved by the port and loaded by JAX, its parameters are
equal bit for bit at each step, and two coupled cycles of the port's
load match those of JAX's load at 1e-9 of each variable's signal.
Everything else here is exact: arrays equal bit for bit.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.data import checkpoint as jck
from speedy_ml_tpu.data.calendar import ModelDate as JModelDate
from speedy_ml_tpu.esn.domain import RegionLayout as JRegionLayout
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.hybrid.build import build_untrained_hybrid as jbuild
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu_torch.convert import STD_FIELDS, boundary_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data import checkpoint as tck
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.data.reference_import import (
    assemble_reference_class, synthesize_reference_worker)
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper, esn_step, readout
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid import chunked
from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
N_REGIONS, M = 128, 300
RES_FIELDS = ("cols", "vals", "win_vals", "wout", "mean", "std")


def _sst(geom):
    """synthetic_boundary_data's month-0 SST."""
    lat = geom.lat_radians
    ones = np.ones((geom.nlat, geom.nlon))
    return np.maximum(273.0 + 27.0 * np.cos(lat)[:, None] ** 2 * ones
                      + 2.0 * np.sin(lat)[:, None]
                      * np.cos(2 * np.pi * 0.5 / 12) * ones, 271.4)


def _close(got, ref, rtol, variable=0):
    """|got - ref| <= rtol * signal + 2 ulps, the signal of a variable its
    largest |ref - mean| (variable: int labels broadcasting to ref)."""
    ref = np.asarray(ref)
    got = got.detach().numpy()
    label = np.broadcast_to(variable, ref.shape)
    signal = np.empty(ref.shape)
    for v in np.unique(label):
        sel = label == v
        signal[sel] = np.abs(ref[sel] - ref[sel].mean()).max()
    tol = rtol * signal + 2 * np.finfo(ref.dtype).eps * np.abs(ref)
    err = np.abs(got - ref)
    assert (err <= tol).all(), f"{int((err > tol).sum())} beyond tolerance"


def _jax_arrays(pack):
    r, s = pack.res, pack.std
    out = {k: np.asarray(getattr(r, k)) for k in RES_FIELDS}
    out.update({f"std_{k}": np.asarray(getattr(s, k)) for k in STD_FIELDS})
    if r.win_cols is not None:
        out["win_cols"] = np.asarray(r.win_cols)
    return out


def _port_arrays(pack):
    r, s = pack.res, pack.std
    f = lambda t: t.float().numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()
    out = {k: f(getattr(r, k)) for k in RES_FIELDS}
    out.update({f"std_{k}": f(getattr(s, k)) for k in STD_FIELDS})
    if r.win_cols is not None:
        out["win_cols"] = r.win_cols.numpy()
    return out


def _assert_same_packs(got, ref):
    """Every array of every pack equal, and the static parts."""
    for p, q in zip(got, ref):
        a = _port_arrays(p) if torch.is_tensor(p.res.vals) else _jax_arrays(p)
        b = _port_arrays(q) if torch.is_tensor(q.res.vals) else _jax_arrays(q)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], k)
            assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        assert p.res.n_in == q.res.n_in and p.res.shifts == q.res.shifts
        assert dataclasses.asdict(p.hyper) == dataclasses.asdict(q.hyper)


@pytest.fixture(scope="module")
def jax_coupled():
    jg = JGeometry(**GEOM)
    jgcm = JGCM(jg, dtype=jnp.float64, nsteps_day=8,
                bd=jsynthetic(jg, JST(jg, dtype=jnp.float64)))
    jhyb = jbuild(jgcm, n_regions=N_REGIONS, m=M, key=jax.random.PRNGKey(0),
                  ml_only=False, radius_iters=30)
    geom = Geometry(**GEOM)
    tgcm = GCM(geom, dtype=torch.float64, nsteps_day=8,
               bd=boundary_from_numpy(jgcm.bd, device="cpu",
                                      dtype=torch.float64), device="cpu")
    return jgcm, jhyb, JRegionLayout(jg, n_regions=N_REGIONS), tgcm, \
        RegionLayout(geom, n_regions=N_REGIONS)


def test_hybrid_checkpoints_interchange_and_cycles_match_jax(jax_coupled,
                                                              tmp_path):
    """JAX save -> port load -> port save -> JAX load: the parameters equal
    at every step; two coupled cycles of the port's load against JAX's."""
    jgcm, jhyb, jlayout, tgcm, layout = jax_coupled
    jck.save_hybrid(jhyb, str(tmp_path / "jax"))
    thyb = tck.load_hybrid(tgcm, layout, str(tmp_path / "jax"),
                           dtype=torch.float64, device="cpu")
    assert not thyb.ml_only and thyb.packs[0].res.shifts is not None
    _assert_same_packs(thyb.packs, jhyb.packs)
    tck.save_hybrid(thyb, str(tmp_path / "port"))
    assert not (tmp_path / "port.tmp").exists()
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    ref = json.loads((tmp_path / "jax" / "meta.json").read_text())
    assert meta == ref
    jhyb2 = jck.load_hybrid(jgcm, jlayout, str(tmp_path / "port"),
                            dtype=jnp.float64)
    _assert_same_packs(jhyb2.packs, jhyb.packs)

    sst = _sst(thyb.geom)
    js = jhyb2.init_state(jnp.asarray(sst))
    ts = thyb.init_state(sst)
    date = ModelDate(1990, 1, 1)
    levels = np.arange(4 * thyb.nz).reshape(4, thyb.nz, 1, 1)
    for _ in range(2):
        js, jd = jhyb2.cycle(js, jnp.asarray(date.month - 1),
                             jnp.asarray(date.tmonth),
                             jnp.asarray(date.tyear))
        ts, td = thyb.cycle(ts, date.month - 1, date.tmonth, date.tyear)
        for jc, tc in zip(js.classes, ts.classes):
            for k in ("x", "feedback", "local_model"):
                _close(getattr(tc, k), getattr(jc, k), 1e-9)
        _close(td["atmo"], jd["atmo"], 1e-9, levels)
        _close(td["speedy_atmo"], jd["speedy_atmo"], 1e-9,
               np.arange(4).reshape(4, 1, 1, 1))
        for k in ("logp", "precip", "speedy_logp"):
            _close(td[k], jd[k], 1e-9)
        date = date.advance_hours(6)
    assert bool(ts.safe) and bool(js.safe)


def _bf16_packs_jax(jhyb):
    return [p._replace(res=dataclasses.replace(
        p.res, wout=p.res.wout.astype(jnp.bfloat16))) for p in jhyb.packs]


def test_bf16_wout_saved_by_port_loads_in_both(jax_coupled, tmp_path):
    """C7: the JAX writer's bfloat16 Wout cannot be read back by the JAX
    loader; the port writes it as float32, which both read, and reads the
    JAX writer's records too."""
    jgcm, jhyb, jlayout, tgcm, layout = jax_coupled
    jbf = types.SimpleNamespace(packs=_bf16_packs_jax(jhyb), ml_only=False,
                                ocean_packs=None, base_sst=None,
                                sea_mask=None)
    jck.save_hybrid(jbf, str(tmp_path / "jax_bf16"))
    with pytest.raises(ValueError):
        jck.load_hybrid(jgcm, jlayout, str(tmp_path / "jax_bf16"),
                        dtype=jnp.float32)
    thyb = tck.load_hybrid(tgcm, layout, str(tmp_path / "jax_bf16"),
                           dtype=torch.float64, device="cpu")
    want = [np.asarray(p.res.wout.astype(jnp.float64)) for p in jbf.packs]
    for p, w in zip(thyb.packs, want):
        np.testing.assert_array_equal(p.res.wout.numpy(), w)

    port = HybridAtmosphere(tgcm, layout, thyb.packs, ml_only=False,
                            device="cpu").cast_wout_bf16()
    tck.save_hybrid(port, str(tmp_path / "port_bf16"))
    z = np.load(tmp_path / "port_bf16" / "class_0.npz")
    assert z["res_wout"].dtype == np.float32
    back = tck.load_hybrid(tgcm, layout, str(tmp_path / "port_bf16"),
                           dtype=torch.float32, device="cpu")
    jback = jck.load_hybrid(jgcm, jlayout, str(tmp_path / "port_bf16"),
                            dtype=jnp.float32)
    for p, q, j in zip(port.packs, back.packs, jback.packs):
        assert q.res.wout.dtype == torch.float32
        assert torch.equal(q.res.wout, p.res.wout.float())
        assert torch.equal(q.res.wout.to(torch.bfloat16), p.res.wout)
        np.testing.assert_array_equal(np.asarray(j.res.wout),
                                      p.res.wout.float().numpy())


def test_load_refuses_other_formats(jax_coupled, tmp_path):
    _, jhyb, _, tgcm, layout = jax_coupled
    jck.save_hybrid(jhyb, str(tmp_path / "ck"))
    path = tmp_path / "ck" / "meta.json"
    good = json.loads(path.read_text())
    for edit, err, match in (
            (dict(format_version=1), ValueError, "format_version"),
            (dict(has_ocean=True), FileNotFoundError, "ocean_0"),
            (dict(zspec_0=[0, 8, 0, 8]), ValueError, "zspec_0"),
            (dict(n_classes=2), ValueError, "classes")):
        path.write_text(json.dumps(dict(good, **edit)))
        with pytest.raises(err, match=match):
            tck.load_hybrid(tgcm, layout, str(tmp_path / "ck"),
                            dtype=torch.float64, device="cpu")
    meta = dict(good)
    del meta["format_version"]
    path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="format_version"):
        tck.load_hybrid(tgcm, layout, str(tmp_path / "ck"),
                        dtype=torch.float64, device="cpu")


def test_coo_to_ell_and_win_to_rowvals_equal_jax():
    rng = np.random.default_rng(3)
    n, k = 40, 300
    # uneven rows: a few heavy rows, some empty ones, repeated entries
    rows = np.concatenate([rng.integers(1, n // 2, k), np.full(15, 7),
                           np.full(3, n)])
    cols = rng.integers(1, n + 1, len(rows))
    vals = rng.standard_normal(len(rows))
    got = tck.coo_to_ell(rows, cols, vals, n)
    ref = jck.coo_to_ell(rows, cols, vals, n)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert (np.bincount(rows - 1, minlength=n) == 0).any()
    I, q = 8, 5
    win = np.zeros((I * q, I))
    win[np.arange(I * q), np.arange(I * q) // q] = rng.uniform(-1, 1, I * q)
    np.testing.assert_array_equal(tck.win_to_rowvals(win),
                                  jck.win_to_rowvals(win))
    win[3, 6] = 0.5
    for fn in (tck.win_to_rowvals, jck.win_to_rowvals):
        with pytest.raises(ValueError, match="block-diagonal"):
            fn(win)


def test_gcm_restart_both_directions(jax_coupled, tmp_path):
    jgcm, _, _, tgcm, _ = jax_coupled
    jstate, _ = jgcm.init_state(JModelDate(1990, 1, 1))
    jleaves = jax.tree_util.tree_leaves(jstate)
    tstate, tforcing = tgcm.init_state(ModelDate(1990, 1, 1))
    tstate = tgcm.run_window(tgcm.stepone(tstate, tforcing), tforcing, 2)
    assert len(tck.gcm_leaves(tstate)) == len(jleaves) == 27
    # JAX file -> port
    jck.save_gcm_restart(jstate, str(tmp_path / "jax.npz"))
    got = tck.load_gcm_restart(str(tmp_path / "jax.npz"), tstate)
    assert got.istep == 0 and isinstance(got.istep, int)
    for a, b in zip(tck.gcm_leaves(got)[:-1], jleaves[:-1]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # port file -> JAX, and back into the port
    tck.save_gcm_restart(tstate, str(tmp_path / "port.npz"))
    jgot = jck.load_gcm_restart(str(tmp_path / "port.npz"), jstate)
    back = tck.load_gcm_restart(str(tmp_path / "port.npz"), tstate)
    assert int(jgot.istep) == back.istep == tstate.istep == 2
    assert np.asarray(jgot.istep).dtype == np.int32
    for a, b, c in zip(jax.tree_util.tree_leaves(jgot)[:-1],
                       tck.gcm_leaves(tstate)[:-1], tck.gcm_leaves(back)[:-1]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert torch.equal(b, c) and b.dtype == c.dtype
    # the next window from the loaded state is the original's, bit for bit
    a = tgcm.run_window(tstate, tforcing, 2)
    b = tgcm.run_window(back, tforcing, 2)
    for x, y in zip(tck.gcm_leaves(a)[:-1], tck.gcm_leaves(b)[:-1]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="structure"):
        tck.load_gcm_restart(str(tmp_path / "port.npz"), tstate.sfc)


def test_ragged_win_cols_pack_round_trips(tmp_path):
    """Reference-imported (ragged) packs keep win_cols through a save and
    a load, in both packages, and step and read out the same."""
    nz = 2
    geom = Geometry(trunc=10, nlon=32, nlat=16, nlev=nz)
    layout = RegionLayout(geom, n_regions=32)
    rng = np.random.Generator(np.random.Philox(5))
    packs = []
    for cls in layout.classes:
        workers = [synthesize_reference_worker(
            rng, nz, cls.core_shape, cls.input_shape, has_sst=bool(i % 2),
            m=432, deg=3, model_identity=False) for i in range(cls.count)]
        packs.append(assemble_reference_class(layout, cls, workers, nz,
                                              device="cpu"))
    assert packs[0].res.win_cols is not None and packs[0].res.cols.ndim == 3
    fake = types.SimpleNamespace(packs=packs, ml_only=True)
    tck.save_hybrid(fake, str(tmp_path / "ck"))
    for i, p in enumerate(packs):
        z = np.load(tmp_path / "ck" / f"class_{i}.npz")
        np.testing.assert_array_equal(z["win_cols"], p.res.win_cols.numpy())
    jgeom = JGeometry(trunc=10, nlon=32, nlat=16, nlev=nz)
    jstub = types.SimpleNamespace(geom=jgeom, dtype=jnp.float32,
                                  nsteps_day=96)
    jback = jck.load_hybrid(jstub, JRegionLayout(jgeom, n_regions=32),
                            str(tmp_path / "ck"))
    _assert_same_packs(jback.packs, packs)
    back = tck.load_hybrid(None, layout, str(tmp_path / "ck"), device="cpu")
    _assert_same_packs(back.packs, packs)
    for p0, p1 in zip(packs, back.packs):
        Rc, I = p0.res.mean.shape
        u = torch.from_numpy(rng.normal(0, 1, (Rc, I))).float()
        lm = torch.from_numpy(rng.normal(0, 1, (Rc, p0.res.n_speedy))).float()
        x0 = torch.zeros((Rc, p0.res.n))
        assert torch.equal(readout(p0.res, esn_step(p0.res, x0, u), lm),
                           readout(p1.res, esn_step(p1.res, x0, u), lm))


# ----------------------------------------------------------------------
# train_hybrid_production(atmo_ckpt=)
# ----------------------------------------------------------------------

CK_GEOM = Geometry(trunc=10, nlon=32, nlat=16, nlev=2)
CK_HYPER = ESNHyper(m=432, deg=3, noise_mag=0.1)
CK_KW = dict(n_discard=4, time_chunk=8, region_chunk=16)


@pytest.fixture(scope="module")
def ck_setup():
    """An ML-only trainer's inputs: a seeded 24-sample series."""
    rng = np.random.default_rng(11)
    T, K, nlat, nlon = 24, 2, 16, 32
    truth = dict(atmo=rng.normal(0, 1, (T, 4, K, nlat, nlon)),
                 logp=rng.normal(0, 0.1, (T, nlat, nlon)),
                 precip=np.abs(rng.normal(0, 1e-4, (T, nlat, nlon))),
                 sst=rng.normal(290, 3, (T, nlat, nlon)),
                 tisr=rng.uniform(0, 400, (T, nlat, nlon)))
    gcm = types.SimpleNamespace(geom=CK_GEOM, dtype=torch.float64,
                                nsteps_day=96)
    return gcm, RegionLayout(CK_GEOM, n_regions=32), \
        chunked.ArraySource(truth)


def _train(ck_setup, path, hyper=CK_HYPER, hybrid=False):
    gcm, layout, src = ck_setup
    return chunked.train_hybrid_production(gcm, layout, src, hyper, 5,
                                           hybrid=hybrid, atmo_ckpt=path,
                                           device="cpu", **CK_KW)


def _spy(monkeypatch):
    calls = []
    real = chunked.train_class_production

    def spy(*a, **kw):
        calls.append(a[1].name)
        return real(*a, **kw)
    monkeypatch.setattr(chunked, "train_class_production", spy)
    return calls


def test_atmo_ckpt_second_call_trains_nothing(ck_setup, tmp_path,
                                              monkeypatch):
    calls = _spy(monkeypatch)
    path = str(tmp_path / "atmo")
    first = _train(ck_setup, path)
    assert len(calls) == 3 and (tmp_path / "atmo" / "meta.json").exists()
    assert not (tmp_path / "atmo.tmp").exists()
    second = _train(ck_setup, path)
    assert len(calls) == 3, "the second call trained"
    assert second.ml_only and first.ml_only
    _assert_same_packs(second.packs, first.packs)


def test_atmo_ckpt_without_meta_is_retrained(ck_setup, tmp_path,
                                             monkeypatch):
    """A partly written checkpoint (no meta.json) is trained again and
    replaced, never loaded."""
    path = tmp_path / "atmo"
    path.mkdir()
    (path / "class_0.npz").write_bytes(b"partial")
    calls = _spy(monkeypatch)
    hyb = _train(ck_setup, str(path))
    assert len(calls) == 3 and (path / "meta.json").exists()
    again = tck.load_hybrid(ck_setup[0], ck_setup[1], str(path),
                            dtype=torch.float64, device="cpu")
    _assert_same_packs(again.packs, hyb.packs)


@pytest.mark.parametrize("change,match", [
    (dict(hyper=dataclasses.replace(CK_HYPER, beta_res=1e-2)), "beta_res"),
    (dict(hybrid=True), "ml_only")])
def test_atmo_ckpt_trained_otherwise_raises(ck_setup, tmp_path, monkeypatch,
                                            change, match):
    path = str(tmp_path / "atmo")
    _train(ck_setup, path)
    calls = _spy(monkeypatch)
    with pytest.raises(ValueError, match=match):
        _train(ck_setup, path, **change)
    assert calls == []

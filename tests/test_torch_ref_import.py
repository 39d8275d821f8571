"""Port parity of the reference weight import (data/reference_import.py).

Workers are synthesized at the reference's shapes by the JAX package's
synthesize_reference_worker and by the port's from the same seeds (equal
arrays), written in the reference's file layout by either package and
read by the other.  Assembled into class packs (ragged: land workers
without the SST input, so their n, I, q differ), the port's packs equal
the JAX package's bit for bit in float64, from a list of workers or one
worker at a time.  A hybrid imported from per-region workers runs two
coupled cycles at T10 (128 regions, m=600, 2 GCM steps a window) that
match the JAX package's at 1e-9 of each variable's signal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.data import reference_import as jri
from speedy_ml_tpu.esn.domain import RegionLayout as JRegionLayout
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu_torch.convert import STD_FIELDS, boundary_from_numpy
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data import reference_import as tri
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
from speedy_ml_tpu_torch.gcm import GCM
from torch_lane import one_thread_per_pool  # noqa: F401

NZ = 2
GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=NZ)
KEYS = ("win", "wout", "rows", "cols", "vals", "mean", "std")


def _workers(synth, cls, seed, land_every=3, **kw):
    rng = np.random.Generator(np.random.Philox(seed))
    return [synth(rng, NZ, cls.core_shape, cls.input_shape,
                  has_sst=(i % land_every) != 1, m=432, deg=3,
                  model_identity=False, wout_scale=0.1, **kw)
            for i in range(cls.count)]


def _pack_arrays(pack):
    r, s = pack.res, pack.std
    a = lambda t: t.numpy() if torch.is_tensor(t) else np.asarray(t)
    out = {k: a(getattr(r, k)) for k in ("cols", "vals", "win_vals", "wout",
                                          "mean", "std", "win_cols")}
    out.update({f"std_{k}": a(getattr(s, k)) for k in STD_FIELDS})
    return out


def _assert_same_pack(got, ref):
    a, b = _pack_arrays(got), _pack_arrays(ref)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], k)
    assert got.res.n_in == ref.res.n_in and got.res.shifts is None


def test_synthesis_and_worker_files_interchange(tmp_path):
    g = Geometry(**GEOM)
    cls = RegionLayout(g, n_regions=32).classes[1]
    for has_sst in (True, False):
        w = tri.synthesize_reference_worker(
            np.random.Generator(np.random.Philox(7)), NZ, cls.core_shape,
            cls.input_shape, has_sst, m=432, deg=3)
        ref = jri.synthesize_reference_worker(
            np.random.Generator(np.random.Philox(7)), NZ, cls.core_shape,
            cls.input_shape, has_sst, m=432, deg=3)
        assert sorted(w) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(w[k], ref[k], k)
        for i, (write, read) in enumerate(
                ((tri.write_reference_worker, jri.read_reference_worker),
                 (jri.write_reference_worker, tri.read_reference_worker))):
            p = tri.worker_path(str(tmp_path), 5 + i, f"t{has_sst}")
            assert p == jri.worker_path(str(tmp_path), 5 + i, f"t{has_sst}")
            write(p, *(w[k] for k in KEYS))
            back = read(p)
            for k in KEYS:
                np.testing.assert_array_equal(back[k], w[k], k)
            from speedy_ml_tpu_torch.data.checkpoint import \
                read_reference_worker
            assert np.array_equal(read_reference_worker(p)["win"], w["win"])


def test_production_shape_worker():
    """One worker at the reference's production shapes: sea n=5760,
    I=576, q=10 and land n=6160, I=560, q=11 (allocate_res_new), equal to
    the JAX package's from the same seed."""
    for has_sst, shape in ((True, (5760, 576, 10)), (False, (6160, 560, 11))):
        w = tri.synthesize_reference_worker(
            np.random.Generator(np.random.Philox(3)), 8, (2, 2), (4, 4),
            has_sst)
        ref = jri.synthesize_reference_worker(
            np.random.Generator(np.random.Philox(3)), 8, (2, 2), (4, 4),
            has_sst)
        assert (w["n"], w["I"], w["q"]) == shape
        assert w["wout"].shape == (136, 132 + shape[0])
        assert w["win"].shape == shape[:2]
        for k in KEYS:
            np.testing.assert_array_equal(w[k], ref[k], k)


def test_component_permutation_equals_jax():
    rng = np.random.default_rng(2)
    a = 4 * 8
    for extra in (3, 4):          # without and with the SST slot
        mean, std = rng.normal(0, 1, a + extra), rng.uniform(1, 2, a + extra)
        for x, y in zip(tri._file_comps_to_ours(mean, std, 8),
                        jri._file_comps_to_ours(mean, std, 8)):
            np.testing.assert_array_equal(x, y)


def test_assemble_equals_jax(tmp_path):
    g, jg = Geometry(**GEOM), JGeometry(**GEOM)
    layout, jlayout = RegionLayout(g, n_regions=32), \
        JRegionLayout(jg, n_regions=32)
    for c, (cls, jcls) in enumerate(zip(layout.classes, jlayout.classes)):
        ws = _workers(tri.synthesize_reference_worker, cls, seed=c)
        files = []
        for r, w in enumerate(ws):
            p = tri.worker_path(str(tmp_path), int(cls.region_ids[r]), "a")
            tri.write_reference_worker(p, *(w[k] for k in KEYS))
            files.append(p)
        read = [tri.read_reference_worker(p) for p in files]
        assert len({w["win"].shape for w in read}) == 2     # ragged
        got = tri.assemble_reference_class(layout, cls, read, NZ,
                                           dtype=torch.float64, device="cpu")
        ref = jri.assemble_reference_class(jlayout, jcls, read, NZ,
                                           dtype=jnp.float64)
        _assert_same_pack(got, ref)
        # one worker at a time, as import_reference_weights reads them
        lazy = tri.assemble_reference_class(
            layout, cls, (tri.read_reference_worker(p) for p in files), NZ,
            hyper=ESNHyper(m=432), dtype=torch.float64, device="cpu")
        _assert_same_pack(lazy, got)
        assert lazy.hyper == ESNHyper(m=432)
        # float32: each value rounded once, as the JAX packs
        f32 = tri.assemble_reference_class(layout, cls, read, NZ,
                                           device="cpu")
        _assert_same_pack(f32, jri.assemble_reference_class(jlayout, jcls,
                                                            read, NZ))
    bad = dict(read[0], win=read[0]["win"].copy())
    bad["win"][0, 1] = 0.5
    for fn, lay, cl in ((tri.assemble_reference_class, layout, cls),
                        (jri.assemble_reference_class, jlayout, jcls)):
        kw = dict(device="cpu") if fn is tri.assemble_reference_class \
            else {}
        with pytest.raises(ValueError, match="block-diagonal"):
            fn(lay, cl, [bad] + read[1:], NZ, **kw)


def _close(got, ref, rtol, variable=0):
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


def test_imported_weights_cycles_match_jax():
    geom = dict(GEOM, nlev=8)
    jg, g = JGeometry(**geom), Geometry(**geom)
    jgcm = JGCM(jg, dtype=jnp.float64, nsteps_day=8,
                bd=jsynthetic(jg, JST(jg, dtype=jnp.float64)))
    tgcm = GCM(g, dtype=torch.float64, nsteps_day=8,
               bd=boundary_from_numpy(jgcm.bd, device="cpu",
                                      dtype=torch.float64), device="cpu")
    jlayout, layout = JRegionLayout(jg, n_regions=128), \
        RegionLayout(g, n_regions=128)
    shapes = {int(r): (c.core_shape, c.input_shape)
              for c in layout.classes for r in c.region_ids}

    def reader(region):
        core, inp = shapes[region]
        return tri.synthesize_reference_worker(
            np.random.default_rng(region), 8, core, inp,
            has_sst=region % 3 != 1, m=600, wout_scale=1e-4)

    jhyb = jri.import_reference_weights(jgcm, jlayout, 8, reader,
                                        dtype=jnp.float64)
    thyb = tri.import_reference_weights(tgcm, layout, 8, reader,
                                        dtype=torch.float64, device="cpu")
    for p, q in zip(thyb.packs, jhyb.packs):
        _assert_same_pack(p, q)
        assert p.res.cols.ndim == 3 and p.res.win_cols is not None
    lat = g.lat_radians
    sst = np.broadcast_to(273.0 + 27.0 * np.cos(lat)[:, None] ** 2,
                          (g.nlat, g.nlon)).copy()
    js = jhyb.init_state(jnp.asarray(sst))
    ts = thyb.init_state(sst)
    date = ModelDate(1990, 1, 1)
    levels = np.arange(32).reshape(4, 8, 1, 1)
    for _ in range(2):
        js, jd = jhyb.cycle(js, jnp.asarray(date.month - 1),
                            jnp.asarray(date.tmonth), jnp.asarray(date.tyear))
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
    t = td["speedy_atmo"][0]
    assert 150 < float(t.min()) and float(t.max()) < 350

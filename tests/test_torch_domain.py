"""Port parity: region tiling, packing and the gather/scatter index tables.

The JAX package (speedy_ml_tpu.esn.domain) is the reference; the port
(speedy_ml_tpu_torch.esn.domain, the plain version of K3 and the core
scatter's plain versions, now K2's store) must reproduce it exactly in
float64 at the real T30 layout (1,152 regions, no reservoirs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.esn.domain import RegionLayout as JLayout
from speedy_ml_tpu.esn.standardize import Standardizer as JStandardizer
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.kernels.core_scatter import (CoreScatter,
                                                      core_scatter_plain,
                                                      grid_blocks,
                                                      scatter_plain,
                                                      split_grid)
from speedy_ml_tpu_torch.kernels.window_gather import window_gather
from torch_lane import one_thread_per_pool  # noqa: F401

NVAR, NZ = 4, 8


@pytest.fixture(scope="module")
def layouts():
    return JLayout(JGeometry(), n_regions=1152), RegionLayout(Geometry(),
                                                              1152)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(0)
    g = Geometry()
    atmo = rng.normal(size=(NVAR, NZ, g.nlat, g.nlon))
    flat = [rng.normal(size=(g.nlat, g.nlon)) for _ in range(4)]
    return atmo, flat


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_class_counts(layouts):
    jl, tl = layouts
    assert [c.count for c in tl.classes] == [48, 1056, 48]
    assert [c.name for c in tl.classes] == [c.name for c in jl.classes]
    for jc, tc in zip(jl.classes, tl.classes):
        for f in ("region_ids", "ix_core", "iy_core", "ix_in", "iy_in",
                  "core_in_input_x", "core_in_input_y"):
            np.testing.assert_array_equal(getattr(jc, f), getattr(tc, f))
    np.testing.assert_array_equal(jl.lat_start, tl.lat_start)


@pytest.mark.parametrize("core_only", [False, True])
def test_window_index_equals_gather_oracle(layouts, fields, core_only):
    jl, tl = layouts
    atmo, _ = fields
    for jc, tc in zip(jl.classes, tl.classes):
        iy = jc.iy_core if core_only else jc.iy_in
        ix = jc.ix_core if core_only else jc.ix_in
        oracle = np.asarray(JLayout.gather_patches(jnp.asarray(atmo), iy, ix))
        np.testing.assert_array_equal(
            RegionLayout.gather_patches(_t(atmo), iy, ix).numpy(), oracle)
        w = tl.window_index(tc, core_only)
        flat = atmo.reshape(NVAR, NZ, -1)[..., w]          # (V, K, Rc, y, x)
        np.testing.assert_array_equal(np.moveaxis(flat, 2, 0), oracle)
        np.testing.assert_array_equal(
            tl.class_patches(tc, _t(atmo), core_only).numpy(), oracle)
        # the JAX roll-and-stride path agrees with the same oracle
        np.testing.assert_array_equal(
            np.asarray(jl.class_patches(jc, jnp.asarray(atmo), core_only)),
            oracle)


@pytest.mark.parametrize("core_only", [False, True])
def test_pack_vector_matches_jax(layouts, fields, core_only):
    jl, tl = layouts
    atmo, flat = fields
    two_d = flat[:2] if core_only else flat
    for jc, tc in zip(jl.classes, tl.classes):
        ref = np.asarray(jl.pack_vector(
            jc, jnp.asarray(atmo), *[jnp.asarray(f) for f in two_d],
            core_only=core_only))
        got = tl.pack_vector(tc, _t(atmo), *[_t(f) for f in two_d],
                             core_only=core_only)
        np.testing.assert_array_equal(got.numpy(), ref)
        # the pack table addresses the same elements of the flat source
        table = tl.pack_table(tc, NVAR, NZ, logp=True, precip=True,
                              sst=not core_only, tisr=not core_only,
                              core_only=core_only)
        src = np.concatenate([atmo.ravel()] + [f.ravel() for f in flat])
        np.testing.assert_array_equal(src[table], ref)


def test_unpack_scatter_matches_jax(layouts):
    jl, tl = layouts
    rng = np.random.default_rng(1)
    g = Geometry()
    j_atmo = jnp.zeros((NVAR, NZ, g.nlat, g.nlon), jnp.float64)
    j_logp = jnp.zeros((g.nlat, g.nlon), jnp.float64)
    t_atmo = torch.zeros((NVAR, NZ, g.nlat, g.nlon), dtype=torch.float64)
    t_logp = torch.zeros((g.nlat, g.nlon), dtype=torch.float64)
    for jc, tc in zip(jl.classes, tl.classes):
        xc, yc = tc.core_shape
        vec = rng.normal(size=(tc.count, NVAR * NZ * xc * yc + 2 * xc * yc))
        jp = jl.unpack_core_vector(jc, jnp.asarray(vec), NVAR, NZ, logp=True,
                                   precip=True)
        tp = tl.unpack_core_vector(tc, _t(vec), NVAR, NZ, logp=True,
                                   precip=True)
        for k in ("atmo", "logp", "precip"):
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
        j_atmo = jl.scatter_core(jc, jp["atmo"], j_atmo)
        j_logp = jl.scatter_core(jc, jp["logp"], j_logp)
        t_atmo = tl.scatter_core(tc, tp["atmo"], t_atmo)
        t_logp = tl.scatter_core(tc, tp["logp"], t_logp)
    np.testing.assert_array_equal(t_atmo.numpy(), np.asarray(j_atmo))
    np.testing.assert_array_equal(t_logp.numpy(), np.asarray(j_logp))


def test_core_scatter_plain_matches_jax_assemble(layouts):
    """The core scatter's plain version (index table + clamps) equals the
    JAX unpack_core_vector + scatter_core + assemble_global clamps."""
    jl, tl = layouts
    rng = np.random.default_rng(2)
    g = Geometry()
    vecs = []
    for c in tl.classes:
        xc, yc = c.core_shape
        vecs.append(rng.normal(scale=1e-5, size=(
            c.count, NVAR * NZ * xc * yc + 2 * xc * yc)))
    atmo = jnp.zeros((NVAR, NZ, g.nlat, g.nlon), jnp.float64)
    logp = jnp.zeros((g.nlat, g.nlon), jnp.float64)
    precip = jnp.zeros((g.nlat, g.nlon), jnp.float64)
    for jc, v in zip(jl.classes, vecs):
        p = jl.unpack_core_vector(jc, jnp.asarray(v), NVAR, NZ, logp=True,
                                  precip=True)
        atmo = jl.scatter_core(jc, p["atmo"], atmo)
        logp = jl.scatter_core(jc, p["logp"], logp)
        precip = jl.scatter_core(jc, p["precip"], precip)
    atmo = atmo.at[3].set(jnp.maximum(atmo[3], 1e-6))
    precip = jnp.where(precip < 1e-5, 0.0, precip)

    table = torch.as_tensor(tl.core_source_table(tl.classes, NVAR, NZ))
    got = core_scatter_plain([_t(v) for v in vecs], table, NVAR, NZ, g.nlat,
                             g.nlon)
    for a, b in zip(got, (atmo, logp, precip)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the clamps did bite on this input
    assert float(got[0][3].min()) == 1e-6
    assert float((got[2] == 0).float().mean()) > 0.5


def test_window_gather_plain_matches_jax_feedback(layouts, fields):
    """K3's plain version equals JAX pack_vector + standardize_input."""
    jl, tl = layouts
    atmo, flat = fields
    rng = np.random.default_rng(3)
    idx, means, stds, refs = [], [], [], []
    for jc, tc in zip(jl.classes, tl.classes):
        table = tl.pack_table(tc, NVAR, NZ, logp=True, precip=True, sst=True,
                              tisr=True)
        mean = rng.normal(size=table.shape)
        std = rng.uniform(0.5, 2.0, size=table.shape)
        st = JStandardizer(comp_mean=None, comp_std=None,
                           in_mean=jnp.asarray(mean), in_std=jnp.asarray(std),
                           out_mean=None, out_std=None)
        refs.append(np.asarray(st.standardize_input(jl.pack_vector(
            jc, jnp.asarray(atmo), *[jnp.asarray(f) for f in flat]))))
        idx.append(torch.as_tensor(table))
        means.append(_t(mean))
        stds.append(_t(std))
    got = window_gather((_t(atmo), *[_t(f) for f in flat]), idx, means, stds)
    for a, b in zip(got, refs):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_scatter_plain_matches_core_scatter_plain(layouts, dtype):
    """K2's store into the grid, plain version: each class's (Rc, O)
    outputs through core_output_index, clamped by block, equal the gather
    through core_source_table bit for bit, NaN kept; every element of the
    grid (starting as NaN) written."""
    _, tl = layouts
    rng = np.random.default_rng(5)
    g = Geometry()
    vecs = []
    for c in tl.classes:
        xc, yc = c.core_shape
        v = rng.normal(scale=1e-5, size=(c.count, (NVAR * NZ + 2) * xc * yc))
        v[0, ::97] = np.nan
        vecs.append(torch.as_tensor(v).to(dtype))
    total, q, p = grid_blocks(NVAR, NZ, g.nlat, g.nlon)
    grid = torch.full((total,), float("nan"), dtype=dtype)
    for v, i in zip(vecs, tl.core_output_index(tl.classes, NVAR, NZ)):
        scatter_plain(v, CoreScatter(grid, torch.as_tensor(i), q, p))
    table = torch.as_tensor(tl.core_source_table(tl.classes, NVAR, NZ))
    ref = core_scatter_plain(vecs, table, NVAR, NZ, g.nlat, g.nlon)
    for a, b in zip(split_grid(grid, NVAR, NZ, g.nlat, g.nlon), ref):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    assert int(grid.isnan().sum()) == sum(int(v.isnan().sum()) for v in vecs)
    assert float(ref[0][3].nan_to_num(1.0).min()) == float(
        torch.tensor(1e-6, dtype=dtype))


def test_core_output_index_inverts_the_source_table(layouts):
    _, tl = layouts
    table = tl.core_source_table(tl.classes, NVAR, NZ)
    idx = tl.core_output_index(tl.classes, NVAR, NZ)
    assert [i.shape for i in idx] == [
        (c.count, (NVAR * NZ + 2) * c.core_shape[0] * c.core_shape[1])
        for c in tl.classes]
    flat = np.concatenate([i.ravel() for i in idx])
    assert flat.dtype == np.int32
    assert np.array_equal(table[flat], np.arange(flat.size))
    with pytest.raises(ValueError, match="exactly once"):
        tl.core_output_index(tl.classes + tl.classes[:1], NVAR, NZ)
    with pytest.raises(ValueError, match="exactly once"):
        tl.core_output_index(tl.classes[:2], NVAR, NZ)


def test_core_source_table_covers_grid_once(layouts):
    _, tl = layouts
    table = tl.core_source_table(tl.classes, NVAR, NZ)
    total = sum(c.count * (NVAR * NZ * 4 + 8) for c in tl.classes)
    assert np.array_equal(np.sort(table), np.arange(total))
    with pytest.raises(ValueError, match="overlaps"):
        tl.core_source_table(tl.classes + tl.classes[:1], NVAR, NZ)
    with pytest.raises(ValueError, match="cover"):
        tl.core_source_table(tl.classes[:2], NVAR, NZ)


def test_input_to_target_matches_jax(layouts):
    jl, tl = layouts
    rng = np.random.default_rng(4)
    for jc, tc in zip(jl.classes, tl.classes):
        xi, yi = tc.input_shape
        vec = rng.normal(size=(tc.count, NVAR * NZ * xi * yi + 4 * xi * yi))
        kw = dict(logp=True, precip=True, sst=True, tisr=True)
        ref = jl.input_to_target(jc, jnp.asarray(vec), NVAR, NZ, NZ, 0, **kw)
        got = tl.input_to_target(tc, _t(vec), NVAR, NZ, NZ, 0, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

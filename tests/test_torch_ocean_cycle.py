"""Port parity of the armed and running slab ocean (A10b):
the slab ocean of the ML-only cycle and of the persistent coupled cycle
(K22 with K1 and K2) from start_prediction's states, on the CPU at
T10 (32 x 16, 8 levels, 128 regions) in float64 against the JAX package,
with the hybrids of tests/test_torch_ocean.py (untrained atmospheres,
seeded slab packs and land fill).

SLAB_STRIDE is set to 3 or 4 on the instances, as tests/test_ocean.py
does.  Tolerances:
  - ML-only cycles through two slab steps, the ML-only and the hybrid
    slab readout, and a persistent coupled cycle pair (2 GCM steps a
    window) whose second cycle is a slab step: sst_grid, x, the buffer
    (the port's ring rolled back to the JAX order) and lm within 1e-9 of
    each variable's signal (its largest departure from its mean), the
    cycle tests' tolerance; on the coupled pair also the atmosphere's
    states and the carried surface.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.hybrid import model as jmodel
from speedy_ml_tpu.physics.boundaries import \
    synthetic_boundary_data as jsynthetic
from speedy_ml_tpu_torch.convert import (boundary_from_numpy,
                                         ocean_states_from_numpy,
                                         ocean_states_to_numpy)
from speedy_ml_tpu_torch.data.calendar import ModelDate
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere, ocean_snapshot
from speedy_ml_tpu_torch.kernels import slab_ocean as k22
from test_torch_ocean import GEOM, _signal_close, ocean_pair, sync_window
from torch_lane import one_thread_per_pool  # noqa: F401


def _close_ocean(ts, js, rtol):
    got = ocean_states_to_numpy(ts.ocean, ts.step)
    for g, jo in zip(got, js.ocean):
        _signal_close(g["x"], jo.x, rtol)
        _signal_close(g["buffer"], jo.buffer, rtol)
        assert (g["lm"] is None) == (jo.lm is None)
        if jo.lm is not None:
            _signal_close(g["lm"], jo.lm, rtol)


# ------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("hybrid_readout", [False, True],
                         ids=["ml_only_readout", "hybrid_readout"])
def test_ml_only_cycles_through_two_slab_steps_match_jax(hybrid_readout):
    """Seven ML-only cycles at SLAB_STRIDE 3 from start_prediction (slab
    steps at steps 2 and 5): every cycle's SST grid and ocean states."""
    jhyb, thyb = ocean_pair(hybrid_readout)
    jhyb.SLAB_STRIDE = thyb.SLAB_STRIDE = 3
    truth = sync_window()
    js = jhyb.start_prediction({k: jnp.asarray(v) for k, v in truth.items()},
                               None, jnp.asarray(truth["sst"][-1]))
    ts = thyb.start_prediction(truth, None, truth["sst"][-1])
    sst_prev = ts.sst_grid
    for step in range(7):
        js, _ = jhyb.cycle(js, jnp.asarray(0), jnp.asarray(0.5, jnp.float64),
                           jnp.asarray(0.05, jnp.float64))
        ts, _ = thyb.cycle(ts, 0, 0.5, 0.05)
        assert ts.step == int(js.step) == step + 1
        _signal_close(ts.sst_grid, js.sst_grid)
        _close_ocean(ts, js, 1e-9)
        stepped = step % 3 == 2
        assert (ts.sst_grid is not sst_prev) == stepped
        if stepped:
            land = thyb.sea_mask
            assert torch.equal(ts.sst_grid[land], thyb.base_sst[land])
            assert float(ts.sst_grid.min()) >= k22.SST_MIN
        sst_prev = ts.sst_grid


def test_ocean_snapshot_keeps_a_state_to_run_again():
    """The cycle writes the ring in place; a snapshot runs again to the
    same state."""
    _, thyb = ocean_pair(False)
    thyb.SLAB_STRIDE = 3
    truth = sync_window()
    s0 = thyb.start_prediction(truth, None, truth["sst"][-1])
    keep = ocean_snapshot(s0)
    a = s0
    for _ in range(3):
        a, _ = thyb.cycle(a, 0, 0.5, 0.05)
    b = keep
    for _ in range(3):
        b, _ = thyb.cycle(b, 0, 0.5, 0.05)
    assert torch.equal(a.sst_grid, b.sst_grid)
    for p, q in zip(a.ocean, b.ocean):
        assert torch.equal(p.x, q.x) and torch.equal(p.buffer, q.buffer)


def test_persistent_coupled_cycle_pair_with_a_slab_step_matches_jax():
    """Two persistent coupled cycles from step 2 at SLAB_STRIDE 4: the
    first pushes into the rings and accumulates the surface's sums, the
    second is a slab step and a coupling.  The rings start from seeded
    buffers (given to the port as rings, ocean_states_from_numpy)."""
    jhyb0, thyb0 = ocean_pair(True, ml_only=False)
    jg = JGeometry(**GEOM)
    jgcm = JGCM(jg, dtype=jnp.float64, nsteps_day=8,
                bd=jsynthetic(jg, JST(jg, dtype=jnp.float64)))
    tgcm = GCM(thyb0.geom, dtype=torch.float64, nsteps_day=8,
               bd=boundary_from_numpy(jgcm.bd, device="cpu",
                                      dtype=torch.float64), device="cpu")
    jhyb = jmodel.HybridAtmosphere(jgcm, jhyb0.layout, jhyb0.packs,
                                   ml_only=False,
                                   ocean_packs=jhyb0.ocean_packs,
                                   base_sst=jhyb0.base_sst,
                                   sea_mask=jhyb0.sea_mask)
    thyb = HybridAtmosphere(tgcm, thyb0.layout, thyb0.packs, ml_only=False,
                            ocean_packs=thyb0.ocean_packs,
                            base_sst=thyb0.base_sst,
                            sea_mask=thyb0.sea_mask, device="cpu")
    for h in (jhyb, thyb):
        h.persist_surface = True
        h.SLAB_STRIDE = 4
    sst = np.asarray(jgcm.bd.sst12[0])
    js = jhyb.init_state(jnp.asarray(sst))
    rng = np.random.default_rng(12)
    jocean = tuple(dataclasses.replace(
        o, buffer=jnp.asarray(rng.normal(0.0, 1.0, o.buffer.shape)),
        lm=jnp.asarray(rng.normal(0.0, 1.0, o.lm.shape))) for o in js.ocean)
    js = dataclasses.replace(js, ocean=jocean,
                             step=jnp.asarray(2, dtype=jnp.int32))
    ts = dataclasses.replace(
        thyb.init_state(sst), step=2,
        ocean=ocean_states_from_numpy(
            [jax.tree_util.tree_map(np.asarray, o) for o in jocean], 2,
            device="cpu", dtype=torch.float64))
    date = ModelDate(1990, 1, 1)
    for step in (2, 3):
        args = (date.month - 1, date.tmonth, date.tyear)
        js, jd = jhyb.cycle(js, jnp.asarray(args[0]), jnp.asarray(args[1]),
                            jnp.asarray(args[2]))
        sst_before = ts.sst_grid
        ts, td = thyb.cycle(ts, *args)
        assert ts.step == int(js.step) == step + 1
        assert bool(ts.safe) and bool(js.safe)
        assert (ts.sst_grid is not sst_before) == (step == 3)
        _signal_close(ts.sst_grid, js.sst_grid)
        _close_ocean(ts, js, 1e-9)
        for jc, tc in zip(js.classes, ts.classes):
            _signal_close(tc.x, jc.x)
            _signal_close(tc.local_model, jc.local_model)
        _signal_close(td["speedy_atmo"][0], jd["speedy_atmo"][0])
        for k in ("stl_lm", "sst_om", "tice_om", "sst_am"):
            _signal_close(getattr(ts.sfc, k), getattr(js.sfc, k))
        date = date.advance_hours(6)

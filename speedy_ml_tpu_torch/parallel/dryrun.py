"""The multi-device dry run: the sharded cycle (the GCM sharded too, the
JAX default, and on the first device), the sharded training step and the
lat halo exchange at the production layout, each held against its
single-device counterpart (the JAX package's
__graft_entry__.dryrun_multichip).

    python -m speedy_ml_tpu_torch.parallel.dryrun N [--shared]

runs it on the first N CUDA devices, or with --shared on N shards of
cuda:0.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import time

import torch

from speedy_ml_tpu_torch.parallel.mesh import (Mesh, gather_rows, make_mesh,
                                               shard_reservoir, shard_rows)

# the training step: regions a device of the interior class, samples and
# batch (the JAX dry run's)
TRAIN_REGIONS_PER_DEVICE = 8
TRAIN_T, TRAIN_BATCH = 9, 4
# the cycle with the GCM sharded, on the CPU: each field within this
# fraction of its scale.  The plain versions' float32 matrix products may
# round a shard's sliced tables in the last bit (on the card each kernel
# sums in its own order, and it is bit for bit); one window grows that to
# 5.4e-5 of the scale of logp, a field of |log(ps/p0)| < 0.1, at T30 on
# 8 shards
CPU_GCM_RTOL = 1e-3


def _close(name: str, got, ref, rtol: float):
    """Raise unless |got - ref| <= rtol * max |ref| (finite both)."""
    err = float((got.double() - ref.double()).abs().max())
    scale = float(ref.double().abs().max())
    if not (torch.isfinite(got).all() and err <= rtol * scale):
        raise AssertionError(f"dryrun_multichip: sharded {name} != single-"
                             f"device (max |diff| {err:.3e}, {rtol:.0e} of "
                             f"{scale:.3e} allowed)")
    return err / max(scale, 1e-300)


def _differs(name: str, got, ref):
    """Raise unless got equals ref bit for bit (NaN in the same places)."""
    if got.shape != ref.shape or not torch.equal(
            torch.nan_to_num(got), torch.nan_to_num(ref)) or not torch.equal(
            got.isnan(), ref.isnan()):
        d = (got.double() - ref.double()).abs().max() \
            if got.shape == ref.shape else "shape"
        raise AssertionError(f"dryrun_multichip: sharded {name} != single-"
                             f"device (max |diff| {d})")


def sharded_training_step(res, hyper, z_in, target, model_in, x0,
                          batch_size: int, mesh: Mesh, solve_dtype=None):
    """accumulate_batches on each device's regions, then
    solve_wout_sharded: (Wout, x) Sharded by regions.  z_in, target,
    model_in (T, R, .) and x0 (R, n) are whole tensors."""
    from speedy_ml_tpu_torch.esn.train import (NormalEq, accumulate_batches,
                                               solve_wout_sharded)
    res_sh = shard_reservoir(res, mesh)
    series = [shard_rows(t, mesh, dim=1) for t in (z_in, target, model_in)]
    x0_sh = shard_rows(x0, mesh)
    eqs, xs = [], []
    for d in range(mesh.size):
        eq, x = accumulate_batches(res_sh[d], hyper, series[0][d],
                                   series[1][d], series[2][d], x0_sh[d],
                                   batch_size)
        eqs.append(eq)
        xs.append(x)
    S = model_in.shape[2]
    wout = solve_wout_sharded(NormalEq(tuple(e.ss for e in eqs),
                                       tuple(e.st for e in eqs)),
                              hyper, S, mesh, solve_dtype=solve_dtype)
    return wout, xs


def check_training_step(pack, mesh: Mesh, seed: int = 1) -> tuple:
    """The dry run's training step on `pack`'s first 8 regions a device
    (T = 9 seeded samples, batches of 4, the solve in float64): the
    sharded step against accumulate_batches and solve_wout on all of
    them, Wout and the states bit for bit; raises on a mismatch.  Returns
    Wout's shape."""
    from speedy_ml_tpu_torch.esn.train import accumulate_batches, solve_wout
    dev = mesh.devices[0]
    Rt = TRAIN_REGIONS_PER_DEVICE * mesh.size
    r = pack.res
    res = dataclasses.replace(
        r, vals=r.vals[:, :Rt].contiguous(), win_vals=r.win_vals[:Rt],
        wout=r.wout[:Rt], mean=r.mean[:Rt], std=r.std[:Rt])
    dtype = res.vals.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    I, O, S = res.n_inputs, res.n_outputs, res.n_speedy
    z_in, target, model_in = (
        torch.randn((TRAIN_T, Rt, w), generator=gen, dtype=dtype, device=dev)
        for w in (I, O, S))
    x0 = torch.zeros((Rt, res.n), dtype=dtype, device=dev)
    eq, x_ref = accumulate_batches(res, pack.hyper, z_in, target, model_in,
                                   x0, TRAIN_BATCH)
    wout_ref = solve_wout(eq, pack.hyper, S, torch.float64)
    del eq
    wout, xs = sharded_training_step(res, pack.hyper, z_in, target,
                                     model_in, x0, TRAIN_BATCH, mesh,
                                     torch.float64)
    _differs("Wout", gather_rows(wout, dev), wout_ref)
    _differs("training state", gather_rows(xs, dev), x_ref)
    if not bool(torch.isfinite(wout_ref).all()):
        raise AssertionError("dryrun_multichip: Wout is not finite")
    return tuple(wout_ref.shape)


def check_lat_halo(field: torch.Tensor, mesh: Mesh, overlap: int = 1):
    """halo_exchange_lat of a (lat, lon) field over latitude bands against
    the rows it must deliver (zero past the poles); raises on a
    mismatch."""
    from speedy_ml_tpu_torch.parallel.halo import (halo_exchange_lat,
                                                   lat_shards)
    D, o = mesh.size, overlap
    band = field.shape[0] // D
    zero = torch.zeros_like(field[:o])
    for d, h in enumerate(halo_exchange_lat(lat_shards(field, mesh), o,
                                            mesh)):
        lo = d * band
        want = torch.cat([field[lo - o:lo] if d else zero,
                          field[lo:lo + band],
                          field[lo + band:lo + band + o] if d < D - 1
                          else zero])
        _differs(f"halo band {d}", h.to(field.device), want)


def dryrun_multichip(n_devices: int, mesh: Mesh | None = None,
                     m: int = 600, gcm_steps: int = 2, log=print) -> dict:
    """The sharded cycle, the training step and the halo exchange over an
    n_devices mesh at the production layout: T30 (96 x 48 x 8), all 1,152
    regions (class counts 48/1,056/48, divisible by 2, 4, 8), float32, the
    synthetic aquaplanet, `gcm_steps` leapfrog steps a window.

    1. one sharded cycle with the GCM sharded too (set_mesh(mesh), the
       JAX default: its spectral state over m ranges, its grid and physics
       over latitude bands) and one with the GCM on the first device
       (set_mesh(mesh, shard_gcm=False)), each against the unsharded cycle
       of the same parameters and state: the fields, every class's x,
       feedback and local model bit for bit (with the GCM sharded on the
       CPU, within CPU_GCM_RTOL of each one's scale);
    2. the training step (check_training_step): accumulate_batches on 8
       regions a device of the interior class (T = 9, batches of 4,
       seeded series), then solve_wout_sharded in float64, against
       accumulate_batches and solve_wout on all of them: Wout and the
       states bit for bit;
    3. halo_exchange_lat of the SST over latitude bands, against the
       rows it must deliver (zero past the poles).

    mesh: the devices (default make_mesh(n_devices), which raises when
    fewer are visible); its first device holds the GCM.  Raises on any
    mismatch; returns the seconds of each step."""
    from speedy_ml_tpu_torch.core.geometry import Geometry
    from speedy_ml_tpu_torch.gcm import GCM
    from speedy_ml_tpu_torch.hybrid.build import build_untrained_hybrid
    from speedy_ml_tpu_torch.physics.boundaries import \
        synthetic_boundary_data

    mesh = make_mesh(n_devices) if mesh is None else mesh
    if mesh.size != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}): the mesh has "
                         f"{mesh.size} devices")
    dev = mesh.devices[0]
    f32 = torch.float32
    seconds = {}
    t0 = time.perf_counter()
    g = Geometry()
    gcm = GCM(g, dtype=f32, bd=synthetic_boundary_data(g, dtype=f32,
                                                       device=dev),
              device=dev)
    hyb = build_untrained_hybrid(gcm, n_regions=1152, m=m, radius_iters=5,
                                 device=dev)
    hyb.gcm_steps = gcm_steps
    log(f"dryrun: T{g.trunc} hybrid of 1,152 regions, m={m}, {gcm_steps} "
        f"steps a window, on {mesh}")
    sst0 = gcm.bd.sst12[0]
    args = (0, 0.5, 0.05)

    # -- 1. the sharded cycles against the unsharded one --------------
    ref_state, ref_diag = hyb.cycle(hyb.init_state(sst0), *args)
    for shard_gcm in (True, False):
        t1 = time.perf_counter()
        shy = copy.copy(hyb)
        shy.set_mesh(mesh, shard_gcm=shard_gcm)
        new_state, diag = shy.cycle(shy.init_state(sst0), *args)
        exact = not shard_gcm or dev.type == "cuda"
        worst = 0.0
        for k, a, b in (
                [(k, diag[k], ref_diag[k]) for k in
                 ("atmo", "logp", "precip", "speedy_atmo", "speedy_logp")]
                + [(f"class {i} {nm}", gather_rows(getattr(a, nm), dev),
                    getattr(b, nm))
                   for i, (a, b) in enumerate(zip(new_state.classes,
                                                  ref_state.classes))
                   for nm in ("x", "feedback", "local_model")]):
            if exact:
                _differs(k, a, b)
            else:
                worst = max(worst, _close(k, a, b, CPU_GCM_RTOL))
        what = "with the GCM sharded" if shard_gcm else "the GCM whole"
        log(f"dryrun: sharded cycle ({what}) == single-device"
            + ("" if exact else f" within {worst:.2e} of a field's scale")
            + f" ({time.perf_counter() - t1:.1f} s)")
    seconds["cycle"] = time.perf_counter() - t0

    # -- 2. the training step ------------------------------------------
    t0 = time.perf_counter()
    shape = check_training_step(hyb.packs[1], mesh)   # the interior class
    seconds["training"] = time.perf_counter() - t0
    log(f"dryrun: sharded training step (Wout {shape}) == single-device "
        f"({seconds['training']:.1f} s)")

    # -- 3. the lat halo exchange --------------------------------------
    t0 = time.perf_counter()
    check_lat_halo(sst0, mesh)
    seconds["halo"] = time.perf_counter() - t0
    log(f"dryrun_multichip OK on {n_devices} devices at T30/1152 regions: "
        "sharded cycle and training step == single-device, lat halos "
        "exchanged")
    return seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--shared", action="store_true",
                    help="put every shard on cuda:0")
    args = ap.parse_args(argv)
    mesh = (Mesh([torch.device("cuda", 0)] * args.n_devices)
            if args.shared else None)
    dryrun_multichip(args.n_devices, mesh)


if __name__ == "__main__":
    main()

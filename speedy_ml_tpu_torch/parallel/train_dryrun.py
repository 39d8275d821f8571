"""The multichip training dry runs at the production reservoir size: the
sharded normal equations and ridge solve of m = 6000 reservoirs over a
device mesh, each device holding only its regions' Gram blocks.

Copies of the JAX package's scripts/dryrun_m6000_training.py and
scripts/multichip_train_full.py on the port's own pieces: the reservoirs
from esn/reservoir.py generate (the whole chunk's, then shard_reservoir),
the input width from hybrid/chunked.py hyper_inputs, the transient and
the accumulation from esn/train.py advance and accumulate_chunk (what
ClassTrainer.normal_equations runs: K14 on each shard's regions), the
solve from esn/train.py solve_wout_sharded (each device its own regions,
in float64), the moves from parallel/mesh.py.  The inputs are synthetic,
seeded with numpy (normal, mean 0, sd 0.5), as the scripts' are.

- dryrun_m6000: REGIONS_PER_SHARD regions a shard of the interior class,
  the transient advance, 2 accumulate chunks of C = 2, the sharded solve;
  asserts that each shard's Gram block is (Rt / D, A, A) on its own device
  and an allocation of its own (the full (Rt, A, A) block is never made
  on one device), and that Wout is finite and sharded.
- train_full: every region of every class, in chunks of
  REGIONS_PER_SHARD regions a shard (each chunk as above, C = 4), and a
  region-chunked slab-ocean Gram pass at m = 4000; reports the peak Gram
  bytes a device, the peak host RSS and the seconds of each stage.

    python -m speedy_ml_tpu_torch.parallel.train_dryrun N [--shared]
        [--full] [--out PATH]

runs dryrun_m6000 (and with --full train_full) on the first N CUDA
devices, or with --shared on N shards of cuda:0, and writes the result as
JSON to PATH when given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import time

import numpy as np
import torch

from speedy_ml_tpu_torch.parallel.mesh import (Mesh, Sharded, make_mesh,
                                               shard_reservoir, shard_rows)

REGIONS_PER_SHARD = 8
NVAR = 4


def _sync(mesh: Mesh):
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def peak_rss_gb() -> float:
    """The process's peak resident set so far, GB (getrusage)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def check_residency(ss, mesh: Mesh, Rloc: int, A: int, what: str = "Gram"):
    """Raise unless ss is a Sharded of mesh.size blocks, block d (Rloc, A,
    A) on mesh.devices[d] and an allocation of its own (no block a view
    of a larger tensor: the full block is never on one device)."""
    if not isinstance(ss, Sharded) or len(ss) != mesh.size:
        raise AssertionError(f"{what}: not sharded over the {mesh.size} "
                             f"shards of the mesh")
    for d, (t, dev) in enumerate(zip(ss, mesh.devices)):
        if tuple(t.shape) != (Rloc, A, A) or t.device != dev:
            raise AssertionError(f"{what} shard {d}: {tuple(t.shape)} on "
                                 f"{t.device}, expected ({Rloc}, {A}, {A}) "
                                 f"on {dev}")
        if t.untyped_storage().nbytes() != t.numel() * t.element_size():
            raise AssertionError(f"{what} shard {d} is a view of a larger "
                                 f"block")


def chunk_pass(mesh: Mesh, layout, rids, I: int, O: int, S: int, hyper,
               seed: int, rng, C: int, n_chunks: int, label: str,
               dtype=torch.float32) -> dict:
    """One resident pass over the regions rids (a multiple of mesh.size):
    generate, advance one chunk, accumulate n_chunks chunks of C samples
    on each shard, the residency check, the sharded float64 solve; raises
    on a failed check.  Returns its sizes and seconds."""
    from speedy_ml_tpu_torch.esn.reservoir import (BatchedReservoir,
                                                   generate, radius_by_lat)
    from speedy_ml_tpu_torch.esn.train import (NormalEq, accumulate_chunk,
                                               advance, solve_wout_sharded,
                                               zero_equations)
    D, Rt = mesh.size, len(rids)
    Rloc = Rt // D
    dev0 = mesh.devices[0]
    t0 = time.perf_counter()
    radius = radius_by_lat(layout.lat_start[rids], layout.lat_end[rids])
    cols, vals, win, shifts = generate(seed, Rt, I, hyper, radius,
                                       dtype=dtype, radius_iters=3,
                                       device=dev0)
    n = vals.shape[2]
    A = S + n
    res = BatchedReservoir(
        cols=cols, vals=vals, win_vals=win, n_in=I, shifts=shifts,
        wout=torch.zeros((Rt, O, 0), dtype=dtype, device=dev0),
        mean=torch.zeros((Rt, I), dtype=dtype, device=dev0),
        std=torch.ones((Rt, I), dtype=dtype, device=dev0))
    res_sh = shard_reservoir(res, mesh)
    del res, vals, win
    _sync(mesh)
    t_gen = time.perf_counter() - t0

    def draw(*shape):
        """A seeded (C, Rt, w) series, each shard's regions on its
        device."""
        a = torch.as_tensor(rng.normal(0, 0.5, shape).astype(np.float32))
        return shard_rows(a.to(dtype), mesh, dim=1)

    t0 = time.perf_counter()
    xs = [torch.zeros((Rloc, n), dtype=dtype, device=dev)
          for dev in mesh.devices]
    eqs = [zero_equations(Rloc, A, O, dtype, dev) for dev in mesh.devices]
    z = draw(C, Rt, I)
    xs = [advance(r, hyper, x, u) for r, x, u in zip(res_sh, xs, z)]
    for _ in range(n_chunks):
        z, target = draw(C, Rt, I), draw(C, Rt, O)
        model = draw(C, Rt, S) if S > 0 else [None] * D
        xs = [accumulate_chunk(r, hyper, x, eq, u, tg, m)
              for r, x, eq, u, tg, m in zip(res_sh, xs, eqs, z, target,
                                            model)]
    _sync(mesh)
    t_acc = time.perf_counter() - t0
    ss = Sharded(eq.ss for eq in eqs)
    check_residency(ss, mesh, Rloc, A)
    t0 = time.perf_counter()
    wout = solve_wout_sharded(NormalEq(ss, Sharded(eq.st for eq in eqs)),
                              hyper, S, mesh, solve_dtype=torch.float64)
    _sync(mesh)
    t_solve = time.perf_counter() - t0
    for d, (w, dev) in enumerate(zip(wout, mesh.devices)):
        if tuple(w.shape) != (Rloc, O, A) or w.device != dev:
            raise AssertionError(f"{label}: Wout shard {d} {tuple(w.shape)} "
                                 f"on {w.device}, expected ({Rloc}, {O}, "
                                 f"{A}) on {dev}")
        if not bool(torch.isfinite(w).all()):
            raise AssertionError(f"{label}: non-finite Wout on shard {d}")
    gram = Rloc * A * A * eqs[0].ss.element_size()
    return dict(regions=Rt, n=int(n), A=int(A), I=int(I), O=int(O),
                S=int(S), gram_shard_bytes=gram,
                solve_flops=Rt * (2.0 / 3.0 * A ** 3 + 2.0 * A * A * O),
                generate_s=t_gen, accumulate_s=t_acc, solve_s=t_solve)


def _layout(geom):
    from speedy_ml_tpu_torch.core.geometry import Geometry
    from speedy_ml_tpu_torch.esn.domain import RegionLayout
    geom = Geometry() if geom is None else geom
    return geom, RegionLayout(geom, n_regions=1152, overlap=1)


def _sizes(layout, cls, nz):
    from speedy_ml_tpu_torch.hybrid.chunked import hyper_inputs
    xc, yc = cls.core_shape
    O = NVAR * nz * xc * yc + 2 * xc * yc
    return hyper_inputs(layout, cls, nz), O, O - xc * yc


def dryrun_m6000(mesh: Mesh, m: int = 6000, geom=None,
                 regions_per_shard: int = REGIONS_PER_SHARD,
                 log=print) -> dict:
    """The m = 6000 residency dry run (dryrun_m6000_training.py) on `mesh`
    at the production layout (T30, 1,152 regions; geom another grid):
    regions_per_shard regions a shard of the interior class.  Raises on a
    failed check; returns the sizes and seconds."""
    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
    geom, layout = _layout(geom)
    cls = layout.classes[1]                 # the interior class
    Rt = regions_per_shard * mesh.size
    hyper = ESNHyper(m=m, deg=6, noise_mag=0.0, beta_res=0.05)
    I, O, S = _sizes(layout, cls, geom.nlev)
    log(f"train_dryrun: {Rt} interior regions at m={m} (I={I}, O={O}, "
        f"S={S}) on {mesh}")
    out = chunk_pass(mesh, layout, np.asarray(cls.region_ids[:Rt]), I, O, S,
                     hyper, 0, np.random.default_rng(0), C=2, n_chunks=2,
                     label="dryrun")
    out.update(n_devices=mesh.size, m=m,
               region_chunk_per_device=regions_per_shard,
               accumulate_chunks=2, samples_per_chunk=2,
               gram_resident_per_device=True, wout_finite=True)
    log(f"train_dryrun OK: A={out['A']}, Gram shard "
        f"{out['gram_shard_bytes'] / 1e9:.3f} GB a device, accumulate "
        f"{out['accumulate_s']:.2f} s, solve {out['solve_s']:.2f} s")
    return out


def train_full(mesh: Mesh, m: int = 6000, m_ocean: int = 4000, geom=None,
               regions_per_shard: int = REGIONS_PER_SHARD,
               log=print) -> dict:
    """The full training pass (multichip_train_full.py) on `mesh`: every
    region of every class in chunks of regions_per_shard regions a shard
    (the last chunk of a class padded to the shard count with its last
    region), each chunk generate, advance, 2 accumulate chunks of C = 4,
    the residency check and the sharded float64 solve; then one chunk of
    the slab ocean's bottom-class regions at m_ocean (SST-only readout).
    Raises on a failed check; returns the peak Gram bytes a device, the
    peak host RSS and each stage's seconds."""
    from speedy_ml_tpu_torch.esn.ocean import OCEAN_HYPER, ocean_index_map
    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
    t_start = time.perf_counter()
    geom, layout = _layout(geom)
    D = mesh.size
    chunk = regions_per_shard * D
    hyper = ESNHyper(m=m, deg=6, noise_mag=0.0, beta_res=0.05)
    rng = np.random.default_rng(0)
    chunks, total = [], 0
    for cls in layout.classes:
        I, O, S = _sizes(layout, cls, geom.nlev)
        ids = list(cls.region_ids)
        n_chunks = -(-len(ids) // chunk)
        log(f"train_full: class {cls.name}: {len(ids)} regions (I={I}, "
            f"O={O}) in {n_chunks} chunks of <= {chunk}")
        for c in range(n_chunks):
            part = ids[c * chunk:(c + 1) * chunk]
            real = len(part)
            while len(part) % D:
                part.append(part[-1])
            r = chunk_pass(mesh, layout, np.asarray(part), I, O, S, hyper,
                           1000 + 10 * c, rng, C=4, n_chunks=2,
                           label=f"{cls.name}/{c}")
            total += real
            chunks.append(dict(r, cls=cls.name, chunk=c, real=real))
    if total != layout.n_regions:
        raise AssertionError(f"train_full: {total} regions trained of "
                             f"{layout.n_regions}")
    ocls = layout.classes[0]
    o_ids = list(ocls.region_ids[:chunk])
    while len(o_ids) % D:
        o_ids.append(o_ids[-1])
    o_hyper = dataclasses.replace(OCEAN_HYPER, m=m_ocean, noise_mag=0.0,
                                  beta_res=0.01)
    xc, yc = ocls.core_shape
    I_o = int(ocean_index_map(ocls, geom.nlev).shape[0])
    slab = chunk_pass(mesh, layout, np.asarray(o_ids), I_o, xc * yc, 0,
                      o_hyper, 77, rng, C=4, n_chunks=2, label="slab")
    stage = lambda k: sum(c[k] for c in chunks)
    flops = sum(c["solve_flops"] for c in chunks)
    out = dict(
        n_devices=D, m=m, m_ocean=m_ocean, regions_total=layout.n_regions,
        regions_trained=total, chunk_regions=chunk, chunks=len(chunks),
        region_chunk_per_device=regions_per_shard,
        gram_shard_bytes_max=max(c["gram_shard_bytes"] for c in chunks
                                 + [slab]),
        gram_resident_per_device=True, slab=slab,
        generate_s=stage("generate_s"), accumulate_s=stage("accumulate_s"),
        solve_s=stage("solve_s"), solve_flops=flops,
        solve_tflops_s=flops / max(stage("solve_s"), 1e-30) / 1e12,
        total_s=time.perf_counter() - t_start,
        peak_host_rss_gb=peak_rss_gb(), wout_finite=True,
        chunks_detail=[{k: c[k] for k in ("cls", "chunk", "real", "A",
                                          "accumulate_s", "solve_s")}
                       for c in chunks])
    log(f"train_full OK: {total} regions in {len(chunks)} chunks, "
        f"{out['total_s']:.1f} s (generate {out['generate_s']:.1f}, "
        f"accumulate {out['accumulate_s']:.1f}, solve {out['solve_s']:.1f} "
        f"s at {out['solve_tflops_s']:.2f} TFLOP/s; the slab chunk "
        f"{slab['accumulate_s'] + slab['solve_s']:.1f} s); Gram "
        f"{out['gram_shard_bytes_max'] / 1e9:.3f} GB a device at most, "
        f"peak host RSS {out['peak_host_rss_gb']:.1f} GB")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--shared", action="store_true",
                    help="put every shard on cuda:0")
    ap.add_argument("--full", action="store_true",
                    help="also run the full training pass (train_full)")
    ap.add_argument("--out", help="write the result as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_dryrun: no CUDA device")
    mesh = (Mesh([torch.device("cuda", 0)] * args.n_devices)
            if args.shared else make_mesh(args.n_devices))
    result = dict(dryrun_m6000=dryrun_m6000(mesh))
    if args.full:
        result["train_full"] = train_full(mesh)
    result["device"] = torch.cuda.get_device_name(0)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (speedy_ml_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--ptxas]

Phases, each fatal on failure (exit code 1, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from speedy_ml_tpu_torch/kernels/csrc
     (nvcc for sm_90a, one process per source);
  3. build the untrained ML-only hybrid at full width (T30L8, 1,152
     regions, m=6000) on the card and cast its Wout to bf16;
  4. hold every kernel (K1 ESN step, K2 readout, K3 window gather, K4 core
     scatter) against its plain PyTorch version on the main path's inputs,
     with its tolerance, and time kernel, plain version and (K2) the
     torch.bmm yardstick: device time from torch.profiler, call time
     (host gaps included) from CUDA events.  K2's product is checked bare
     (no unstandardize), against a negative control: the product with
     aug left unrounded must fail the same tolerance;
  5. drive the main path, run_prediction, with every launch counter set to
     0 before and read after; check the written fields (finite, T in
     [150, 350] K) and time the cycle;
  6. one cycle with the kernels against the same cycle through the plain
     versions, from the same state.
The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device or
without the package beside this script.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense rates (at the 700 W limit)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_BF16_S = 989e12

SEED = 0
M = 6000
N_REGIONS = 1152
CYCLES = 16         # cycles of the main-path run (at least 8)
# K2 tolerance, a fraction of the bare product's scale: about 100 times
# the f32 summation error, 20 below the unrounded-aug fault on the card
K2_RTOL = 2e-5


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def time_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def _self_device_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def profile_device(torch, fn, reps: int):
    """torch.profiler (CUPTI) over reps calls of fn(): (device ms per call
    summed over every kernel, copy and fill fn runs, key_averages)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    return sum(_self_device_us(e) for e in avg) / 1e3 / reps, avg


def measure(torch, fn, reps: int = 10, warmup: int = 2):
    """(device_ms, call_ms) per call of fn(): device_ms from the profiler,
    call_ms from CUDA events around back-to-back calls (host gaps
    included).  Fails where the profiler sees no device time: the event
    time of a small kernel is its Python wrapper's, not the kernel's."""
    call = time_ms(torch, fn, reps, warmup)
    dev, _ = profile_device(torch, fn, reps)
    if dev <= 0:
        fail("torch.profiler saw no device time")
    return dev, call


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def sst_month0(geom):
    """synthetic_boundary_data's month-0 SST (zonal, seasonal term)."""
    import numpy as np
    lat = geom.lat_radians
    ones = np.ones((geom.nlat, geom.nlon))
    sst = (273.0 + 27.0 * np.cos(lat)[:, None] ** 2 * ones
           + 2.0 * np.sin(lat)[:, None] * np.cos(2 * np.pi * 0.5 / 12) * ones)
    return np.maximum(sst, 271.4)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's ptxas report for every kernel")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    if not (ROOT / "speedy_ml_tpu_torch" / "__init__.py").exists():
        fail(f"the speedy_ml_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, str(ROOT))
    from speedy_ml_tpu_torch.data.calendar import ModelDate
    from speedy_ml_tpu_torch.hybrid.build import build_untrained_hybrid
    from speedy_ml_tpu_torch.hybrid.driver import run_prediction
    from speedy_ml_tpu_torch.kernels import build as kb
    from speedy_ml_tpu_torch.kernels.core_scatter import (core_scatter,
                                                          core_scatter_plain)
    from speedy_ml_tpu_torch.kernels.esn_step import esn_step, esn_step_plain
    from speedy_ml_tpu_torch.kernels.readout import (quad_expand, readout,
                                                     readout_plain)
    from speedy_ml_tpu_torch.kernels.window_gather import (
        window_gather, window_gather_plain)

    # -- 2. build ------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = kb.build(verbose=args.ptxas)
    kb.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{lib_path.relative_to(ROOT)}")

    # -- 3. the full-width hybrid --------------------------------------
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    hyb = build_untrained_hybrid(None, n_regions=N_REGIONS, m=M, seed=SEED,
                                 ml_only=True, radius_iters=30, device=dev)
    hyb.cast_wout_bf16()
    torch.cuda.synchronize()
    g = hyb.geom
    log(f"hybrid: T{g.trunc}L{g.nlev} {g.nlat}x{g.nlon}, {N_REGIONS} "
        f"regions, m={M}, classes "
        + ", ".join(f"{p.cls.name}: R={p.cls.count} n={p.res.n} "
                    f"I={p.res.n_in} J={p.res.vals.shape[0]} "
                    f"wout={tuple(p.res.wout.shape)} {p.res.wout.dtype}"
                    for p in hyb.packs)
        + f"; built in {time.perf_counter() - t0:.1f} s")
    state0 = hyb.init_state(sst_month0(g))
    # two cycles so that x and the feedback are the main path's, not zeros
    tyear = ModelDate(1990, 1, 1).tyear
    s = state0
    for _ in range(2):
        s, _ = hyb.cycle(s, 0, 0.5, tyear)
    torch.cuda.synchronize()
    packs = hyb.packs
    nz, nlat, nlon = hyb.nz, g.nlat, g.nlon

    # -- 4. kernels against their plain versions ------------------------
    results = {}

    def record(name, src, replaces, err, tol, kernel, plain, bound,
               library=None):
        """kernel/plain/library: (device_ms, call_ms) from measure()."""
        ok = err <= tol
        log(f"{name}: max_abs_err={err:.3e} (tolerance {tol:.3e}) "
            f"kernel_ms={kernel[0]:.4f} (call {kernel[1]:.4f}) "
            f"plain_ms={plain[0]:.4f} (call {plain[1]:.4f}) "
            f"bound_ms={bound[0]:.4f} ({bound[1]}, "
            f"{bound[0] / kernel[0]:.0%} of it)"
            + (f" library_ms={library[0]:.4f} (call {library[1]:.4f})"
               if library is not None else "")
            + ("" if ok else "  <-- FAIL"))
        results[name] = dict(
            name=name, route="cuda", source=src, replaces=replaces,
            max_abs_err=err, ms=kernel[0], plain_ms=plain[0],
            bound_ms=bound[0], bound_by=bound[1],
            library_ms=None if library is None else library[0])
        return ok

    ok = True
    # K1: ESN step, all classes (one launch each), plus the linear mode
    step_args = [dict(vals=p.res.vals, x=cs.x, u=cs.feedback,
                      win_vals=p.res.win_vals, shifts=p.res.shifts,
                      cols=None if p.res.shifts is not None else p.res.cols,
                      win_cols=p.res.win_cols, leakage=p.hyper.leakage)
                 for p, cs in zip(packs, s.classes)]
    err = 0.0
    for a in step_args:
        for linear in (False, True):
            k = esn_step(**a, linear=linear)
            pl = esn_step_plain(**a, linear=linear)
            err = max(err, float((k - pl).abs().max()))
    nbytes = ops = 0
    for a in step_args:
        J, R, n = a["vals"].shape
        nbytes += 4 * (J * R * n + 3 * R * n + a["u"].numel())
        ops += R * n * (2 * J + 4)
    ok &= record(
        "K1_esn_step", "speedy_ml_tpu_torch/kernels/csrc/esn_step.cu",
        "speedy_ml_tpu/esn/reservoir.py:339", err, 1e-5,
        measure(torch, lambda: [esn_step(**a) for a in step_args]),
        measure(torch, lambda: [esn_step_plain(**a) for a in step_args]),
        bound_ms(nbytes, ops, PEAK_F32_S))

    # K2: readout with bf16 Wout.  The product is compared bare: the
    # 250 K out_mean of the epilogue would hide its error under its own
    # ulp.  The negative control, the product with aug not rounded to
    # bf16 (the rounding fault most likely in K2), must fail the
    # tolerance.  The fused unstandardize (explicitly rounded multiply,
    # then add) is checked apart, to one ulp.
    xs = [esn_step(**a) for a in step_args]
    ro_args = [dict(wout=p.res.wout, x=x, local_model=None,
                    out_mean=p.std.out_mean, out_std=p.std.out_std)
               for p, x in zip(packs, xs)]
    err = scale = err_ctl = err_epi = ulp_epi = 0.0
    for a in ro_args:
        k = readout(a["wout"], a["x"])
        pl = readout_plain(a["wout"], a["x"])
        ctl = torch.einsum("roa,ra->ro", a["wout"].float(),
                           quad_expand(a["x"]))
        err = max(err, float((k - pl).abs().max()))
        err_ctl = max(err_ctl, float((ctl - pl).abs().max()))
        scale = max(scale, float(pl.abs().max()))
        ref = k * a["out_std"] + a["out_mean"]
        err_epi = max(err_epi, float((readout(**a) - ref).abs().max()))
        ulp_epi = max(ulp_epi, float(
            (torch.finfo(torch.float32).eps * ref.abs()).max()))
    log(f"K2 negative control (aug not rounded to bf16): max_abs_err="
        f"{err_ctl:.3e} against the tolerance {K2_RTOL * scale:.3e}; "
        f"unstandardize epilogue: {err_epi:.3e} (tolerance {ulp_epi:.3e})")
    if err_ctl <= K2_RTOL * scale:
        fail("K2's tolerance does not tell a readout with unrounded aug "
             "from the right one")
    if err_epi > ulp_epi:
        fail("K2's unstandardize epilogue disagrees")
    augs = [quad_expand(a["x"]).to(torch.bfloat16)[:, :, None].contiguous()
            for a in ro_args]
    nbytes = ops = 0
    for a in ro_args:
        R, O, A = a["wout"].shape
        nbytes += (a["wout"].numel() * a["wout"].element_size()
                   + 4 * (a["x"].numel() + 3 * R * O))
        ops += 2 * R * O * A
    ok &= record(
        "K2_readout", "speedy_ml_tpu_torch/kernels/csrc/readout.cu",
        "speedy_ml_tpu/esn/reservoir.py:362", err, K2_RTOL * scale,
        measure(torch, lambda: [readout(**a) for a in ro_args]),
        measure(torch, lambda: [readout_plain(**a) for a in ro_args],
                reps=3, warmup=1),
        bound_ms(nbytes, ops, PEAK_BF16_S),
        library=measure(torch, lambda: [
            torch.bmm(a["wout"], x) for a, x in zip(ro_args, augs)]))

    # K4: core scatter + clamps, one launch
    outs = [readout(**a) for a in ro_args]
    kt = core_scatter(outs, hyb.core_table, 4, nz, nlat, nlon)
    pt = core_scatter_plain(outs, hyb.core_table, 4, nz, nlat, nlon)
    err = max(float((k - p).abs().max()) for k, p in zip(kt, pt))
    ulp = max(float((torch.finfo(torch.float32).eps * p.abs()).max())
              for p in pt)
    total = hyb.core_table.numel()
    ok &= record(
        "K4_core_scatter", "speedy_ml_tpu_torch/kernels/csrc/core_scatter.cu",
        "speedy_ml_tpu/esn/domain.py:290", err, ulp,
        measure(torch, lambda: core_scatter(outs, hyb.core_table, 4, nz,
                                            nlat, nlon), reps=50),
        measure(torch, lambda: core_scatter_plain(outs, hyb.core_table, 4,
                                                  nz, nlat, nlon), reps=50),
        bound_ms(4 * (2 * total + sum(o.numel() for o in outs)), 2 * total,
                 PEAK_F32_S))

    # K3: window gather + standardize, one launch for all classes
    atmo, logp, precip = kt
    tisr = hyb.tisr_field(tyear).contiguous()
    fields = (atmo, logp, precip, s.sst_grid, tisr)
    ga = (fields, hyb.feedback_index, [p.std.in_mean for p in packs],
          [p.std.in_std for p in packs])
    kf = window_gather(*ga)
    pf = window_gather_plain(*ga)
    err = max(float((k - p).abs().max()) for k, p in zip(kf, pf))
    ulp = max(float((torch.finfo(torch.float32).eps * p.abs()).max())
              for p in pf)
    n_out = sum(i.numel() for i in hyb.feedback_index)
    n_src = sum(f.numel() for f in fields)
    ok &= record(
        "K3_window_gather",
        "speedy_ml_tpu_torch/kernels/csrc/window_gather.cu",
        "speedy_ml_tpu/esn/domain.py:252", err, ulp,
        measure(torch, lambda: window_gather(*ga), reps=50),
        measure(torch, lambda: window_gather_plain(*ga), reps=50),
        bound_ms(4 * (4 * n_out + n_src), 2 * n_out, PEAK_F32_S))
    if not ok:
        fail("a kernel disagrees with its plain version")

    # the modes off the main path, on the interior class: K1 with shared
    # and per-region cols tables and a win_cols map (imported weights),
    # K2 with f32 Wout and with a local-model block (S > 0)
    p, a = packs[1], step_args[1]
    R, n = a["x"].shape
    q = n // a["u"].shape[1]
    win_cols = (torch.arange(n, device=dev, dtype=torch.int32) // q) \
        .expand(R, n).contiguous()
    ref = esn_step(**a)
    for kw in (dict(shifts=None, cols=p.res.cols),
               dict(shifts=None,
                    cols=p.res.cols.expand(R, -1, -1).contiguous()),
               dict(win_cols=win_cols)):
        b = dict(a, **kw)
        k, pl = esn_step(**b), esn_step_plain(**b)
        err = max(float((k - pl).abs().max()), float((k - ref).abs().max()))
        if err > 1e-5:
            fail(f"K1 mode {sorted(kw)} disagrees: {err:.3e}")
    S = 40
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lm = torch.randn((R, S), generator=gen, device=dev)
    w_s = torch.cat([1e-3 * torch.randn((R, p.res.n_outputs, S),
                                        generator=gen, device=dev)
                     .to(torch.bfloat16), p.res.wout], dim=2)
    x = ro_args[1]["x"]
    worst = 0.0
    for w, l in ((p.res.wout.float(), None), (w_s, lm), (w_s.float(), lm)):
        k, pl = readout(w, x, l), readout_plain(w, x, l)
        err = float((k - pl).abs().max())
        sc = float(pl.abs().max())
        worst = max(worst, err / sc)
        if err > K2_RTOL * sc:
            fail(f"K2 ({w.dtype}, S={0 if l is None else S}) disagrees: "
                 f"{err:.3e} > {K2_RTOL * sc:.3e}")
    del w_s
    log("K1 cols/win_cols modes and K2 f32 / local-model forms agree with "
        f"their plain versions (K2 worst {worst:.3e} of its scale)")

    # -- 5. the main path: run_prediction ------------------------------
    kernels = {"K1_esn_step": esn_step, "K2_readout": readout,
               "K3_window_gather": window_gather,
               "K4_core_scatter": core_scatter}
    out_path = ROOT / "output" / "chip_smoke" / "prediction.npz"
    out_path.unlink(missing_ok=True)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    final, dates = run_prediction(hyb, state0, ModelDate(1990, 1, 1),
                                  CYCLES, output_path=str(out_path))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"main path: run_prediction {len(dates)} cycles in {wall:.3f} s "
        f"({wall / len(dates) * 1e3:.3f} ms/cycle with the writer); "
        f"launches {launches}")
    if len(dates) != CYCLES:
        fail(f"run_prediction stopped after {len(dates)} cycles")
    for name, count in launches.items():
        if count <= 0:
            fail(f"{name} was not launched on the main path")
        results[name]["launches"] = count
    z = np.load(out_path)
    shapes = {k: z[k].shape for k in z.files}
    want = {"atmo": (CYCLES, 4, nz, nlat, nlon),
            "logp": (CYCLES, nlat, nlon),
            "precip": (CYCLES, nlat, nlon),
            "sst": (CYCLES, nlat, nlon)}
    if shapes != want:
        fail(f"prediction stream shapes {shapes}, expected {want}")
    for k in z.files:
        if not np.isfinite(z[k]).all():
            fail(f"prediction field {k} is not finite")
    t_field = z["atmo"][:, 0]
    if not (150.0 <= t_field.min() and t_field.max() <= 350.0):
        fail(f"T outside [150, 350] K: {t_field.min()}..{t_field.max()}")
    q = z["atmo"][:, 3]
    if q.min() < 1e-6 * (1 - 1e-6):
        fail(f"q below the 1e-6 clamp: {q.min()}")
    log(f"fields: finite, T {t_field.min():.3f}..{t_field.max():.3f} K, "
        f"q min {q.min():.3e}, precip max {z['precip'].max():.3e}")

    # cycle time on the main path without the writer: run_prediction over
    # 20 cycles, host clock to a synchronize, 5 repeats (the host is
    # shared, so its clock spreads); device busy from one profiled run
    st = final
    n_t = 20
    run = lambda: run_prediction(hyb, st, ModelDate(1990, 1, 1), n_t)
    run()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / n_t * 1e3)
    walls.sort()
    cycle_ms = walls[2]
    busy_ms, avg = profile_device(torch, run, reps=1)
    busy_ms /= n_t
    log(f"cycle_ms: {cycle_ms:.4f} median (min {walls[0]:.4f}, max "
        f"{walls[-1]:.4f}) over 5 runs of run_prediction x {n_t} cycles, "
        f"no writer; device busy {busy_ms:.4f} ms/cycle, idle share "
        f"{1 - busy_ms / cycle_ms:.0%} of the median; "
        f"{6 * 3.6e6 / cycle_ms / 365:.0f} sim-years/day")
    top = sorted(avg, key=_self_device_us, reverse=True)[:8]
    for e in top:
        log(f"  cycle kernel {e.key[:60]}: "
            f"{_self_device_us(e) / n_t / 1e3:.4f} ms/cycle, "
            f"{e.count / n_t:g} launches/cycle")

    # -- 6. one cycle with the kernels vs the plain versions -----------
    k_state, k_diag = hyb.cycle(st, 0, 0.5, tyear)
    p_x, p_out = [], []
    for p, cs in zip(packs, st.classes):
        x = esn_step_plain(p.res.vals, cs.x, cs.feedback, p.res.win_vals,
                           shifts=p.res.shifts,
                           cols=None if p.res.shifts is not None
                           else p.res.cols,
                           win_cols=p.res.win_cols, leakage=p.hyper.leakage)
        p_out.append(readout_plain(p.res.wout, x, None, p.std.out_mean,
                                   p.std.out_std))
        p_x.append(x)
    p_grid = core_scatter_plain(p_out, hyb.core_table, 4, nz, nlat, nlon)
    p_fb = window_gather_plain(
        (*p_grid, st.sst_grid, hyb.tisr_field(tyear).contiguous()),
        hyb.feedback_index, [p.std.in_mean for p in packs],
        [p.std.in_std for p in packs])
    scale = max(float((o - p.std.out_mean).abs().max())
                for o, p in zip(p_out, packs))
    err_x = max(float((a.x - b).abs().max())
                for a, b in zip(k_state.classes, p_x))
    err_f = max(float((k_diag[n] - b).abs().max())
                for n, b in zip(("atmo", "logp", "precip"), p_grid))
    err_fb = max(float((a.feedback - b).abs().max())
                 for a, b in zip(k_state.classes, p_fb))
    log(f"cycle kernels vs plain: x {err_x:.3e} (tol 1e-5), fields "
        f"{err_f:.3e} and feedback {err_fb:.3e} (tol {1e-3 * scale:.3e}, "
        f"1e-3 of the readout scale {scale:.3e})")
    if err_x > 1e-5 or err_f > 1e-3 * scale or err_fb > 1e-3 * scale:
        fail("the kernel cycle disagrees with the plain cycle")

    order = ("K1_esn_step", "K2_readout", "K3_window_gather",
             "K4_core_scatter")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: results[n][k] for k in keys}
                                  for n in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

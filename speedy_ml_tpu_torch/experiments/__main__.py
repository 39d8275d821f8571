"""The experiment programs from the command line:

    python -m speedy_ml_tpu_torch.experiments climate --out DIR
        [--m 3000] [--n 8760] [--years 20] [--ocean-beta 0.01]
        [--atmo-beta 0.05] [--rchunk 96] [--ocean-rchunk 32]
        [--dispatch 32] [--mmap] [--base FILE] [--bc-path DIR]
    python -m speedy_ml_tpu_torch.experiments skill --out DIR
        [--n-train 2000] [--m 3000] [--topos shift,random] [--bc-path DIR]

climate runs stages A-E into DIR (the result in DIR/CLIMATE_RUN.json);
skill writes DIR/SKILL_PROD_RESULT.json (arms merge into an existing
file).  Both keep the twin cache in DIR.  --bc-path (default
$SPEEDY_ML_BC_PATH) names the reference's fort.20-26 files; without
either the truth runs on the synthetic aquaplanet.  The figures are drawn
where matplotlib is installed.  The programs run on CUDA; with no CUDA
device the command exits non-zero before it writes anything.  From
Python, main([...], device="cpu") runs them on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import sys
from pathlib import Path

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.experiments.climate_run import (ClimateConfig,
                                                         run_climate)
from speedy_ml_tpu_torch.experiments.skill_experiment import (SkillConfig,
                                                              run_skill,
                                                              skill_figure)
from speedy_ml_tpu_torch.experiments.twin import ExperimentAbort, twin_setup
from speedy_ml_tpu_torch.physics.boundaries import BC_PATH_ENV


def _options(sub, config):
    """One option per field of the config dataclass, with its default."""
    for f in dataclasses.fields(config):
        flag = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            sub.add_argument(flag, action="store_true")
        elif f.name == "topos":
            sub.add_argument(flag, default=",".join(f.default))
        else:
            kind = {"int": int, "float": float}.get(str(f.type), str)
            sub.add_argument(flag, type=kind, default=f.default)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m speedy_ml_tpu_torch.experiments",
        description=__doc__.split("\n\n")[0])
    subs = ap.add_subparsers(dest="program", required=True)
    for name, config in (("climate", ClimateConfig), ("skill", SkillConfig)):
        sub = subs.add_parser(name)
        sub.add_argument("--out", required=True)
        sub.add_argument("--bc-path", default=os.environ.get(BC_PATH_ENV))
        _options(sub, config)
    return ap


def main(argv=None, *, device=None) -> int:
    args = _parser().parse_args(argv)
    try:
        device = resolve_device(device)
    except RuntimeError as e:
        print(f"speedy_ml_tpu_torch.experiments {args.program}: {e}",
              file=sys.stderr)
        return 1
    out = Path(args.out)
    draw = importlib.util.find_spec("matplotlib") is not None
    if not draw:
        print("matplotlib is not installed: no figures")
    twin = twin_setup(boundary_path=args.bc_path, device=device)
    print(f"boundary data: {twin.source}")
    try:
        if args.program == "climate":
            cfg = ClimateConfig(**{f.name: getattr(args, f.name)
                                   for f in dataclasses.fields(ClimateConfig)})
            run_climate(cfg, out, out / "CLIMATE_RUN.json", twin=twin,
                        figures=draw)
        else:
            cfg = SkillConfig(n_train=args.n_train, m=args.m,
                              topos=tuple(args.topos.split(",")))
            results = run_skill(cfg, out / "SKILL_PROD_RESULT.json",
                                twin=twin)
            if draw and "shift" in results:
                skill_figure(out / "SKILL_PROD_RESULT.json",
                             out / "SKILL_PROD_FIG.png")
    except ExperimentAbort as e:
        print(f"ABORT: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

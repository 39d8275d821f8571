"""Import hygiene and device policy of the PyTorch port.

The port (speedy_ml_tpu_torch) and chip_smoke.py must not import JAX or
the JAX package; its entry points run on CUDA unless the caller names
the CPU, and raise instead of carrying on on the CPU.  Kernel wrappers
run their plain version on a CPU tensor without counting a launch.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_lane import one_thread_per_pool  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "speedy_ml_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import speedy_ml_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "speedy_ml_tpu"
             or m.startswith("speedy_ml_tpu."))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15
    assert bad == "[]"


TRAINING_MODULES = ("esn/train.py", "hybrid/training.py",
                    "hybrid/chunked.py", "kernels/gram_update.py")


def test_training_modules_are_checked():
    """The trainer's modules are among those both checks read."""
    files = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert set(TRAINING_MODULES) <= files
    code = _IMPORT_ALL.replace("print(len(names), bad)",
                               "print(sorted(names))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for m in TRAINING_MODULES:
        name = "speedy_ml_tpu_torch." + m[:-3].replace("/", ".")
        assert repr(name) in out.stdout, name


IO_MODULES = ("data/checkpoint.py", "data/era.py", "data/model_states.py",
              "data/reference_import.py", "physics/boundaries.py")


def test_port_imports_without_h5py():
    """The machine with the card has no h5py: every module of the port
    and chip_smoke import with it hidden (the readers import it where
    they read), and still load no JAX; the reader modules are among
    them."""
    code = "import sys\nsys.modules['h5py'] = None\n" + _IMPORT_ALL.replace(
        "print(len(names), bad)",
        "assert 'h5py' not in [m for m in sys.modules if sys.modules[m]]\n"
        "print(len(names), bad, sorted(names))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad, names = out.stdout.strip().split(" ", 2)
    assert int(n) >= 20 and bad == "[]"
    files = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert set(IO_MODULES) <= files
    for m in IO_MODULES:
        assert repr("speedy_ml_tpu_torch." + m[:-3].replace("/", ".")) \
            in names, m


CLI_MODULES = ("config.py", "main.py", "analysis.py", "plots.py",
               "data/netcdf_export.py", "runtime/native.py")


def test_port_imports_without_matplotlib_or_h5py():
    """The machine with the card has neither matplotlib nor h5py: every
    module of the port, the CLI's among them, and chip_smoke import with
    both hidden and load neither (plots imports matplotlib inside its
    functions)."""
    code = ("import sys\nsys.modules['h5py'] = None\n"
            "sys.modules['matplotlib'] = None\n") + _IMPORT_ALL.replace(
        "print(len(names), bad)",
        "loaded = sorted(m for m in sys.modules if sys.modules[m] and "
        "m.split('.')[0] in ('h5py', 'matplotlib'))\n"
        "print(len(names), bad, loaded, sorted(names))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, rest = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20
    assert rest.startswith("[] [] "), rest[:200]
    files = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    assert set(CLI_MODULES) <= files
    for m in CLI_MODULES:
        assert repr("speedy_ml_tpu_torch." + m[:-3].replace("/", ".")) \
            in rest, m


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_statement(path):
    """Also the imports inside functions (chip_smoke imports lazily)."""
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "speedy_ml_tpu"), mod


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_unless_asked(monkeypatch, tmp_path):
    from speedy_ml_tpu_torch import resolve_device
    from speedy_ml_tpu_torch.core.geometry import Geometry
    from speedy_ml_tpu_torch.core.spectral import SpectralTransform
    from speedy_ml_tpu_torch.dycore.model import DycoreModel
    from speedy_ml_tpu_torch.esn.reservoir import ESNHyper, generate
    from speedy_ml_tpu_torch.gcm import GCM
    from speedy_ml_tpu_torch.hybrid.build import build_untrained_hybrid
    from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
    from speedy_ml_tpu_torch.core.constants import PhysicalConstants
    from speedy_ml_tpu_torch.physics.boundaries import (load_npz, save_npz,
                                                        synthetic_boundary_data)
    from speedy_ml_tpu_torch.physics.driver import PhysicsModel

    g = Geometry(trunc=10, nlon=32, nlat=16, nlev=8)
    bd = synthetic_boundary_data(g)
    npz = tmp_path / "bd.npz"
    save_npz(bd, str(npz))
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PhysicsModel(g, PhysicalConstants())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_npz(str(npz))
    assert PhysicsModel(g, PhysicalConstants(), device="cpu") \
        .sig_t.device.type == "cpu"
    assert load_npz(str(npz), device="cpu").orog.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_untrained_hybrid(n_regions=1152, m=6000, ml_only=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_untrained_hybrid()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_untrained_hybrid(object(), ml_only=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpectralTransform(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DycoreModel(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GCM(g, bd=bd)
    # asked for, the CPU works
    gcm = GCM(g, bd=bd, device="cpu")
    assert gcm.phis.device.type == "cpu" and gcm.sht.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridAtmosphere(None, None, [], ml_only=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(0, 2, 48, ESNHyper(m=300), 0.5)
    from speedy_ml_tpu_torch.esn.domain import RegionLayout
    from speedy_ml_tpu_torch.hybrid.chunked import (ArraySource,
                                                    streaming_standardizer,
                                                    train_hybrid_production)
    from speedy_ml_tpu_torch.hybrid.training import train_class, train_hybrid
    layout = RegionLayout(g, n_regions=128)
    src = ArraySource({"atmo": np.zeros((2, 4, 8, 16, 32))})
    for call in (
            lambda: train_hybrid_production(gcm, layout, src, ESNHyper(), 0),
            lambda: train_hybrid(gcm, layout, {}, None, ESNHyper(), 0),
            lambda: train_class(layout, layout.classes[0], {}, None,
                                ESNHyper(), 0, 8),
            lambda: streaming_standardizer(layout, layout.classes[0], src,
                                           8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    from speedy_ml_tpu_torch.data.checkpoint import load_hybrid
    from speedy_ml_tpu_torch.data.reference_import import (
        assemble_reference_class, import_reference_weights)
    from speedy_ml_tpu_torch.physics.boundaries import load_boundary_data
    for call in (
            lambda: load_hybrid(gcm, layout, str(tmp_path / "none")),
            lambda: import_reference_weights(gcm, layout, 8, None),
            lambda: assemble_reference_class(layout, layout.classes[0], [],
                                             8),
            lambda: load_boundary_data(g, path=str(tmp_path / "none"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    from speedy_ml_tpu_torch.core.geometry import Geometry
    from speedy_ml_tpu_torch.dycore.init import rest_state
    from speedy_ml_tpu_torch.dycore.model import DycoreModel
    from speedy_ml_tpu_torch.kernels.core_scatter import CoreScatter
    from speedy_ml_tpu_torch.kernels.esn_step import esn_step
    from speedy_ml_tpu_torch.kernels.gram_update import gram_update
    from speedy_ml_tpu_torch.kernels.grid_dynamics import grid_dynamics
    from speedy_ml_tpu_torch.kernels.readout import readout
    from speedy_ml_tpu_torch.kernels.sht_analysis import sht_analysis
    from speedy_ml_tpu_torch.kernels.sht_synthesis import sht_synthesis
    from speedy_ml_tpu_torch.kernels.spectral_tail import spectral_tail
    from speedy_ml_tpu_torch.kernels.window_gather import window_gather

    wrappers = (esn_step, readout, window_gather, sht_analysis,
                sht_synthesis, grid_dynamics, spectral_tail, gram_update)
    before = [w.launches for w in wrappers]
    g = torch.Generator().manual_seed(0)
    vals = torch.rand((3, 2, 16), generator=g)
    x = torch.rand((2, 16), generator=g)
    y = esn_step(vals, x, torch.rand((2, 4), generator=g),
                 torch.rand((2, 16), generator=g), shifts=(1, 5, 9))
    readout(torch.rand((2, 3, 16), generator=g), y)
    fields = (torch.rand((4, 1, 2, 2), generator=g),
              *[torch.rand((2, 2), generator=g) for _ in range(4)])
    idx = torch.arange(32, dtype=torch.int32).reshape(2, 16)
    ones = torch.ones((2, 16))
    window_gather(fields, [idx], [ones * 0], [ones])
    # the readout's store into the grid (the core scatter)
    grid = torch.full((36,), float("nan"))
    assert readout(torch.rand((2, 18, 16), generator=g), y,
                   scatter=CoreScatter(
                       grid, torch.arange(36, dtype=torch.int32).view(2, 18),
                       (18, 24), (30, 36))) is None
    assert not grid.isnan().any()
    gram_update(torch.zeros((2, 19, 19)), torch.zeros((2, 3, 19)),
                torch.rand((4, 2, 16), generator=g),
                torch.rand((4, 2, 3), generator=g),
                torch.rand((4, 2, 3), generator=g))
    # K5-K8: one dry step of a T10 dycore runs all four plain versions
    dyn = DycoreModel(Geometry(trunc=10, nlon=32, nlat=16, nlev=8),
                      dtype=torch.float64, device="cpu")
    state, phis = rest_state(dyn)
    new, _ = dyn.leapfrog_step(state, phis)
    assert torch.isfinite(new.t).all()
    assert [w.launches for w in wrappers] == before


def test_wrappers_refuse_other_devices():
    """A tensor on a device with no kernel raises (no silent plain path)."""
    from speedy_ml_tpu_torch.kernels.esn_step import esn_step
    from speedy_ml_tpu_torch.kernels.gram_update import gram_update
    from speedy_ml_tpu_torch.kernels.grid_dynamics import grid_dynamics
    from speedy_ml_tpu_torch.kernels.readout import readout
    from speedy_ml_tpu_torch.kernels.sht_analysis import sht_analysis
    from speedy_ml_tpu_torch.kernels.sht_synthesis import sht_synthesis
    from speedy_ml_tpu_torch.kernels.spectral_tail import spectral_tail

    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        gram_update(meta(2, 19, 19), meta(2, 3, 19), meta(4, 2, 16), None,
                    meta(4, 2, 3))
    x = meta(2, 16)
    with pytest.raises(ValueError, match="no kernel"):
        esn_step(meta(3, 2, 16), x, linear=True, shifts=(1, 2, 3))
    with pytest.raises(ValueError, match="no kernel"):
        readout(meta(2, 3, 16), x)
    with pytest.raises(ValueError, match="no kernel"):
        sht_analysis(meta(2, 16, 32), *(None,) * 5)
    with pytest.raises(ValueError, match="no kernel"):
        sht_synthesis(meta(2, 11, 12), *(None,) * 5)
    with pytest.raises(ValueError, match="no kernel"):
        grid_dynamics(meta(50, 16, 32), None, None, 8, 1)
    with pytest.raises(ValueError, match="no kernel"):
        spectral_tail(None, meta(73, 11, 12), *(None,) * 4, 2, 1.0, 0.0, 0,
                      True)

"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` is compiled for Hopper (`sm_90a`) by its own nvcc
process, all started together, with NVCC_FLAGS and that source's
SOURCE_FLAGS, then linked into one shared library with a plain C
interface.  The build runs at the first launch of any kernel
(or an explicit `build()`), under `kernels/_build/<hash of the sources
and flags>/`, so an edited source rebuilds and an unchanged one is
reused.  The directory is in .gitignore.

Pointers and the stream cross into C as `ctypes.c_void_p`; every C entry
point returns `cudaGetLastError()` after its launch and `check()` raises
on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libspeedy_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of single sources, after NVCC_FLAGS.  The column physics rounds
# every operation apart (no FMA contraction): its convection decides by
# comparing sums, as the plain version does; so does the window's entry
# (K17), which reuses its humidity, K3, whose date form works out K17b's
# insolation (surface_forcing.cuh sf_fsol) with the same bits, K21,
# which reuses K17's climatology, and K22, whose unstandardize is the
# plain version's multiply, then add; so do K24-K26 (the optional
# physics), which also write every operation with the _rn intrinsics.
SOURCE_FLAGS = {name: ["-fmad=false"] for name in (
    "column_moist.cu", "column_longwave.cu", "column_pbl.cu",
    "surface_forcing.cu", "window_gather.cu", "slab_couple.cu",
    "slab_ocean.cu", "sppt.cu", "rdf.cu", "cgrate.cu")}

_vp = ctypes.c_void_p
_i = ctypes.c_int
_ll = ctypes.c_longlong
_f = ctypes.c_float
_d = ctypes.c_double
_dp = ctypes.POINTER(ctypes.c_double)
# argtypes of every C entry point (csrc/*.cu)
SIGNATURES = {
    "esn_step_launch": [_i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp,
                        ctypes.POINTER(_i), _i, _i, _i, _i, _f, _f, _vp,
                        _vp],
    "readout_launch": [_i, _i, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp,
                       _vp, _vp, _ll, _ll, _ll, _ll, _vp],
    "window_gather_launch": [_i, ctypes.POINTER(_vp), _ll, _ll, _i,
                             ctypes.POINTER(_vp), ctypes.POINTER(_vp),
                             ctypes.POINTER(_vp), ctypes.POINTER(_vp),
                             ctypes.POINTER(_ll), _vp, _vp, _dp, _i, _vp,
                             _vp, _vp],
    "sht_analysis_launch": [_i, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                            _i, _vp, _vp],
    "sht_synthesis_launch": [_i, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i,
                             _vp, _vp],
    "inject_synthesis_launch": [_i, _i, _vp, _vp, _vp, _vp, _vp, _i, _i, _i,
                                _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp],
    "grid_dynamics_launch": [_i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _f, _f,
                             _i, _i, _vp, _vp],
    "spectral_tail_launch": [_i, _i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp,
                             _vp, _vp, _vp, _vp, _i, _i, _i, _i, _f, _f, _f,
                             _f, _f, _vp, _vp, _vp, _vp, _vp, _i, _i, _vp],
    "column_moist_launch": [_i, _i, _i, _vp, _vp, _vp, _vp, _vp, _i, _vp,
                            _vp, _i, ctypes.POINTER(_vp), _i, _vp, _vp, _vp],
    "down_surface_launch": [_i, _i, _i, ctypes.POINTER(_vp), _i, _vp, _vp,
                            _i, _i, _vp, _vp],
    "radlw_up_launch": [_i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                        _vp, _vp, _vp, _i, _vp, _vp],
    "column_pbl_launch": [_i, _i, _i, _i, ctypes.POINTER(_vp), _i, _vp, _i,
                          _vp, _d, _d, _vp],
    "gram_update_launch": [_i, _i, _vp, _vp, _vp, _i, _i, _i, _i, _i, _vp,
                           _vp, _vp, _i, _vp],
    "gram_panel_size": [_i, _i, _i, _i, _i, _i, _i],
    "spectral_stack_launch": [_i, _i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp,
                              _vp, _i, _i, _vp, _vp, _i, _vp],
    "surface_forcing_launch": [_i, _i, _i, _i, ctypes.POINTER(_vp), _vp, _vp,
                               _dp, ctypes.POINTER(_i), _vp, _vp],
    "tisr_launch": [_i, _i, _i, _i, _vp, _vp, _vp, _dp, _vp],
    "gate_check_launch": [_i, _i, _i, _ll, _vp, _dp, _vp, _vp, _vp],
    "window_select_launch": [_i, _i, _i, _ll, _vp, _vp, _vp, _vp, _vp, _vp,
                             _vp, _vp, _vp],
    "slab_couple_launch": [_i, _i, _ll, ctypes.POINTER(_vp), _vp, _vp, _dp,
                           ctypes.POINTER(_i), _d, ctypes.POINTER(_i), _vp,
                           _vp],
    "slab_ocean_push_launch": [_i, _i, _i, ctypes.POINTER(_vp),
                               ctypes.POINTER(_vp), ctypes.POINTER(_vp),
                               ctypes.POINTER(_vp), ctypes.POINTER(_ll),
                               ctypes.POINTER(_i), ctypes.POINTER(_i), _i, _i,
                               _d, _vp, _vp],
    "slab_ocean_sst_launch": [_i, _i, _i, ctypes.POINTER(_vp),
                              ctypes.POINTER(_vp), ctypes.POINTER(_vp),
                              ctypes.POINTER(_ll), ctypes.POINTER(_i), _vp,
                              _vp, _vp, _ll, _d, _vp, _vp],
    "sst_by_date_launch": [_i, _i, _vp, _ll, _ll, _ll, _d, _vp, _vp, _vp],
    "readout_components_launch": [_i, _i, _vp, _vp, _vp, _vp, _vp, _i, _i,
                                  _i, _i, _vp, _vp, _vp, _vp, _vp, _ll, _ll,
                                  _ll, _ll, _vp],
    "sppt_ar1_launch": [_i, _i, _i, _ll, _vp, _vp, _vp, _d, _d, _vp, _vp],
    "sppt_perturb_launch": [_i, _i, _i, _ll, _vp, _vp, ctypes.POINTER(_vp),
                            _vp],
    "rdf_launch": [_i, _i, _i, _i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                   _vp, _vp, _vp, _vp],
    "cgrate_launch": [_i, _i, _i, _i, _i, ctypes.POINTER(_vp),
                      ctypes.POINTER(_vp), _vp, _vp, ctypes.POINTER(_vp), _i,
                      _d, _d, _d, _d, _vp],
    "rdf_band_launch": [_i, _i, _i, _i, _i, _i, _i, _i, _vp, _vp, _vp, _vp,
                        _vp, _vp],
    "rdf_sums_launch": [_i, _i, _i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                        _vp],
    "cgrate_rows_launch": [_i, _i, _i, _i, _i, _i, ctypes.POINTER(_vp),
                           ctypes.POINTER(_vp), _vp, _vp, _vp],
    "cgrate_range_launch": [_i, _i, _i, _i, _i, _i, _i, ctypes.POINTER(_vp),
                            ctypes.POINTER(_vp), _vp, _vp,
                            ctypes.POINTER(_vp), _i, _d, _d, _d, _d, _vp],
    # empty kernels of K25's and K26's launch shapes (chip_smoke.py's floor)
    "cgrate_floor_launch": [_i, _i, _i, _i, _i, _vp],
    "rdf_floor_launch": [_i, _i, _i, _i, _i, _i, _vp],
}
# restype of the entry points that return something else than an int
RESTYPES = {"gram_panel_size": _ll}

_lib = None  # the loaded library, once per process


def nvcc_path() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile csrc/ into the shared library (if not built yet); return
    its path.  verbose prints each kernel's ptxas report (registers,
    shared memory, spills)."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, []), "-c",
                   str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, p in procs:
            log, _ = p.communicate()
            if verbose and log:
                print(f"--- nvcc {src.name}\n{log}", flush=True)
            if p.returncode != 0:
                failed.append(f"{src.name} (exit {p.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp / LIB_NAME), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        try:
            os.replace(tmp, out_dir)
        except OSError:
            # another process finished the same build first
            if not lib.exists():
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _lib = lib
    return _lib


def check(code: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


def require(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    """Validate a kernel operand: dtype, shape, contiguity, device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def pointer_array(tensors) -> ctypes.Array:
    """The tensors' data pointers as a C array of void* (the operand
    lists of K10a_down_surface, K12 and K9_moist_shortwave)."""
    ptrs = [t.data_ptr() for t in tensors]
    return (_vp * len(ptrs))(*ptrs)


def level_dims(t, name: str) -> tuple[int, int, int]:
    """(K, nlat, nlon) of a column kernel's leading level field, which
    sets the dtype (float32 or float64) of its other operands."""
    if not isinstance(t, torch.Tensor) or t.dim() != 3:
        raise ValueError(f"{name}: expected a (K, lat, lon) tensor")
    if t.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes float32 "
                        "or float64")
    return tuple(t.shape)


def column_route(name: str, device: torch.device, K: int, levels) -> str:
    """Where a column-physics call goes: "cpu" (the plain version) or
    "cuda" (the kernel, compiled for K in `levels`); raises otherwise."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")
    if device.type == "cuda" and K not in levels:
        raise ValueError(f"{name}: the kernel takes K in {levels}, not K={K}")
    return device.type

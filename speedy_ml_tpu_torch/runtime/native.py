"""ctypes bindings for the native IO runtime (csrc/speedy_io.cpp).

The library is built with g++ at its first use, under
`runtime/_build/<hash of the source and flags>/` (in .gitignore), so an
edited source rebuilds and an unchanged one is reused.  A failed build
or load raises: the entry points never fall back quietly.  Their numpy
versions (`*_plain`) are the reference the tests hold the library to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "speedy_io.cpp"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread", "-std=c++17"]
_lib = None


def _so_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "speedy_io.so"


def build() -> Path:
    """Compile speedy_io.cpp unless this source's build is there; the
    library is written to a temporary name and renamed into place, so
    processes building at once never load a half-written file."""
    so = _so_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n"
                               f"{out.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


_i64, _int, _vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
# argtypes of the C entry points this module calls (csrc/speedy_io.cpp)
SIGNATURES = {
    "read_boundary_field": [ctypes.c_char_p, _i64, _i64, _i64, _vp],
    "gather_series": [_vp, _i64, _i64, _i64, _vp, _vp, _i64, _i64, _i64,
                      _vp, _int],
}


def get_lib():
    """The loaded library, built at the first call; raises on failure."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def read_boundary_field(path: str, group: int, nlon: int, nlat: int
                        ) -> np.ndarray:
    """One boundary-record group of a fort.2x file (nlat records of nlon
    little-endian float32, north to south) as float64, south to north,
    values <= -999 set to 0; raises if the file cannot be read."""
    out = np.empty((nlat, nlon), dtype=np.float64)
    rc = get_lib().read_boundary_field(str(path).encode(), group, nlon, nlat,
                                       out.ctypes.data)
    if rc != 0:
        raise OSError(f"read_boundary_field({path}, group {group}) "
                      f"returned {rc}")
    return out


def read_boundary_field_plain(path: str, group: int, nlon: int, nlat: int
                              ) -> np.ndarray:
    """read_boundary_field in numpy."""
    count = nlat * nlon
    with open(path, "rb") as f:
        f.seek(group * count * 4)
        raw = np.fromfile(f, dtype="<f4", count=count)
    field = raw.reshape(nlat, nlon)[::-1].astype(np.float64)
    field[field <= -999] = 0.0
    return field


def gather_series(fields: np.ndarray, iy: np.ndarray, ix: np.ndarray,
                  n_threads: int = 0) -> np.ndarray:
    """Packed patch series (T, R, ny*nx) from (T, nlat, nlon) float32 fields.

    The gather fan-out runs on a thread pool (the data side of the
    reference's per-region parallel NetCDF reads).  Indices outside the
    grid raise (the library reads them unchecked)."""
    T, nlat, nlon = fields.shape
    R, ny = iy.shape
    nx = ix.shape[1]
    fields32 = np.ascontiguousarray(fields, dtype=np.float32)
    iy32 = np.ascontiguousarray(iy, dtype=np.int32)
    ix32 = np.ascontiguousarray(ix, dtype=np.int32)
    for name, idx, n in (("iy", iy32, nlat), ("ix", ix32, nlon)):
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"{name} outside [0, {n})")
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    out = np.empty((T, R, ny * nx), dtype=np.float32)
    rc = get_lib().gather_series(fields32.ctypes.data, T, nlat, nlon,
                                 iy32.ctypes.data, ix32.ctypes.data, R, ny,
                                 nx, out.ctypes.data, n_threads)
    if rc != 0:
        raise RuntimeError(f"gather_series returned {rc}")
    return out


def gather_series_plain(fields: np.ndarray, iy: np.ndarray, ix: np.ndarray
                        ) -> np.ndarray:
    """gather_series by numpy's advanced indexing."""
    fields32 = np.ascontiguousarray(fields, dtype=np.float32)
    iy32 = np.asarray(iy, dtype=np.int32)
    ix32 = np.asarray(ix, dtype=np.int32)
    return fields32[:, iy32[:, :, None], ix32[:, None, :]].reshape(
        fields32.shape[0], iy32.shape[0], -1)

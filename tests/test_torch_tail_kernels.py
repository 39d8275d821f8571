"""The arithmetic of K8 (kernels/spectral_tail.py) without a card.

kernels/csrc/tail_host.cpp compiles the header the CUDA kernel includes
(spectral_tail.cuh) for the host with g++, each group of 8 lanes (one
spectral coefficient, lane k on level k) written out as loops and the
exchanges inside a group as copies, beside a naive loop in the first
design's order (one coefficient at a time, every level in arrays, the
per-(m, n) inverse xj_g).  At K = 5, 7 and 8, T30 and T10, on inputs made
from a seed with numpy:
  - the lane groups equal the naive loop bit for bit, in float32 and
    float64, for j1 = 1 and 2, with and without the semi-implicit
    correction, with and without the orographic corrections;
  - the float64 build is within 1e-12 of each field level's scale of
    DycoreModel.spectral_tail_plain (the plain version the dycore step
    runs on the CPU, which tests/test_torch_dycore.py holds against the
    JAX package's DycoreModel.step);
  - the inverse a lane reads by total wavenumber l = m + n is xj_g[m, n],
    zero at l = 0, and tail_blob has the layout the header reads;
  - an exchange one lane short, and mixes summed from the last level
    down, both fail the bit-for-bit comparison (negative controls).
The launch code itself runs only on a card (chip_smoke.py).
"""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.dycore.model import DycoreModel
from speedy_ml_tpu_torch.dycore.state import SpectralState
from speedy_ml_tpu_torch.kernels.spectral_tail import (XJ_ROW, blob_size,
                                                       tail_blob)
from torch_lane import one_thread_per_pool  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
GEOMS = {"T30": dict(trunc=30, nlon=96, nlat=48),
         "T10": dict(trunc=10, nlon=32, nlat=16)}
FIELDS = SpectralState.FIELDS
RTOL_F64 = 1e-12


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/tail_host.cpp built with g++ and loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's arithmetic for the host")
    so = tmp_path_factory.mktemp("tail_host") / "libtail_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    str(CSRC / "tail_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    call = [i, i, i, i] + [vp] * 10 + [i] * 4 + [d] * 5 + [vp] * 5
    lib.spectral_tail_host.argtypes = call + [i]
    lib.spectral_tail_naive.argtypes = call + [vp, i]
    lib.tail_xj_lookup_host.argtypes = [i, i, vp, i, i, vp]
    lib.tail_blob_size_host.argtypes = [i, i, i]
    lib.tail_blob_size_host.restype = ctypes.c_longlong
    for fn in (lib.spectral_tail_host, lib.spectral_tail_naive,
               lib.tail_xj_lookup_host):
        fn.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def dycore(geom: str, K: int, dtype) -> DycoreModel:
    return DycoreModel(Geometry(nlev=K, **GEOMS[geom]), dtype=dtype,
                       device="cpu")


def case(geom, K, j1, dtype, seed):
    """(dyn, imp, dt, eps, A, state, phis, corrections) of one step: the
    imp, dt and eps of stepone's second step (j1 = 1) or of the filtered
    leapfrog (j1 = 2); A, the state and the fields of the corrections
    random, made with numpy from the seed."""
    dyn = dycore(geom, K, dtype)
    g = dyn.geom
    rng = np.random.default_rng(seed)
    cd = torch.complex128 if dtype == torch.float64 else torch.complex64
    cplx = lambda *shape: torch.as_tensor(
        rng.normal(size=shape) + 1j * rng.normal(size=shape)).to(cd)
    mx, nx = g.mx, g.nx
    A = cplx(1 + 9 * K, mx, nx)
    state = SpectralState(vor=cplx(2, K, mx, nx), div=cplx(2, K, mx, nx),
                          t=cplx(2, K, mx, nx), ps=cplx(2, mx, nx),
                          tr=cplx(2, 1, K, mx, nx))
    phis, tcorh, qcorh = cplx(mx, nx), cplx(mx, nx), cplx(mx, nx)
    if j1 == 1:
        imp, dt, eps = dyn.imp_full, dyn.delt, 0.0
    else:
        imp, dt, eps = dyn.imp_double, dyn.delt2, dyn.rob
    return dyn, imp, dt, eps, A, state, phis, (tcorh, qcorh)


def _ptr(t):
    if t is None:
        return None
    assert t.is_contiguous() and t.device.type == "cpu"
    return t.data_ptr()


def run_host(lib, dyn, imp, dt, eps, A, state, phis, corrections, j1, j4,
             implicit, naive=False, lanes=None, reverse=False):
    """K8's arithmetic built for the host: the lane groups (lanes: how many
    levels an exchange reads) or the naive first design (reverse: its
    mixes summed from the last level down).  Returns the new state; every
    output starts as NaN."""
    g = dyn.geom
    K, mx, nx = g.nlev, g.mx, g.nx
    real = A.real.dtype
    blob = tail_blob(dyn, imp, real)
    out = {k: torch.full_like(getattr(state, k), complex("nan+nanj"))
           for k in FIELDS}
    tcorh, qcorh = corrections if corrections is not None else (None, None)
    args = [K, int(real == torch.float64), mx, nx, _ptr(A),
            *(_ptr(getattr(state, k)) for k in ("vor", "div", "t", "ps",
                                                 "tr")),
            _ptr(phis), _ptr(tcorh), _ptr(qcorh), _ptr(blob), j1, j4,
            int(implicit), int(g.nlon == 4 * g.nlat_half), float(dt),
            float(dyn.wil * eps), float((1.0 - dyn.wil) * eps),
            float(dyn.sdrag), float(dyn.const.rgas),
            *(_ptr(out[k]) for k in ("vor", "div", "t", "ps", "tr"))]
    if naive:
        xj_g = imp.xj_g.to(real).contiguous()
        rc = lib.spectral_tail_naive(*args, _ptr(xj_g), int(reverse))
    else:
        rc = lib.spectral_tail_host(*args, K if lanes is None else lanes)
    assert rc == 0
    return SpectralState(**out)


def same_bits(a: SpectralState, b: SpectralState) -> bool:
    return all(np.array_equal(getattr(a, k).numpy(), getattr(b, k).numpy())
               for k in FIELDS)


@pytest.mark.parametrize("corr", [True, False], ids=["corr", "nocorr"])
@pytest.mark.parametrize("implicit", [True, False], ids=["imp", "expl"])
@pytest.mark.parametrize("j1", [1, 2])
@pytest.mark.parametrize("K", [5, 7, 8])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_lane_groups_match_first_design(host_lib, geom, K, j1, implicit,
                                        corr):
    """Bit for bit, float32 and float64; every output written."""
    j4 = 0 if implicit else 1
    for dtype in (torch.float32, torch.float64):
        dyn, imp, dt, eps, A, st, phis, co = case(geom, K, j1, dtype,
                                                  seed=100 * K + 10 * j1)
        co = co if corr else None
        got = run_host(host_lib, dyn, imp, dt, eps, A, st, phis, co, j1, j4,
                       implicit)
        ref = run_host(host_lib, dyn, imp, dt, eps, A, st, phis, co, j1, j4,
                       implicit, naive=True)
        for k in FIELDS:
            assert not getattr(got, k).isnan().any(), (dtype, k)
        assert same_bits(got, ref), dtype


@pytest.mark.parametrize("implicit", [True, False], ids=["imp", "expl"])
@pytest.mark.parametrize("j1", [1, 2])
@pytest.mark.parametrize("K", [5, 7, 8])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_double_build_matches_plain(host_lib, geom, K, j1, implicit):
    """The float64 lane groups against the plain version at 1e-12 of each
    field level's scale."""
    dyn, imp, dt, eps, A, st, phis, co = case(geom, K, j1, torch.float64,
                                              seed=7 * K + j1)
    j4 = 0 if implicit else 1
    got = run_host(host_lib, dyn, imp, dt, eps, A, st, phis, co, j1, j4,
                   implicit)
    ref = dyn.spectral_tail_plain(A, st, phis, co, imp, j1, dt, eps, j4,
                                  implicit)
    for k in FIELDS:
        a, b = getattr(got, k), getattr(ref, k)
        g = a.reshape(-1, a.shape[-2] * a.shape[-1])
        r = b.reshape(g.shape)
        scale = r.abs().amax(dim=1)
        assert (scale > 0).all(), k
        err = ((g - r).abs().amax(dim=1) / scale).max().item()
        assert err <= RTOL_F64, (k, err)


@pytest.mark.parametrize("K", [5, 7, 8])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_xj_by_wavenumber(host_lib, geom, K):
    """The blob's per-l inverse, looked up as a lane reads it at every
    (m, n), is xj_g[m, n] (zero at l = 0); the blob has the header's size
    and layout."""
    for dtype in (torch.float32, torch.float64):
        dyn = dycore(geom, K, dtype)
        g = dyn.geom
        mx, nx = g.mx, g.nx
        for imp in (dyn.imp_half, dyn.imp_full, dyn.imp_double):
            blob = tail_blob(dyn, imp, dtype)
            assert blob.dtype == dtype and blob.is_contiguous()
            assert blob.numel() == blob_size(K, mx, nx) \
                == host_lib.tail_blob_size_host(K, mx, nx)
            if dtype == torch.float32:
                assert torch.equal(imp.blob, blob)
            off = blob.numel() - g.lmax * K * XJ_ROW
            assert off % 4 == 0
            xj = blob[off:].reshape(g.lmax, K, XJ_ROW)
            assert torch.equal(xj[..., :K], imp.xj)
            assert not xj[..., K:].any()
            out = torch.full((mx, nx, K, K), float("nan"), dtype=dtype)
            assert host_lib.tail_xj_lookup_host(
                K, int(dtype == torch.float64), _ptr(blob), mx, nx,
                _ptr(out)) == 0
            assert torch.equal(out, imp.xj_g)
            assert not out[0, 0].any() and out[0, 1].abs().sum() > 0


@pytest.mark.parametrize("fault", ["one lane short", "mix reversed"])
def test_faults_fail_the_comparison(host_lib, fault):
    """Negative controls: the lane groups with an exchange that reads one
    level too few, and the naive loop with its xd, xj and xc mixes summed
    from the last level down, each differ from the right result."""
    K, j1 = 8, 2
    dyn, imp, dt, eps, A, st, phis, co = case("T30", K, j1, torch.float32,
                                              seed=5)
    run = functools.partial(run_host, host_lib, dyn, imp, dt, eps, A, st,
                            phis, co, j1, 0, True)
    ref = run()
    assert same_bits(ref, run(naive=True))
    bad = run(lanes=K - 1) if fault == "one lane short" \
        else run(naive=True, reverse=True)
    assert not same_bits(bad, ref)

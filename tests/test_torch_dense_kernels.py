"""The arithmetic of K2 (kernels/readout.py) and K14 (kernels/gram_update.py)
without a card.

kernels/csrc/dense_host.cpp compiles the headers the CUDA kernels include
(readout.cuh, gram_update.cuh) for the host with g++, with the warp and the
thread blocks written out as loops, and the cases below hold it against
the plain PyTorch versions on inputs made from a seed with numpy:
  K2  the row split (16-byte body, the 4-element head of a row that starts
      8 bytes past a 16-byte boundary, the tail), the rounding of aug to
      bf16 and the unstandardize epilogue, at the widths of the T30 m=6000
      classes (A = 5,760 and 6,048 ML-only, 0 mod 8; 5,892 and 6,180
      coupled, 4 mod 8) with Wout starting 0 or 8 bytes past a 16-byte
      boundary: on inputs whose f32 sums are exact in any order, equal to
      readout_plain bit for bit (and unequal without the rounding of aug);
      on random inputs within chip_smoke's K2_RTOL; and K2's store into
      the assembled grid (the core scatter, with the q and precip clamps)
      on the T10 layout's interior and polar classes, each class with the
      card's rows per block, whole regions and T30's polar tile, coupled
      and ML-only: bit for bit the vectors then core_scatter_plain, and
      readout_plain then core_scatter_plain within K2_RTOL;
  K14 both tile lists (all of ss's tiles, or its upper triangle mirrored;
      then st's) cover every output exactly once at A = 37, 5,892, 6,180,
      O = 5, 136 and tiles of 128 and 64 outputs a side; the
      host-run update (the zero-padded panel, then the tiles) equals
      gram_update_plain bit for bit on integer operands (exact sums) and
      within 1e-12 on random ones in float64, and a symmetric ss stays
      exactly symmetric.
The launch code itself runs only on a card (chip_smoke.py).
"""

import ctypes
import functools
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.esn.domain import RegionLayout
from speedy_ml_tpu_torch.kernels.core_scatter import (core_scatter_plain,
                                                      grid_blocks,
                                                      split_grid)
from speedy_ml_tpu_torch.kernels.gram_update import gram_update_plain
from speedy_ml_tpu_torch.kernels.readout import (quad_expand, readout_plain,
                                                 vector_path)

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "speedy_ml_tpu_torch" / "kernels" / "csrc"
sys.path.insert(0, str(REPO))
from chip_smoke import K2_RTOL  # noqa: E402  (the card check's tolerance)
from torch_lane import one_thread_per_pool  # noqa: E402, F401

# (S, n) of the T30 m=6000 classes, ML-only and coupled
WIDTHS = {"interior ML-only": (0, 5760), "polar ML-only": (0, 6048),
          "interior coupled": (132, 5760), "polar coupled": (132, 6048)}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/dense_host.cpp built with g++ and loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels' arithmetic for the host")
    so = tmp_path_factory.mktemp("dense_host") / "libdense_host.so"
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    str(CSRC / "dense_host.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.readout_host.argtypes = [i] + [vp] * 5 + [i] * 5 + [vp] * 3 + [ll] * 4
    lib.readout_tile_rows_host.argtypes = [i] * 3
    lib.gram_update_host.argtypes = [i, i, i] + [vp] * 3 + [i] * 5 + [vp] * 2
    lib.gram_coverage_host.argtypes = [i, i, i, i, vp, vp]
    for fn in (lib.readout_host, lib.readout_tile_rows_host,
               lib.gram_update_host, lib.gram_coverage_host):
        fn.restype = i
    return lib


def _ptr(t):
    if t is None:
        return None
    assert t.is_contiguous() and t.device.type == "cpu"
    return t.data_ptr()


# ------------------------------------------------------------------- K2

def wout_at(values: torch.Tensor, offset_bytes: int) -> torch.Tensor:
    """`values` copied into a buffer at `offset_bytes` past a 16-byte
    boundary (CPU allocations are 64-byte aligned)."""
    es = values.element_size()
    buf = torch.zeros(values.numel() + 16 // es, dtype=values.dtype)
    assert buf.data_ptr() % 16 == 0
    k = offset_bytes // es
    w = buf[k:k + values.numel()].view(values.shape)
    w.copy_(values)
    assert w.data_ptr() % 16 == offset_bytes
    return w


def host_readout(lib, wout, x, lm=None, mean=None, std=None, tile=None,
                 grid=None, index=None, q=(0, 0), p=(0, 0)):
    """K2's host build: (the (R, O) outputs, or None where they went into
    `grid` through `index`, the path taken); tile: rows a block (all
    O by default)."""
    R, O, A = wout.shape
    out = None if grid is not None else torch.empty((R, O),
                                                    dtype=torch.float32)
    path = lib.readout_host(int(wout.dtype == torch.bfloat16), _ptr(wout),
                            _ptr(x), _ptr(lm), _ptr(mean), _ptr(std), R, O,
                            A - x.shape[1], x.shape[1], tile or O, _ptr(out),
                            _ptr(grid), _ptr(index), *q, *p)
    assert path == int(vector_path(wout)), "vector_path disagrees with C"
    return out, path


def exact_readout_inputs(seed, R, O, S, n, dtype=torch.bfloat16):
    """Operands whose f32 products and sums are exact in any order: Wout
    in {-1, 0, 1}; aug after its bf16 rounding multiples of 2^-10 below 2
    in magnitude, so |sum| < 2^14 (24 bits).  lm = k/256 (9 bits) and the
    squares (k/32)^2 (up to 11 bits) do get rounded to bf16."""
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.integers(-1, 2, (R, O, S + n)).astype(np.float32))
    x = torch.as_tensor(rng.integers(-40, 41, (R, n)).astype(np.float32) / 32)
    lm = (torch.as_tensor(rng.integers(-511, 512, (R, S)).astype(np.float32)
                          / 256) if S else None)
    mean = torch.as_tensor(rng.uniform(200, 300, (R, O)).astype(np.float32))
    std = torch.as_tensor(rng.uniform(0.5, 20, (R, O)).astype(np.float32))
    return w.to(dtype), x, lm, mean, std


@pytest.mark.parametrize("offset", [0, 8])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_readout_row_split_exact(host_lib, width, offset):
    """K2's row dot (head, 16-byte body, tail, bf16 rounding of aug) and
    epilogue equal readout_plain bit for bit on exact operands, at the
    T30 widths, for Wout 0 and 8 bytes past a 16-byte boundary."""
    S, n = WIDTHS[width]
    A = S + n
    w0, x, lm, mean, std = exact_readout_inputs(A + offset, 2, 5, S, n)
    w = wout_at(w0, offset)
    got, path = host_readout(host_lib, w, x, lm)
    assert path == 1, "the T30 widths take the vector path"
    # with A = 4 mod 8, the rows alternate between the two alignments
    starts = {(w.data_ptr() + 2 * A * k) % 16 for k in range(4)}
    assert starts == ({offset} if A % 8 == 0 else {0, 8})
    ref = readout_plain(w, x, lm)
    assert torch.equal(got, ref)
    # the rounding of aug matters on these inputs: without it the sum is
    # another exact number
    aug = quad_expand(x) if lm is None else torch.cat([lm, quad_expand(x)],
                                                      dim=-1)
    unrounded = torch.einsum("roa,ra->ro", w.float(), aug)
    assert not torch.equal(got, unrounded)
    got_epi, _ = host_readout(host_lib, w, x, lm, mean, std)
    assert torch.equal(got_epi, readout_plain(w, x, lm, mean, std))


@pytest.mark.parametrize("case", ["bf16 scalar", "f32 vector",
                                  "f32 scalar"])
def test_readout_other_paths_exact(host_lib, case):
    """The scalar path (A % 4 != 0, or f32 Wout 8 bytes off) and the f32
    vector path, on exact operands."""
    S, n, dtype, offset = {"bf16 scalar": (3, 38, torch.bfloat16, 0),
                           "f32 vector": (132, 5760, torch.float32, 0),
                           "f32 scalar": (4, 40, torch.float32, 8)}[case]
    w0, x, lm, mean, std = exact_readout_inputs(7, 3, 6, S, n, dtype)
    w = wout_at(w0, offset)
    got, path = host_readout(host_lib, w, x, lm, mean, std)
    assert path == int(case.endswith("vector"))
    assert torch.equal(got, readout_plain(w, x, lm, mean, std))


@pytest.mark.parametrize("width", ["interior coupled", "polar coupled"])
def test_readout_random_within_card_tolerance(host_lib, width):
    """Random operands of the main path's kind: the bare product within
    K2_RTOL of its scale (sums in another order than the plain version)."""
    S, n = WIDTHS[width]
    rng = np.random.default_rng(11)
    w = torch.as_tensor(rng.normal(0, 0.02, (2, 7, S + n)).astype(
        np.float32)).to(torch.bfloat16)
    w = wout_at(w, 8)
    x = torch.as_tensor(np.tanh(rng.normal(0, 1, (2, n))).astype(np.float32))
    lm = torch.as_tensor(rng.normal(0, 1, (2, S)).astype(np.float32))
    got, _ = host_readout(host_lib, w, x, lm)
    ref = readout_plain(w, x, lm)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= K2_RTOL * scale


@functools.lru_cache(maxsize=None)
def t10_layout():
    """The T10 layout of 128 regions: classes of 16, 96 and 16 regions, a
    core of 2 x 2 points (O = 136, as at T30), and the tables of the core
    scatter."""
    lay = RegionLayout(Geometry(trunc=10, nlon=32, nlat=16, nlev=NZ_T10),
                       128)
    table = torch.as_tensor(lay.core_source_table(lay.classes, 4, NZ_T10))
    index = [torch.as_tensor(i) for i in
             lay.core_output_index(lay.classes, 4, NZ_T10)]
    return lay, table, index


NZ_T10 = 8


@pytest.mark.parametrize("inputs", ["exact", "random"])
@pytest.mark.parametrize("form", ["coupled", "ML-only"])
@pytest.mark.parametrize("tiles", ["card", "whole regions", "T30 polar"])
def test_readout_scatter_epilogue(host_lib, tiles, form, inputs):
    """K2's store into the grid: every class of the T10 layout read out
    by the host build (blocks of `tiles` rows, so that a polar region's
    rows span several blocks, each storing its own) straight into one
    grid starting as NaN, with the unstandardize epilogue: bit for bit
    the host build's (R, O) vectors then core_scatter_plain, every element
    written; against readout_plain then core_scatter_plain, bit for bit
    on exact operands and within K2_RTOL of the bare product's scale on
    random ones (where the clamps did bite)."""
    lay, table, index = t10_layout()
    g = lay.geom
    total, q, p = grid_blocks(4, NZ_T10, g.nlat, g.nlon)
    grid = torch.full((total,), float("nan"))
    vecs, plains, scale = [], [], 0.0
    rng = np.random.default_rng(23)
    for c, (cls, idx) in enumerate(zip(lay.classes, index)):
        R, O = idx.shape
        S = O - cls.core_shape[0] * cls.core_shape[1] if form == "coupled" \
            else 0
        if inputs == "exact":
            w, x, lm, mean, std = exact_readout_inputs(c, R, O, S, 40)
        else:
            w = torch.as_tensor(rng.normal(0, 0.02, (R, O, S + 40)).astype(
                np.float32)).to(torch.bfloat16)
            x = torch.as_tensor(np.tanh(rng.normal(0, 1, (R, 40))).astype(
                np.float32))
            lm = torch.as_tensor(rng.normal(0, 1, (R, S)).astype(
                np.float32)) if S else None
            mean, std = (torch.as_tensor(rng.uniform(*b, (R, O)).astype(
                np.float32)) for b in ((-1e-5, 1e-5), (0.5, 2.0)))
            scale = max(scale, float(readout_plain(w, x, lm).abs().max()))
        tile = {"card": host_lib.readout_tile_rows_host(132, R, O),
                "whole regions": O,
                "T30 polar": host_lib.readout_tile_rows_host(132, 48, O)}[
            tiles]
        assert tile % 8 == 0 or tile == O
        got, path = host_readout(host_lib, w, x, lm, mean, std, tile, grid,
                                 idx, q, p)
        assert got is None and path == 1
        vecs.append(host_readout(host_lib, w, x, lm, mean, std)[0])
        plains.append(readout_plain(w, x, lm, mean, std))
    assert not grid.isnan().any()
    fused = split_grid(grid, 4, NZ_T10, g.nlat, g.nlon)
    for a, b in zip(fused, core_scatter_plain(vecs, table, 4, NZ_T10,
                                              g.nlat, g.nlon)):
        assert torch.equal(a, b)
    ref = core_scatter_plain(plains, table, 4, NZ_T10, g.nlat, g.nlon)
    if inputs == "exact":
        for a, b in zip(fused, ref):
            assert torch.equal(a, b)
        return
    err = max(float((a - b).abs().max()) for a, b in zip(fused, ref))
    assert err <= K2_RTOL * scale
    # the clamps did bite: q at its floor, precip zeroed
    assert float(fused[0][3].min()) == float(torch.tensor(1e-6))
    assert 0 < int((fused[2] == 0).sum()) < fused[2].numel()


def test_vector_path_rule():
    """readout.vector_path: A a multiple of 4, Wout aligned to 4
    elements."""
    bf = torch.zeros((1, 2, 5892), dtype=torch.bfloat16)
    assert vector_path(bf)
    assert vector_path(wout_at(bf, 8))
    assert not vector_path(wout_at(bf, 2))
    assert not vector_path(torch.zeros((1, 2, 41), dtype=torch.bfloat16))
    f = torch.zeros((1, 2, 5892))
    assert vector_path(f) and not vector_path(wout_at(f, 8))


# ------------------------------------------------------------------ K14

@pytest.mark.parametrize("sym", [1, 0])
@pytest.mark.parametrize("tile", [128, 64])
@pytest.mark.parametrize("O", [5, 136])
@pytest.mark.parametrize("A", [37, 5892, 6180])
def test_gram_tiles_cover_every_output_once(host_lib, A, O, tile, sym):
    """ss's tiles (the upper triangle with its mirrors, or all) and st's
    write each output of a region exactly once (ragged edges
    included)."""
    cnt_ss = np.zeros((A, A), dtype=np.uint8)
    cnt_st = np.zeros((O, A), dtype=np.uint8)
    host_lib.gram_coverage_host(A, O, tile, sym, cnt_ss.ctypes.data,
                                cnt_st.ctypes.data)
    assert cnt_ss.min() == 1 and cnt_ss.max() == 1
    assert cnt_st.min() == 1 and cnt_st.max() == 1


def gram_operands(seed, C, R, n, S, O, dtype, integers):
    """(states, model, target, ss, st) with ss symmetric.  integers:
    small integers, so that every sum is exact in any order."""
    rng = np.random.default_rng(seed)
    A = S + n
    if integers:
        draw = lambda *s: rng.integers(-3, 4, s).astype(np.float64)
        states = draw(C, R, n)
    else:
        draw = lambda *s: rng.normal(0, 1, s)
        states = np.tanh(draw(C, R, n))
    model, target = draw(C, R, S), draw(C, R, O)
    half = draw(R, A, A)
    ss = half + half.transpose(0, 2, 1)
    st = draw(R, O, A)
    t = lambda a: torch.as_tensor(a, dtype=dtype).contiguous()
    return (t(states), t(model) if S else None, t(target), t(ss), t(st))


def host_gram(lib, tile, sym, ss, st, states, model, target):
    C, R, n = states.shape
    S = 0 if model is None else model.shape[2]
    lib.gram_update_host(int(ss.dtype == torch.float64), tile, sym,
                         _ptr(states),
                         _ptr(model), _ptr(target), C, R, n, S,
                         target.shape[2], _ptr(ss), _ptr(st))
    return ss, st


@pytest.mark.parametrize("sym", [1, 0])
@pytest.mark.parametrize("S", [0, 6])
@pytest.mark.parametrize("C", [1, 3, 17])
@pytest.mark.parametrize("tile,dtype", [(64, torch.float64),
                                        (64, torch.float32),
                                        (128, torch.float32)])
def test_gram_update_host_exact(host_lib, tile, dtype, C, S, sym):
    """The host-run tile update equals gram_update_plain bit for bit on
    integer operands (A = 150 + S: several ragged tiles of 64, two of
    128; O = 70: st's edge tiles too), with either tile list, and ss
    stays exactly symmetric."""
    ops = gram_operands(C + S, C, 2, 150, S, 70, dtype, integers=True)
    states, model, target, ss, st = ops
    ss_ref, st_ref = gram_update_plain(ss.clone(), st.clone(), states,
                                       model, target)
    host_gram(host_lib, tile, sym, ss, st, states, model, target)
    assert torch.equal(ss, ss_ref) and torch.equal(st, st_ref)
    assert torch.equal(ss, ss.transpose(1, 2))


@pytest.mark.parametrize("C", [1, 3, 17])
def test_gram_update_host_random_f64(host_lib, C):
    """Random operands in float64 at the float64 kernel's tile: within
    1e-12 of the plain version's scale (chip_smoke's K14_RTOL_F64), and
    a symmetric ss stays exactly symmetric."""
    states, model, target, ss, st = gram_operands(
        100 + C, C, 3, 140, 9, 5, torch.float64, integers=False)
    ss_ref, st_ref = gram_update_plain(ss.clone(), st.clone(), states,
                                       model, target)
    host_gram(host_lib, 64, 1, ss, st, states, model, target)
    for got, ref in ((ss, ss_ref), (st, st_ref)):
        assert float((got - ref).abs().max()) <= 1e-12 * float(
            ref.abs().max())
    assert torch.equal(ss, ss.transpose(1, 2))

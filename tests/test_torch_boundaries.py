"""Port parity of the fort.20-26 boundary reader (physics/boundaries.py).

The test writes the boundary files at T10 (32 x 16) into tmp_path, in
the reference's layout (ini_inbcon.f90:463-495): records of
little-endian float32 rows of nlon, stored north to south, on a seeded
mixed land mask, with some -999 (read as 0) and some negative values
(filled by fillsf) in the fields that have them.  fort.25 is read by
neither loader and is not written.

Tolerances: the records, fillsf and forchk are numpy on both sides and
equal exactly; every field of load_boundary_data is exact too, except
the spectrally truncated orography (phis0) and its drag factor (forog),
held at 1e-12 of their scale (float64 transforms in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu.physics import boundaries as jb
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.core.spectral import SpectralTransform
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.physics import boundaries as tb
from torch_lane import one_thread_per_pool  # noqa: F401

GEOM = dict(trunc=10, nlon=32, nlat=16, nlev=8)
TRUNCATED = ("phis0", "forog")


def write_boundary_files(root, nlat, nlon, seed=0):
    """fort.20-24 and fort.26 on a seeded mixed land mask; returns the
    land fraction (south to north)."""
    rng = np.random.default_rng(seed)
    shape = (nlat, nlon)
    fmask = np.clip(rng.uniform(-0.4, 1.4, shape), 0.0, 1.0)

    def holes(f, frac, value):
        f = f.copy()
        f[rng.uniform(size=f.shape) < frac] = value
        return f

    def write(unit, records):
        # rows stored north to south
        data = np.stack([r[::-1] for r in records]).astype("<f4")
        data.tofile(root / f"fort.{unit}")

    months = range(12)
    write(20, [3000.0 * fmask * rng.uniform(0, 1, shape), fmask,
               rng.uniform(0.07, 0.4, shape), rng.uniform(0, 0.8, shape),
               rng.uniform(0, 0.8, shape)])
    write(21, [holes(holes(rng.uniform(271.0, 303.0, shape), 0.05, -1.0),
                     0.03, -999.0) for _ in months])
    write(22, [holes(rng.uniform(-0.1, 1.0, shape), 0.03, -999.0)
               for _ in months])
    write(23, [holes(rng.uniform(240.0, 305.0, shape), 0.05, -2.0)
               for _ in months])
    write(24, [holes(rng.uniform(0.0, 80.0, shape), 0.03, -999.0)
               for _ in months])
    write(26, [rng.uniform(0.0, 0.4, shape) for _ in range(36)])
    return fmask


@pytest.fixture(scope="module")
def bc_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("bc")
    write_boundary_files(root, GEOM["nlat"], GEOM["nlon"])
    return root


@pytest.fixture(scope="module")
def loaded(bc_dir):
    jg = JGeometry(**GEOM)
    jbd = jb.load_boundary_data(jg, JST(jg, dtype=jnp.float64),
                                path=str(bc_dir))
    g = Geometry(**GEOM)
    sht = SpectralTransform(g, dtype=torch.float64, device="cpu")
    return jbd, tb.load_boundary_data(g, sht, path=str(bc_dir))


def test_records_fillsf_and_forchk_equal_jax(bc_dir):
    for unit, n in ((20, 5), (21, 12), (23, 12), (26, 36)):
        for off in (0, n - 1):
            a = tb.read_boundary_records(bc_dir / f"fort.{unit}", off,
                                         GEOM["nlon"], GEOM["nlat"])
            b = jb.read_boundary_records(bc_dir / f"fort.{unit}", off,
                                         GEOM["nlon"], GEOM["nlat"])
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(tb.fillsf(a), jb.fillsf(b))
            np.testing.assert_array_equal(tb.forchk(a - 0.3, a, 7.0),
                                          jb.forchk(b - 0.3, b, 7.0))
    sst = tb.read_boundary_records(bc_dir / "fort.21", 0, GEOM["nlon"],
                                   GEOM["nlat"])
    assert (sst < 0).any() and (sst == 0).any()     # fills and -999
    assert (tb.fillsf(sst) >= 0).all()
    with pytest.raises(ValueError, match="resolution"):
        tb.read_boundary_records(bc_dir / "fort.20", 0, 30, 16)
    with pytest.raises(ValueError, match="out of range"):
        tb.read_boundary_records(bc_dir / "fort.20", 5, GEOM["nlon"],
                                 GEOM["nlat"])


def test_load_boundary_data_equals_jax(loaded):
    jbd, tbd = loaded
    for k in tb.BoundaryData.__dataclass_fields__:
        ref = np.asarray(getattr(jbd, k))
        got = getattr(tbd, k).numpy()
        assert got.dtype == ref.dtype == np.float64, k
        if k in TRUNCATED:
            scale = np.abs(ref).max()
            assert np.abs(got - ref).max() <= 1e-12 * scale, k
        else:
            np.testing.assert_array_equal(got, ref, k)
    # a mixed mask: land, sea and fractional points, and orography
    assert 0 < float(tbd.fmask_l.mean()) < 1
    assert float(tbd.phis0.abs().max()) > 1e3


def test_gcm_reads_the_files(bc_dir, loaded, monkeypatch):
    _, tbd = loaded
    g = Geometry(**GEOM)
    monkeypatch.delenv(tb.BC_PATH_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match="boundary files"):
        GCM(g, dtype=torch.float64, device="cpu")
    a = GCM(g, dtype=torch.float64, bc_path=str(bc_dir), device="cpu")
    monkeypatch.setenv(tb.BC_PATH_ENV, str(bc_dir))
    b = GCM(g, dtype=torch.float32, device="cpu")
    for k in tb.BoundaryData.__dataclass_fields__:
        assert torch.equal(getattr(a.bd, k), getattr(tbd, k)), k
        # the float32 GCM's fields: its own load, rounded from float64
        # except the truncation, which runs at float32
        if k not in TRUNCATED:
            assert torch.equal(getattr(b.bd, k),
                               getattr(tbd, k).to(torch.float32)), k
    f32 = tb.load_boundary_data(g, path=str(bc_dir), dtype=torch.float32,
                                device="cpu")
    for k in TRUNCATED:
        assert torch.equal(getattr(b.bd, k), getattr(f32, k)), k
    assert a.phis.abs().max() > 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        tb.load_boundary_data(g, path=str(bc_dir))

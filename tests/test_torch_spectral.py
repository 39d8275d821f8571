"""Port parity of the spectral transform (core/spectral.py, K5/K6 plain).

The JAX package's SpectralTransform (zonal="dft", float64) and the
port's (float64 on the CPU, where grid_to_spec/spec_to_grid run the
plain versions of K5 and K6) take the same numpy inputs from a seed, at
T30 and T10.  Tolerance: 1e-12 of each field's signal (its largest
departure from its mean), float64 sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.core.geometry import Geometry as JGeometry
from speedy_ml_tpu.core.spectral import SpectralTransform as JST
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.core.spectral import SpectralTransform
from speedy_ml_tpu_torch.kernels.sht_analysis import sht_analysis_plain
from speedy_ml_tpu_torch.kernels.sht_synthesis import sht_synthesis_plain
from torch_lane import one_thread_per_pool  # noqa: F401

GEOMS = {"T30": dict(trunc=30, nlon=96, nlat=48, nlev=8),
         "T10": dict(trunc=10, nlon=32, nlat=16, nlev=8)}
RTOL = 1e-12


@pytest.fixture(scope="module", params=sorted(GEOMS))
def pair(request):
    kw = GEOMS[request.param]
    jsht = JST(JGeometry(**kw), dtype=jnp.float64, zonal="dft")
    tsht = SpectralTransform(Geometry(**kw), dtype=torch.float64,
                             device="cpu")
    return jsht, tsht


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    lead = ref.reshape(-1, *ref.shape[-2:]) if ref.ndim > 2 else ref[None]
    g = got.reshape(lead.shape)
    for a, b in zip(g, lead):
        signal = np.abs(b - b.mean()).max()
        assert np.abs(a - b).max() <= rtol * signal + 1e-300, (
            f"err {np.abs(a - b).max():.3e}, signal {signal:.3e}")


def _grid(geom, n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, geom.nlat, geom.nlon)) * 10.0 + 3.0


def _spec(geom, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, geom.mx, geom.nx))
            + 1j * rng.normal(size=(n, geom.mx, geom.nx)))


def test_tables_match(pair):
    jsht, tsht = pair
    for name in ("cpol_even_g", "cpol_odd_g", "cpol_even_s", "cpol_odd_s",
                 "wt", "trfilt", "el2", "elm2", "gradx", "gradym", "gradyp",
                 "uvdx", "uvdym", "uvdyp", "vddym", "vddyp", "zrow_mask",
                 "cosgr", "cosgr2", "dft_fwd", "dft_inv"):
        np.testing.assert_allclose(getattr(tsht, name).numpy(),
                                   np.asarray(getattr(jsht, name)),
                                   rtol=1e-14, atol=1e-300, err_msg=name)
    np.testing.assert_array_equal(
        (tsht.cpol_even_s + tsht.cpol_odd_s).numpy(), tsht.cpol_s.numpy())


def test_grid_to_spec_and_back(pair):
    jsht, tsht = pair
    g = tsht.geom
    x = _grid(g, 5, 0)
    _close(tsht.grid_to_spec(torch.as_tensor(x)), jsht.grid_to_spec(x))
    v = _spec(g, 4, 1)
    for kcos in (1, 2):
        _close(tsht.spec_to_grid(torch.as_tensor(v), kcos=kcos),
               jsht.spec_to_grid(jnp.asarray(v), kcos=kcos))
    # a single field, no batch axis
    _close(tsht.spec_to_grid(torch.as_tensor(v[0])),
           jsht.spec_to_grid(jnp.asarray(v[0])))


def test_round_trip(pair):
    jsht, tsht = pair
    x = _grid(tsht.geom, 3, 2)
    ref = jsht.spec_to_grid(jsht.trunct(jsht.grid_to_spec(x)))
    got = tsht.spec_to_grid(tsht.trunct(tsht.grid_to_spec(
        torch.as_tensor(x))))
    _close(got, ref)
    # a truncated field survives the round trip
    again = tsht.spec_to_grid(tsht.trunct(tsht.grid_to_spec(got)))
    _close(again, got, 1e-11)


def test_vector_operators(pair):
    jsht, tsht = pair
    g = tsht.geom
    u, v = _grid(g, 3, 3), _grid(g, 3, 4)
    for kcos in (2, 3):
        for got, ref in zip(tsht.vdspec(torch.as_tensor(u),
                                        torch.as_tensor(v), kcos=kcos),
                            jsht.vdspec(u, v, kcos=kcos)):
            _close(got, ref)
    a, b = _spec(g, 3, 5), _spec(g, 3, 6)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    for fn in ("vds", "uvspec", "uv_grid"):
        for got, ref in zip(getattr(tsht, fn)(ta, tb),
                            getattr(jsht, fn)(jnp.asarray(a), jnp.asarray(b))):
            _close(got, ref)
    for got, ref in zip(tsht.grad(ta), jsht.grad(jnp.asarray(a))):
        _close(got, ref)
    for fn in ("lap", "invlap", "trunct"):
        _close(getattr(tsht, fn)(ta), getattr(jsht, fn)(jnp.asarray(a)))


def test_plain_kernels_split_scaling(pair):
    """K5's pre-scale from field n0 on and K6's 1/cos from field ncos on
    equal the JAX transforms field by field."""
    jsht, tsht = pair
    g = tsht.geom
    x = _grid(g, 4, 7)
    got = sht_analysis_plain(torch.as_tensor(x), tsht.dft_fwd, tsht.wt,
                             tsht.cpol_even_s, tsht.cpol_odd_s, tsht.cosgr2,
                             2)
    _close(got[:2], jsht.grid_to_spec(x[:2]))
    scaled = x[2:] * np.asarray(jsht.cosgr2)[:, None]
    _close(got[2:], jsht.grid_to_spec(scaled))
    v = _spec(g, 4, 8)
    got = sht_synthesis_plain(torch.as_tensor(v), tsht.dft_inv,
                              tsht.cpol_even_g, tsht.cpol_odd_g, tsht.cosgr,
                              3)
    _close(got[:3], jsht.spec_to_grid(jnp.asarray(v[:3])))
    _close(got[3:], jsht.spec_to_grid(jnp.asarray(v[3:]), kcos=2))


def test_unported_transform_options_raise():
    g = Geometry(**GEOMS["T10"])
    with pytest.raises(ValueError, match="dft"):
        SpectralTransform(g, zonal="fft", device="cpu")
    # m-sharding is ported (tests/test_torch_sharded_gcm.py); a mesh must
    # start on the transform's device
    from speedy_ml_tpu_torch.parallel.mesh import Mesh
    sht = SpectralTransform(g, device="cpu")
    with pytest.raises(ValueError, match="first device"):
        sht.set_mesh(Mesh(["meta", "cpu"]))
    assert sht.mesh is None

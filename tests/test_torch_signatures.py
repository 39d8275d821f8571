"""The port's entry points take every option the JAX package's take.

For GCM, train_hybrid, train_hybrid_production, the slab ocean's
trainers and start_prediction, the checkpoint loader and the data
readers, every parameter with
a default in the JAX entry point (inspect.signature) is a parameter of the
port's with the same default: the same value, or for the two frameworks'
own types the counterpart (jnp.float32 -> torch.float32, the dataclasses
Geometry and PhysicalConstants by their fields).  Every option is
ported (UNPORTED is empty since the vertical groups, A10c-2); the slab
ocean with vertical groups raises, as the JAX package's train_hybrid
does; scan_unroll,
a JAX compile setting that changes no number, is taken and changes
nothing.  The positional `key` of the trainers is a JAX PRNG key where
the port takes an int seed.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speedy_ml_tpu.data import checkpoint as jck
from speedy_ml_tpu.data import era as jera
from speedy_ml_tpu.data import model_states as jms
from speedy_ml_tpu.data import reference_import as jri
from speedy_ml_tpu.gcm import GCM as JGCM
from speedy_ml_tpu.hybrid import chunked as jchunked
from speedy_ml_tpu.hybrid import training as jtraining
from speedy_ml_tpu.hybrid.chunked import \
    train_hybrid_production as j_train_production
from speedy_ml_tpu.hybrid.model import HybridAtmosphere as JHybridAtmosphere
from speedy_ml_tpu.hybrid.training import train_hybrid as j_train_hybrid
from speedy_ml_tpu.physics import boundaries as jbd
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.data import checkpoint as tck
from speedy_ml_tpu_torch.data import era as tera
from speedy_ml_tpu_torch.data import model_states as tms
from speedy_ml_tpu_torch.data import reference_import as tri
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
from speedy_ml_tpu_torch.gcm import GCM
from speedy_ml_tpu_torch.hybrid import chunked as tchunked
from speedy_ml_tpu_torch.hybrid import training as ttraining
from speedy_ml_tpu_torch.hybrid.chunked import train_hybrid_production
from speedy_ml_tpu_torch.hybrid.model import HybridAtmosphere
from speedy_ml_tpu_torch.hybrid.training import train_hybrid
from speedy_ml_tpu_torch.physics import boundaries as tbd
from speedy_ml_tpu_torch.physics.boundaries import synthetic_boundary_data
from torch_lane import one_thread_per_pool  # noqa: F401

PAIRS = {"GCM": (JGCM.__init__, GCM.__init__),
         "train_hybrid": (j_train_hybrid, train_hybrid),
         "train_hybrid_production": (j_train_production,
                                     train_hybrid_production),
         # the slab ocean (A10b)
         "fit_ocean_class": (jtraining.fit_ocean_class,
                             ttraining.fit_ocean_class),
         "train_ocean_class": (jtraining.train_ocean_class,
                               ttraining.train_ocean_class),
         "ocean_series_production": (jchunked.ocean_series_production,
                                     tchunked.ocean_series_production),
         "HybridAtmosphere.start_prediction": (
             JHybridAtmosphere.start_prediction,
             HybridAtmosphere.start_prediction),
         # the checkpoints and the data readers (A9, A13, A13b)
         "load_hybrid": (jck.load_hybrid, tck.load_hybrid),
         "load_boundary_data": (jbd.load_boundary_data,
                                tbd.load_boundary_data),
         "ERASource": (jchunked.ERASource.__init__,
                       tchunked.ERASource.__init__),
         "ERA5Reader": (jera.ERA5Reader.__init__, tera.ERA5Reader.__init__),
         "ERA5Reader.stream_samples": (jera.ERA5Reader.stream_samples,
                                       tera.ERA5Reader.stream_samples),
         "era_to_truth": (jera.era_to_truth, tera.era_to_truth),
         "ModelStateReader": (jms.ModelStateReader.__init__,
                              tms.ModelStateReader.__init__),
         "write_model_states": (jms.write_model_states,
                                tms.write_model_states),
         "generate_model_state_files": (jms.generate_model_state_files,
                                        tms.generate_model_state_files),
         "synthesize_reference_worker": (jri.synthesize_reference_worker,
                                         tri.synthesize_reference_worker),
         "assemble_reference_class": (jri.assemble_reference_class,
                                      tri.assemble_reference_class),
         "import_reference_weights": (jri.import_reference_weights,
                                      tri.import_reference_weights)}
# each unported option with a value other than its default
UNPORTED = {}
# the options ported last (vertical localization, A10c-2): each, with the
# slab ocean and vertical groups, meets the JAX package's own refusal
A10_OPTIONS = {"train_hybrid": {"vert_overlap": 1}}
GEOM = Geometry(trunc=10, nlon=32, nlat=16, nlev=8)


def _same_default(j, t):
    if j is jnp.float32:
        return t is torch.float32
    if dataclasses.is_dataclass(j):
        return (type(j).__name__ == type(t).__name__
                and dataclasses.asdict(j) == dataclasses.asdict(t))
    return type(j) is type(t) and j == t


@pytest.mark.parametrize("name", list(PAIRS))
def test_every_jax_option_is_taken_with_its_default(name):
    jfn, tfn = PAIRS[name]
    jp = inspect.signature(jfn).parameters
    tp = inspect.signature(tfn).parameters
    for k, p in jp.items():
        if p.default is inspect.Parameter.empty:
            continue
        assert k in tp, f"{name}: the port lacks {k}={p.default!r}"
        assert _same_default(p.default, tp[k].default), (
            f"{name}.{k}: JAX default {p.default!r}, port "
            f"{tp[k].default!r}")


def _call(name, **kw):
    if name == "GCM":
        return GCM(GEOM, dtype=torch.float64,
                   bd=synthetic_boundary_data(GEOM, dtype=torch.float64),
                   device="cpu", **kw)
    # the trainer checks its options before any work: no data is needed
    return train_hybrid(None, None, None, None, ESNHyper(), 0, device="cpu",
                        **kw)


@pytest.mark.parametrize("name,option", [(n, o) for n, opts in
                                         A10_OPTIONS.items() for o in opts])
def test_unported_option_raises_naming_a10(name, option):
    """No option is unported (UNPORTED is empty): A10's options are
    taken, and the one case the JAX package refuses, the slab ocean with
    vertical groups, raises before any work as it does there."""
    assert not UNPORTED
    with pytest.raises(NotImplementedError, match="vertical localization"):
        _call(name, ocean=True, num_vert_levels=2,
              **{option: A10_OPTIONS[name][option]})


def test_gcm_sst_anomaly_options_are_taken():
    """GCM(sstan_monthly=, sstan_year0=, sstom12=), once unported, build
    the GCM with the series and the climatology on its device."""
    sstan = np.ones((3, GEOM.nlat, GEOM.nlon))
    om12 = np.full((12, GEOM.nlat, GEOM.nlon), 280.0)
    g = _call("GCM", sstan_year0=1991, sstan_monthly=sstan, sstom12=om12)
    assert g.sstan_year0 == 1991
    assert g.sstan_monthly.shape == sstan.shape
    assert g.sstom12.dtype == torch.float64
    assert g.wsst_ob is None and g.slab.cdsea.shape == (GEOM.nlat,
                                                        GEOM.nlon)


def test_gcm_defaults_and_scan_unroll_build_the_same_gcm():
    a = _call("GCM", sstan_year0=1990)
    b = _call("GCM", scan_unroll=4)
    assert torch.equal(a.phis, b.phis)
    assert a.nsteps_day == b.nsteps_day == 96

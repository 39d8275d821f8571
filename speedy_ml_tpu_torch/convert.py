"""Parameters and states from numpy: run weights and states made
elsewhere in the port.

`params_from_numpy` takes the atmosphere parameters of a hybrid as
numpy arrays — per class a (reservoir, standardizer) pair whose fields
are read by name, e.g. the JAX package's `hyb.params[0]` after
`np.asarray` leaf by leaf — and makes the port's ClassPacks on a device.
Nothing here imports the other package: the pairs are read duck-typed.

Reservoir fields: cols, vals, win_vals, wout, mean, std, n_in, shifts,
win_cols (None allowed).  Standardizer fields: comp_mean, comp_std,
in_mean, in_std, out_mean, out_std.

`ocean_packs_from_numpy` does the same for the slab ocean's parameters
(the JAX package's `hyb.params[1]`: per class a (reservoir, mean_sst,
std_sst) triple), and `ocean_states_from_numpy` / `ocean_states_to_numpy`
carry the slab ocean's states (x, buffer, lm) across, with the roll
between the JAX buffer and the port's ring.

`boundary_from_numpy`, `spectral_state_from_numpy` and
`gcm_state_from_numpy` read boundary data, a two-level spectral state and
a GCM state the same way, field by field.
"""

from __future__ import annotations

import numpy as np
import torch

from speedy_ml_tpu_torch.esn.domain import RegionLayout, VertSpec
from speedy_ml_tpu_torch.esn.reservoir import BatchedReservoir, ESNHyper
from speedy_ml_tpu_torch.esn.standardize import Standardizer
from speedy_ml_tpu_torch.hybrid.model import (ClassPack, OceanClassState,
                                              OceanPack)

STD_FIELDS = ("comp_mean", "comp_std", "in_mean", "in_std", "out_mean",
              "out_std")


def tensor_from_numpy(a, device, dtype=None) -> torch.Tensor:
    """numpy (or array-like) -> tensor on `device`; a bfloat16 numpy array
    (the ml_dtypes type) stays bfloat16, other floats become `dtype`."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return t.to(device)
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def reservoir_from_numpy(res, *, device, dtype=torch.float32
                         ) -> BatchedReservoir:
    """A BatchedReservoir from the reservoir fields of `res` (read by
    name, see the module docstring): floats become `dtype` except a
    bfloat16 Wout, index arrays become int32."""
    device = torch.device(device)
    f = lambda a: tensor_from_numpy(a, device, dtype)
    idx = lambda a: None if a is None else \
        tensor_from_numpy(np.asarray(a, dtype=np.int32), device)
    shifts = getattr(res, "shifts", None)
    return BatchedReservoir(
        cols=idx(res.cols), vals=f(res.vals), win_vals=f(res.win_vals),
        wout=f(res.wout), mean=f(res.mean), std=f(res.std),
        n_in=int(res.n_in),
        shifts=None if shifts is None else tuple(int(s) for s in shifts),
        win_cols=idx(getattr(res, "win_cols", None)))


def params_from_numpy(atmo, layout: RegionLayout, hyper: ESNHyper, *,
                      device, dtype=torch.float32,
                      zspecs=None) -> list[ClassPack]:
    """ClassPacks for layout.classes (in order) from per-class numpy
    (reservoir, standardizer) pairs.  Float arrays become `dtype` except a
    bfloat16 Wout, which stays bfloat16; index arrays become int32.  With
    zspecs (a vertical group per pair, VertSpec fields), the pairs are a
    localized hybrid's, class-major and group-minor."""
    n_groups = 1 if zspecs is None else len(zspecs) // len(layout.classes)
    if len(atmo) != n_groups * len(layout.classes) or (
            zspecs is not None and len(zspecs) != len(atmo)):
        raise ValueError(f"{len(atmo)} parameter pairs for "
                         f"{len(layout.classes)} region classes")
    device = torch.device(device)
    f = lambda a: tensor_from_numpy(a, device, dtype)
    packs = []
    classes = [c for c in layout.classes for _ in range(n_groups)]
    for i, (cls, (res, std)) in enumerate(zip(classes, atmo)):
        r = reservoir_from_numpy(res, device=device, dtype=dtype)
        if r.vals.shape[1] != cls.count:
            raise ValueError(f"class {cls.name}: {cls.count} regions, "
                             f"parameters for {r.vals.shape[1]}")
        s = Standardizer(**{k: f(getattr(std, k)) for k in STD_FIELDS})
        zs = None if zspecs is None else VertSpec(*zspecs[i])
        packs.append(ClassPack(cls=cls, res=r, hyper=hyper, std=s, zspec=zs))
    return packs


def ocean_packs_from_numpy(ocean, layout: RegionLayout, hyper: ESNHyper, *,
                           device, dtype=torch.float32,
                           hybrid_readout: bool = False) -> list[OceanPack]:
    """OceanPacks for layout.classes (in order) from per-class numpy
    (reservoir, mean_sst, std_sst) triples; the index maps are
    esn/ocean.py's ocean_index_map.  Floats become `dtype`, mean_sst and
    std_sst (Rc, 1)."""
    from speedy_ml_tpu_torch.esn.ocean import ocean_index_map
    if len(ocean) != len(layout.classes):
        raise ValueError(f"{len(ocean)} ocean parameter triples for "
                         f"{len(layout.classes)} region classes")
    device = torch.device(device)
    col = lambda a: tensor_from_numpy(np.asarray(a).reshape(-1, 1), device,
                                      dtype)
    packs = []
    for cls, (res, mean_sst, std_sst) in zip(layout.classes, ocean):
        r = reservoir_from_numpy(res, device=device, dtype=dtype)
        if r.vals.shape[1] != cls.count:
            raise ValueError(f"ocean class {cls.name}: {cls.count} regions, "
                             f"parameters for {r.vals.shape[1]}")
        packs.append(OceanPack(
            cls=cls, res=r, hyper=hyper,
            idx_map=ocean_index_map(cls, layout.geom.nlev),
            mean_sst=col(mean_sst), std_sst=col(std_sst),
            hybrid_readout=hybrid_readout))
    return packs


def ocean_states_from_numpy(states, step: int, *, device,
                            dtype=torch.float32) -> tuple:
    """OceanClassStates from objects with x, buffer (the JAX package's
    buffer, oldest first) and lm (None allowed) at cycle `step`: the
    buffer becomes the ring (rolled by step mod W)."""
    from speedy_ml_tpu_torch.kernels.slab_ocean import buffer_to_ring
    f = lambda a: tensor_from_numpy(a, device, dtype)
    return tuple(OceanClassState(
        x=f(o.x), buffer=buffer_to_ring(f(o.buffer), step).contiguous(),
        lm=None if o.lm is None else f(o.lm)) for o in states)


def ocean_states_to_numpy(states, step: int) -> list[dict]:
    """The port's OceanClassStates at cycle `step` as dicts of numpy
    arrays (x, buffer, lm), the buffer in the JAX package's order."""
    from speedy_ml_tpu_torch.kernels.slab_ocean import ring_to_buffer
    host = lambda t: None if t is None else t.detach().cpu().numpy()
    return [dict(x=host(o.x), buffer=host(ring_to_buffer(o.buffer, step)),
                 lm=host(o.lm)) for o in states]


def boundary_from_numpy(bd, *, device, dtype=torch.float32):
    """A BoundaryData from any object with the BoundaryData field names
    (e.g. the JAX package's, leaf by leaf)."""
    from speedy_ml_tpu_torch.physics.boundaries import (BoundaryData,
                                                        fields_to_boundary)
    return fields_to_boundary(
        {k: np.asarray(getattr(bd, k)) for k in
         BoundaryData.__dataclass_fields__}, torch.device(device), dtype)


def spectral_state_from_numpy(spec, *, device, dtype=torch.float32):
    """A SpectralState (both leapfrog levels, complex) from any object with
    vor/div/t/ps/tr arrays; dtype is the real model dtype."""
    from speedy_ml_tpu_torch.core.spectral import complex_dtype
    from speedy_ml_tpu_torch.dycore.state import SpectralState
    cd = complex_dtype(dtype)
    return SpectralState(**{
        k: torch.from_numpy(np.array(getattr(spec, k), dtype=np.complex128,
                                     order="C")).to(device=device, dtype=cd)
        for k in SpectralState.FIELDS})


def gcm_state_from_numpy(gstate, *, device, dtype=torch.float32):
    """A GCMState from any object with spectral/sfc/radiation/fluxes (read
    field by field) and istep; the step counter becomes a host int.  An
    SPPT pattern (sppt_spec) comes along; the generator its draws come
    from does not (the JAX key has no torch counterpart): the caller
    gives the state one (dataclasses.replace(state, sppt_gen=...))."""
    from speedy_ml_tpu_torch.gcm import FluxAccumulator, GCMState
    from speedy_ml_tpu_torch.physics.driver import RadiationCarry
    from speedy_ml_tpu_torch.physics.land_sea import SurfaceState
    dev = torch.device(device)
    f = lambda cls, obj: cls(**{k: tensor_from_numpy(getattr(obj, k), dev,
                                                      dtype)
                                for k in cls.__dataclass_fields__})
    return GCMState(
        spectral=spectral_state_from_numpy(gstate.spectral, device=dev,
                                           dtype=dtype),
        sfc=f(SurfaceState, gstate.sfc),
        radiation=f(RadiationCarry, gstate.radiation),
        fluxes=f(FluxAccumulator, gstate.fluxes),
        istep=int(np.asarray(gstate.istep)),
        sppt_spec=(None if getattr(gstate, "sppt_spec", None) is None else
                   torch.as_tensor(np.array(gstate.sppt_spec)).to(
                       device=dev, dtype=torch.complex128
                       if dtype == torch.float64 else torch.complex64)))

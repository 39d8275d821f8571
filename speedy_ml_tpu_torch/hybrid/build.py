"""Builders for hybrid model instances (randomly initialized).

A randomly initialized hybrid (untrained Wout) has exactly the compute
graph of the trained one — used for smoke runs and benchmarking.  All
weights are drawn directly on the target device from integer seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.core.geometry import Geometry
from speedy_ml_tpu_torch.esn.domain import RegionLayout, build_layout
from speedy_ml_tpu_torch.esn.reservoir import (BatchedReservoir, ESNHyper,
                                               generate, radius_by_lat)
from speedy_ml_tpu_torch.esn.standardize import (Standardizer,
                                                 component_expansion,
                                                 n_components)
from speedy_ml_tpu_torch.hybrid.model import ClassPack, HybridAtmosphere

NVAR = 4


def derive_seed(*words: int) -> int:
    """A 31-bit seed derived from integer words (numpy SeedSequence)."""
    return int(np.random.SeedSequence([int(w) for w in words])
               .generate_state(1)[0] & 0x7FFFFFFF)


def untrained_pack(layout: RegionLayout, cls, hyper: ESNHyper, seed: int,
                   nz: int, dtype=torch.float32, radius_iters: int = 30,
                   ml_only: bool = False, topology: str = "shift",
                   device=None) -> ClassPack:
    """Reservoirs with random Wout and unit standardization (benchmark use).

    The reservoir draws from `seed`, Wout (1e-3 normal, on `device`) from
    derive_seed(seed, 5).  ml_only: no local-model block in Wout (S = 0)."""
    device = resolve_device(device)
    xi, yi = cls.input_shape
    xc, yc = cls.core_shape
    lay_in = build_layout(xi, yi, NVAR, nz, logp=True, precip=True, sst=True,
                          tisr=True)
    lay_out = build_layout(xc, yc, NVAR, nz, logp=True, precip=True,
                           sst=False, tisr=False)
    I, O = lay_in.total, lay_out.total
    # speedy vector: output minus precip block; absent in an ml_only readout
    S = 0 if ml_only else O - xc * yc

    Rc = cls.count
    radius = radius_by_lat(layout.lat_start[cls.region_ids],
                           layout.lat_end[cls.region_ids])
    cols, vals, win, shifts = generate(seed, Rc, I, hyper, radius,
                                       dtype=dtype,
                                       radius_iters=radius_iters,
                                       topology=topology, device=device)
    n = vals.shape[2]
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 5))
    wout = 1e-3 * torch.randn((Rc, O, S + n), generator=gen, dtype=dtype,
                              device=device)

    nc = n_components(NVAR, nz, logp=True, precip=True, sst=True, tisr=True)
    comp_in = torch.as_tensor(component_expansion(
        xi, yi, NVAR, nz, logp=True, precip=True, sst=True, tisr=True),
        dtype=torch.long, device=device)
    comp_out = torch.as_tensor(component_expansion(
        xc, yc, NVAR, nz, logp=True, precip=True, sst=False, tisr=False),
        dtype=torch.long, device=device)
    ones_c = torch.ones((Rc, nc), dtype=dtype, device=device)
    # physically plausible offsets so the assembled grid is SPEEDY-safe:
    # temperature components (var 0) get a 250 K offset
    mean_np = np.zeros((1, nc))
    mean_np[:, 0:nz] = 250.0
    mean_c = torch.as_tensor(mean_np, dtype=dtype,
                             device=device).expand(Rc, nc).contiguous()
    std = Standardizer(comp_mean=mean_c, comp_std=ones_c,
                       in_mean=mean_c[:, comp_in], in_std=ones_c[:, comp_in],
                       out_mean=mean_c[:, comp_out],
                       out_std=ones_c[:, comp_out])
    res = BatchedReservoir(cols=cols, vals=vals, win_vals=win, wout=wout,
                           mean=std.in_mean, std=std.in_std, n_in=I,
                           shifts=shifts)
    return ClassPack(cls=cls, res=res, hyper=hyper, std=std)


def build_untrained_hybrid(gcm=None, n_regions: int = 1152, m: int = 6000,
                           seed: int = 0, ml_only: bool = False,
                           radius_iters: int = 30, topology: str = "shift",
                           *, device=None) -> HybridAtmosphere:
    """An untrained hybrid on `device` (default CUDA; raises without one).

    gcm supplies geometry and dtype (gcm.geom, gcm.dtype); None means the
    production T30L8 grid in float32 (ml_only only: the coupled cycle
    needs a GCM on `device`).  Class i draws from derive_seed(seed, i)
    (see untrained_pack); a coupled readout has the local-model block
    (S = O - xc*yc, the output minus its precip block)."""
    device = resolve_device(device)
    if not ml_only and gcm is None:
        raise ValueError("the coupled cycle (ml_only=False) needs a GCM")
    geom = gcm.geom if gcm is not None else Geometry()
    dtype = gcm.dtype if gcm is not None else torch.float32
    layout = RegionLayout(geom, n_regions=n_regions, overlap=1)
    hyper = ESNHyper(m=m)
    packs = [untrained_pack(layout, cls, hyper, derive_seed(seed, i),
                            geom.nlev, dtype=dtype,
                            radius_iters=radius_iters, ml_only=ml_only,
                            topology=topology, device=device)
             for i, cls in enumerate(layout.classes)]
    return HybridAtmosphere(gcm, layout, packs, ml_only=ml_only,
                            device=device)

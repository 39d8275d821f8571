"""Checkpoints: trained hybrid weights, GCM restarts, reference weights.

Counterpart of the JAX package's data/checkpoint.py, in the same file
formats, so that each package reads what the other writes:
1. a hybrid: one .npz per region class (class_<i>.npz: res_*, std_*,
   n_in, region_ids, and shifts / win_cols when present) and meta.json
   (format_version 2, vals_layout, n_classes, ml_only, has_ocean,
   hyper_<i>, and zspec_<i> for a vertical group's pack: with vertical
   localization the packs run class-major, group-minor); with a slab
   ocean also ocean_<i>.npz (res_*, n_in, idx_map, shifts, mean_sst,
   std_sst), ocean_hyper_<i> and
   ocean_hybrid_<i> in meta.json, and ocean_aux.npz (base_sst,
   sea_mask);
2. a GCM restart: one .npz of the GCMState's leaves (n_leaves, leaf_<i>)
   in the JAX pytree's order;
3. the reference's per-worker weight files: data/reference_import.py
   (read_reference_worker is re-exported here).

What the writer does differently, all of it read by both loaders:
- the checkpoint is written into `path`.tmp, meta.json last, and then
  renamed to `path`, so that no reader sees a half-written one;
- a bfloat16 Wout is written as float32, which is exact (numpy has no
  bfloat16; the JAX writer's 2-byte void records cannot be read back
  by its own loader); this loader reads those records as bfloat16 too;
- the class files are not compressed: at full width Wout alone is
  3.8 GB in float32, which zlib takes minutes over, and np.load reads
  compressed and plain files alike.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import types
from pathlib import Path

import numpy as np
import torch

from speedy_ml_tpu_torch import resolve_device
from speedy_ml_tpu_torch.convert import (STD_FIELDS, reservoir_from_numpy,
                                         tensor_from_numpy)
from speedy_ml_tpu_torch.esn.domain import VertSpec
from speedy_ml_tpu_torch.esn.reservoir import ESNHyper
from speedy_ml_tpu_torch.esn.standardize import Standardizer
from speedy_ml_tpu_torch.hybrid.model import (ClassPack, HybridAtmosphere,
                                              OceanPack)

# Checkpoint format history (the JAX package's):
#   (unversioned) res_vals row-major (R, n, J), no 'shifts'
#   2: res_vals slot-major (J, R, n); optional 'shifts' key
FORMAT_VERSION = 2
RES_FIELDS = ("cols", "vals", "win_vals", "wout", "mean", "std")


def _to_numpy(a) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array; bfloat16
    becomes float32 (exact)."""
    if torch.is_tensor(a):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def _float_tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    """A float array as np.load gives it, as a `dtype` tensor on `device`.
    The JAX writer's bfloat16 arrays come back as 2-byte void records:
    their bits are read as bfloat16."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = tensor_from_numpy(a, "cpu")
    return t.to(device=device, dtype=dtype)


def _write_dir(path, write):
    """write(tmp_dir) into `path`.tmp, then rename it to `path` (an older
    checkpoint there is moved aside and removed after the rename)."""
    p = Path(path)
    tmp = Path(str(p) + ".tmp")
    old = Path(str(p) + ".old")
    for d in (tmp, old):
        if d.exists():
            shutil.rmtree(d)
    tmp.mkdir(parents=True)
    write(tmp)
    if p.exists():
        os.replace(p, old)
    os.replace(tmp, p)
    if old.exists():
        shutil.rmtree(old)


def save_hybrid(hyb, path: str):
    """Save every class pack and slab-ocean pack of a hybrid (anything
    with packs, ml_only and ocean_packs, base_sst, sea_mask) to the
    directory `path`, in the JAX package's format; a vertical group's
    pack also writes its VertSpec as zspec_<i> in meta.json."""
    ocean_packs = getattr(hyb, "ocean_packs", None)
    meta = {"format_version": FORMAT_VERSION, "vals_layout": "slot_major",
            "n_classes": len(hyb.packs), "ml_only": bool(hyb.ml_only),
            "has_ocean": ocean_packs is not None}

    def write(d: Path):
        for i, pk in enumerate(hyb.packs):
            arrs = {f"res_{k}": _to_numpy(getattr(pk.res, k))
                    for k in RES_FIELDS}
            arrs.update({f"std_{k}": _to_numpy(getattr(pk.std, k))
                         for k in STD_FIELDS})
            arrs["n_in"] = np.asarray(pk.res.n_in)
            arrs["region_ids"] = np.asarray(pk.cls.region_ids)
            if pk.res.shifts is not None:
                arrs["shifts"] = np.asarray(pk.res.shifts, dtype=np.int64)
            if pk.res.win_cols is not None:
                # the ragged per-row Win map of reference-imported packs
                arrs["win_cols"] = _to_numpy(pk.res.win_cols) \
                    .astype(np.int32)
            np.savez(d / f"class_{i}.npz", **arrs)
            meta[f"hyper_{i}"] = dataclasses.asdict(pk.hyper)
            if pk.zspec is not None:
                meta[f"zspec_{i}"] = [int(v) if not isinstance(v, bool)
                                      else v for v in pk.zspec]
        for i, op in enumerate(ocean_packs or ()):
            arrs = {f"res_{k}": _to_numpy(getattr(op.res, k))
                    for k in RES_FIELDS}
            arrs["n_in"] = np.asarray(op.res.n_in)
            arrs["idx_map"] = np.asarray(op.idx_map)
            if op.res.shifts is not None:
                arrs["shifts"] = np.asarray(op.res.shifts, dtype=np.int64)
            arrs["mean_sst"] = _to_numpy(op.mean_sst)
            arrs["std_sst"] = _to_numpy(op.std_sst)
            np.savez(d / f"ocean_{i}.npz", **arrs)
            meta[f"ocean_hyper_{i}"] = dataclasses.asdict(op.hyper)
            meta[f"ocean_hybrid_{i}"] = bool(op.hybrid_readout)
        if ocean_packs and hyb.base_sst is not None:
            np.savez(d / "ocean_aux.npz", base_sst=_to_numpy(hyb.base_sst),
                     sea_mask=_to_numpy(hyb.sea_mask))
        (d / "meta.json").write_text(json.dumps(meta, indent=1))

    _write_dir(path, write)


def read_meta(path: str) -> dict:
    """meta.json of a checkpoint, its format_version checked."""
    meta = json.loads((Path(path) / "meta.json").read_text())
    ver = meta.get("format_version", 1)
    if ver != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint at {path} has format_version {ver}; this build "
            f"reads version {FORMAT_VERSION} (res_vals slot-major (J, R, n)). "
            "Re-save the checkpoint with the matching build.")
    return meta


def read_zspec(meta: dict, i: int):
    """Pack i's vertical group (a VertSpec from zspec_<i>), or None."""
    z = meta.get(f"zspec_{i}")
    if z is None:
        return None
    if not isinstance(z, list) or len(z) != len(VertSpec._fields):
        raise ValueError(f"zspec_{i} in meta.json: {z!r} is not a VertSpec "
                         f"({', '.join(VertSpec._fields)})")
    return VertSpec(*[bool(v) if f in ("top", "bottom") else int(v)
                      for f, v in zip(VertSpec._fields, z)])


def _reservoir(z, i: int, cls, device, dtype):
    """The BatchedReservoir of class file i (np.load's NpzFile z)."""
    vals, win_vals = z["res_vals"], z["res_win_vals"]
    # slot-major vals (J, R, n) agree with win_vals (R, n) on both
    # trailing dims
    if vals.shape[1:] != win_vals.shape or vals.shape[0] > vals.shape[2]:
        raise ValueError(
            f"class_{i}: res_vals shape {vals.shape} is not slot-major "
            f"(J, R, n) consistent with win_vals {win_vals.shape}")
    if "region_ids" in z.files and not np.array_equal(z["region_ids"],
                                                      cls.region_ids):
        raise ValueError(f"class_{i}: its regions are not those of the "
                         f"layout's class {cls.name}")
    # Wout apart: it may be the JAX writer's bfloat16 records
    res = reservoir_from_numpy(types.SimpleNamespace(
        cols=z["res_cols"], vals=vals, win_vals=win_vals, wout=np.zeros(0),
        mean=z["res_mean"], std=z["res_std"], n_in=int(z["n_in"]),
        shifts=z["shifts"] if "shifts" in z.files else None,
        win_cols=z["win_cols"] if "win_cols" in z.files else None),
        device=device, dtype=dtype)
    return dataclasses.replace(
        res, wout=_float_tensor(z["res_wout"], device, dtype))


def load_hybrid(gcm, layout, path: str, dtype=torch.float32, *,
                device=None):
    """Rebuild a HybridAtmosphere from save_hybrid's output (either
    package's) on `device` (default CUDA; raises without one).  Floats
    become `dtype`, a bfloat16 Wout included."""
    device = resolve_device(device)
    p = Path(path)
    meta = read_meta(path)
    n, nc = meta["n_classes"], len(layout.classes)
    zspecs = [read_zspec(meta, i) for i in range(n)]
    # with vertical localization the packs run class-major, group-minor
    n_groups = n // nc if n % nc == 0 else 0
    n_z = sum(z is not None for z in zspecs)
    if n_groups < 1 or (n_groups > 1) != (n_z > 0):
        raise ValueError(f"checkpoint at {path} has {n} classes, the layout "
                         f"{nc}" + (f", with {n_groups} vertical groups but "
                                    f"zspec_<i> on {n_z} packs"
                                    if n_groups > 1 else ""))
    packs = []
    for i in range(n):
        cls = layout.classes[i // n_groups]
        with np.load(p / f"class_{i}.npz") as z:
            res = _reservoir(z, i, cls, device, dtype)
            std = Standardizer(**{k: tensor_from_numpy(z[f"std_{k}"], device,
                                                       dtype)
                                  for k in STD_FIELDS})
        packs.append(ClassPack(cls=cls, res=res,
                               hyper=ESNHyper(**meta[f"hyper_{i}"]), std=std,
                               zspec=zspecs[i]))
    ocean_packs = base_sst = sea_mask = None
    if meta.get("has_ocean"):
        ocean_packs = []
        for i, cls in enumerate(layout.classes):
            with np.load(p / f"ocean_{i}.npz") as z:
                res = _reservoir(z, i, cls, device, dtype)
                f = lambda k: tensor_from_numpy(z[k], device, dtype)
                ocean_packs.append(OceanPack(
                    cls=cls, res=res,
                    hyper=ESNHyper(**meta[f"ocean_hyper_{i}"]),
                    idx_map=np.asarray(z["idx_map"]),
                    mean_sst=f("mean_sst"), std_sst=f("std_sst"),
                    hybrid_readout=meta.get(f"ocean_hybrid_{i}", False)))
        aux = p / "ocean_aux.npz"
        if aux.exists():
            with np.load(aux) as z:
                base_sst = tensor_from_numpy(z["base_sst"], device, dtype)
                sea_mask = tensor_from_numpy(z["sea_mask"], device)
    return HybridAtmosphere(gcm, layout, packs, ml_only=meta["ml_only"],
                            ocean_packs=ocean_packs, base_sst=base_sst,
                            sea_mask=sea_mask, device=device)


# ----------------------------------------------------------------------
# GCM restart (the reference's ppo_restart.f90 family)
# ----------------------------------------------------------------------

def gcm_leaves(obj) -> list:
    """The leaves of a GCMState in the JAX pytree's order: the fields in
    order, dataclasses flattened in their field order, None dropped.  The
    SPPT generator is no leaf (the JAX state's key has no counterpart in
    it): a restart keeps the pattern, and the loaded state draws from the
    template's generator."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, torch.Generator):
            continue
        if dataclasses.is_dataclass(v):
            out += gcm_leaves(v)
        else:
            out.append(v)
    return out


def _rebuild(template, values):
    kw = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        if v is None or isinstance(v, torch.Generator):
            kw[f.name] = v
        elif dataclasses.is_dataclass(v):
            kw[f.name] = _rebuild(v, values)
        elif torch.is_tensor(v):
            a = next(values)
            if tuple(a.shape) != tuple(v.shape):
                raise ValueError(f"restart leaf {f.name}: shape "
                                 f"{a.shape}, the template's {tuple(v.shape)}")
            kw[f.name] = torch.from_numpy(np.array(a, order="C")).to(
                device=v.device, dtype=v.dtype)
        else:
            kw[f.name] = type(v)(np.asarray(next(values)))
    return type(template)(**kw)


def save_gcm_restart(gstate, path: str):
    """A GCMState's leaves to one npz, as the JAX package writes its
    pytree (the step counter as a 0-d int32 array)."""
    leaves = [np.asarray(v, dtype=np.int32) if isinstance(v, int)
              else _to_numpy(v) for v in gcm_leaves(gstate)]
    np.savez_compressed(path, n_leaves=len(leaves),
                        **{f"leaf_{i}": v for i, v in enumerate(leaves)})


def load_gcm_restart(path: str, template):
    """A GCMState from save_gcm_restart's file (either package's): the
    template (e.g. a fresh init_state) gives the structure, and each
    leaf its device and dtype."""
    with np.load(path) as z:
        n = int(z["n_leaves"])
        if n != len(gcm_leaves(template)):
            raise ValueError(f"restart structure mismatch: {n} leaves in "
                             f"{path}, {len(gcm_leaves(template))} in the "
                             f"template")
        return _rebuild(template, iter(z[f"leaf_{i}"] for i in range(n)))


# ----------------------------------------------------------------------
# reference weight import (Zenodo artifact)
# ----------------------------------------------------------------------

def read_reference_worker(path: str) -> dict:
    """Read one reference worker weight file (see data.reference_import)."""
    from speedy_ml_tpu_torch.data.reference_import import \
        read_reference_worker as _r
    return _r(path)


def coo_to_ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n: int) -> tuple[np.ndarray, np.ndarray]:
    """COO (1-based Fortran indices) -> ELL (cols, vals) padded arrays.

    A row's entries take its slots in the order they come in the COO
    lists (a stable sort by row), as the JAX package's loop fills them."""
    r = np.asarray(rows).astype(np.int64) - 1
    c = np.asarray(cols).astype(np.int64) - 1
    counts = np.bincount(r, minlength=n)
    J = int(counts.max()) if n else 0
    ell_cols = np.zeros((n, J), dtype=np.int32)
    ell_vals = np.zeros((n, J), dtype=np.float64)
    order = np.argsort(r, kind="stable")
    rs = r[order]
    start = np.cumsum(counts) - counts
    slot = np.arange(len(rs)) - start[rs]
    ell_cols[rs, slot] = c[order]
    ell_vals[rs, slot] = np.asarray(vals)[order]
    return ell_cols, ell_vals


def win_to_rowvals(win: np.ndarray) -> np.ndarray:
    """Block-diagonal Win (n, I) -> per-row values (n,).

    The reference fills rows (i-1)q+1..iq of column i
    (mod_reservoir.f90:270-278); verify the structure and compress."""
    n, I = win.shape
    q = n // I
    row_col = np.arange(n) // q
    vals = win[np.arange(n), row_col]
    # structure check: everything off the block diagonal must be zero,
    # i.e. the nonzeros of win are those of its block diagonal
    if np.count_nonzero(win) != np.count_nonzero(vals):
        raise ValueError("win is not block-diagonal; cannot compress")
    return vals

"""K4: the core-scatter + clamps kernel (csrc/core_scatter.cu) and its
plain version.

Every element e of the flat output [atmo (V, K, lat, lon), logp,
precip] reads vec[table[e]] from the concatenation of the classes'
flattened (Rc, O) output vectors (RegionLayout.core_source_table), then
q = max(q, 1e-6) and precip < 1e-5 -> 0 (assemble_global's clamps).  The
cores tile the grid once, so the scatter is a race-free gather; all
classes go in one launch.  The kernel writes NaN for a table entry
outside the vectors (the plain version raises).

On CPU tensors `core_scatter` runs `core_scatter_plain`; on CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from speedy_ml_tpu_torch.kernels import build as kb

MAX_CLASSES = 8   # csrc/common.cuh


def _split(flat: torch.Tensor, nvar: int, nz: int, nlat: int, nlon: int):
    G = nlat * nlon
    A = nvar * nz * G
    return (flat[:A].view(nvar, nz, nlat, nlon),
            flat[A:A + G].view(nlat, nlon), flat[A + G:].view(nlat, nlon))


def core_scatter_plain(vecs, table, nvar: int, nz: int, nlat: int,
                       nlon: int):
    """The plain PyTorch version of the kernel: (atmo, logp, precip)."""
    src = torch.cat([v.reshape(-1) for v in vecs])
    atmo, logp, precip = _split(src[table.long()], nvar, nz, nlat, nlon)
    atmo = atmo.clone()
    atmo[3] = torch.clamp_min(atmo[3], 1e-6)                 # q clamp
    precip = torch.where(precip < 1e-5, torch.zeros_like(precip), precip)
    return atmo, logp, precip


def core_scatter(vecs, table, nvar: int, nz: int, nlat: int, nlon: int):
    """Assemble the global (atmo (nvar, nz, lat, lon), logp, precip) from
    every class's (Rc, O) output vectors, with the physical clamps."""
    G = nlat * nlon
    total = nvar * nz * G + 2 * G
    if nvar < 4:
        raise ValueError("core_scatter: humidity is variable 3")
    if tuple(table.shape) != (total,):
        raise ValueError(f"core_scatter: table shape {tuple(table.shape)}, "
                         f"expected ({total},)")
    dev = table.device
    if dev.type == "cpu":
        return core_scatter_plain(vecs, table, nvar, nz, nlat, nlon)
    if dev.type != "cuda":
        raise ValueError(f"core_scatter: no kernel for device {dev}")
    nc = len(vecs)
    if not 1 <= nc <= MAX_CLASSES:
        raise ValueError(f"core_scatter: {nc} classes, kernel takes 1 to "
                         f"{MAX_CLASSES}")
    kb.require(table, "table", torch.int32, (total,), dev)
    for c, v in enumerate(vecs):
        kb.require(v, f"vecs[{c}]", torch.float32, None, dev)
    out = torch.empty(total, dtype=torch.float32, device=dev)
    q0 = 3 * nz * G
    p0 = nvar * nz * G + G
    vp = ctypes.c_void_p
    code = kb.library().core_scatter_launch(
        kb.device_index(table), nc, (vp * nc)(*[v.data_ptr() for v in vecs]),
        (ctypes.c_longlong * nc)(*[v.numel() for v in vecs]),
        table.data_ptr(), total, q0, q0 + nz * G, p0, p0 + G, out.data_ptr(),
        kb.stream_of(table))
    kb.check(code, "core_scatter")
    core_scatter.launches += 1
    return _split(out, nvar, nz, nlat, nlon)


core_scatter.launches = 0

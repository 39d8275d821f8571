"""K21: the persistent surface's flux accumulation and the daily slab
coupler (csrc/slab_couple.cu), and its plain version.

The JAX package's couple_daily (physics/land_sea.py:244-325) is the
daily exchange of the slab land, sea and ice models with the
atmosphere; its coupled cycle with persist_surface adds each window's
fluxes to the carried sums and couples on every fourth cycle
(hybrid/model.py:640-659), and GCM.run_days couples at the end of each
day with the observed SST anomaly of the date (gcm.py:322-332,
sstan_for_window).  One launch does a call's whole work, one thread a
grid point, in one of three forms:
  - accumulate (a window, no coupling): the sums acc + (ok ? window : 0);
  - couple (a window and coupling): the same sums, then the coupled
    surface at the date, and the sums zeroed;
  - day (no window): the coupled surface from the day's sums, with the
    anomaly forint'ed from three monthly planes.
The window's sums count only where the gate's flag ok is true, by a
select (a window that the gate skipped may hold NaN).

The flags, the month indices and weights and do_couple are host values
(kernel arguments); ok stays on the device.  In the device-scalar form
(scalars=), which a captured CUDA graph of the cycle replays
(hybrid/graph.py), the month indices and weights are read on the card
from K17's scalar row (surface_forcing.scalar_values).  On CPU tensors
`slab_couple` runs `slab_couple_plain`, which is also the port's
couple_daily; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from speedy_ml_tpu_torch.kernels import build as kb
from speedy_ml_tpu_torch.kernels.surface_forcing import (_scalars,
                                                         climatology_plain,
                                                         forin5,
                                                         forint_weights,
                                                         require_scalars)
from speedy_ml_tpu_torch.physics import constants as pc

# the planes of the surface output: land_sea.SurfaceState's fields in
# their order (csrc/slab_couple.cuh SL_*)
SURFACE_FIELDS = ("stl_lm", "sst_om", "tice_om", "sice_om", "stl_am",
                  "snowd_am", "soilw_am", "sst_am", "sice_am", "tice_am")
# the planes of the sums: gcm.FluxAccumulator's fields (FX_*)
FLUX_FIELDS = ("hflux_l", "hflux_s", "hflux_i", "precip")
# the slab coefficients: land_sea.SlabCoeffs's fields (CO_*)
COEFF_FIELDS = ("rhcapl", "cdland", "rhcaps", "rhcapi", "cdsea", "cdice")
# the operands of the launch's pointer array (IN_*), in this order
INPUTS = (("stl12", "snowd12", "soilw12", "sst12", "sice12", "om12",
           "stl_lm", "sst_om", "tice_om") + COEFF_FIELDS
          + ("wsst", "sstan0", "sstan1", "sstan2")
          + tuple("acc_" + f for f in FLUX_FIELDS)
          + tuple("win_" + f for f in FLUX_FIELDS) + ("ok",))
# the integer options (OP_*), in this order
OPTIONS = ("icland", "icsea", "icice", "add_anom", "blend", "do_couple",
           "an2")


def sstan_weights(fmon: float) -> tuple[int, float]:
    """sstan_for_window's forint over the (previous, this, next) month
    planes: (the index of the other plane, 0 or 2, its weight)."""
    _, an2, w = forint_weights(1, fmon)
    return an2, w


def _anomaly(sstan):
    """The observed anomaly of a call's sstan: None, a (lat, lon) plane,
    or ((prev, this, next) planes, fmon), interpolated as
    sstan_for_window."""
    if sstan is None or torch.is_tensor(sstan):
        return sstan
    planes, fmon = sstan
    an2, w = sstan_weights(fmon)
    return planes[1] + w * (planes[an2] - planes[1])


def _accumulate(acc, window, ok):
    """The sums acc + (ok ? window : 0), field by field (acc's fields
    without a window)."""
    if window is None:
        return list(acc)
    if ok is None:
        return [a + w for a, w in zip(acc, window)]
    return [a + torch.where(ok, w, 0.0) for a, w in zip(acc, window)]


def slab_couple_plain(bd, coeffs, carry, acc, month, flags, *, window=None,
                      ok=None, do_couple=True, sstan=None, wsst=None,
                      sstom12=None):
    """(the coupled surface (10, lat, lon) in SURFACE_FIELDS order or
    None, the sums (4, lat, lon) or None) in plain PyTorch: the arguments
    of slab_couple."""
    f = _accumulate(acc, window, ok)
    fx = None
    if window is not None:
        fx = torch.zeros((4,) + f[0].shape, dtype=f[0].dtype,
                         device=f[0].device) if do_couple else torch.stack(f)
    if not do_couple:
        return None, fx
    imon, fmon = month
    hflux_l, hflux_s, hflux_i = f[:3]
    sstan_ob = _anomaly(sstan)
    cl = climatology_plain(bd, imon, fmon)

    # land model (mod_cpl_land_model.f90:85-126)
    if flags.icland > 0:
        tanom = carry.stl_lm - cl["stlcl"]
        tanom = coeffs.cdland * (tanom + coeffs.rhcapl * hflux_l)
        stl_lm = tanom + cl["stlcl"]
        stl_am = stl_lm
    else:
        stl_lm = stl_am = cl["stlcl"]

    # sea and ice models (cpl_sea_model.f90:117-206); hfseacl = 0; sice0
    # is the date's climatological ice fraction (cpl_sea.f90:124)
    sice0 = cl["sicecl"]
    if flags.icsea > 0 or flags.icice > 0:
        dti = pc.SSTFR - carry.tice_om
        hflux = hflux_s - sice0 * (hflux_i + dti)
        tanom_s = carry.sst_om - cl["sstcl"]
        tanom_s = coeffs.cdsea * (tanom_s + coeffs.rhcaps * hflux)
        sst_om = tanom_s + cl["sstcl"]
        hflux_ice = hflux_i + dti
        tanom_i = carry.tice_om - cl["ticecl"]
        anom0 = 20.0
        # anom0 / d: PyTorch's reciprocal of d times anom0 (the kernel
        # computes the same)
        cdis = coeffs.cdice * (anom0 / (anom0 + torch.abs(tanom_i)))
        tanom_i = cdis * (tanom_i + coeffs.rhcapi * hflux_ice)
        tice_om = tanom_i + cl["ticecl"]
    else:
        sst_om, tice_om = carry.sst_om, carry.tice_om

    # sea2atm (cpl_sea.f90:150-201)
    if flags.icsea <= 1:
        sst_am = cl["sstcl"]
        if flags.isstan > 0 and sstan_ob is not None:
            sst_am = sst_am + sstan_ob
    elif flags.icsea == 2:
        sst_am = sst_om
    else:   # icsea >= 3: climatology + ocean-model anomaly
        om12 = bd.sst12 if sstom12 is None else sstom12
        sstcl_om = forin5(om12, imon, fmon) + (cl["sstcl"] - cl["sstcl0"])
        sstan_am = sst_om - sstcl_om
        if flags.icsea >= 4 and wsst is not None and sstan_ob is not None:
            sstan_am = sstan_am + wsst * (sstan_ob - sstan_am)
        sst_am = cl["sstcl"] + sstan_am

    if flags.icice > 0:
        sice_am, tice_am = sice0, tice_om
    else:
        sice_am, tice_am = cl["sicecl"], cl["ticecl"]
    sst_am = sst_am + sice_am * (tice_am - sst_am)
    sfc = torch.stack([stl_lm, sst_om, tice_om, cl["sicecl"], stl_am,
                       cl["snowdcl"], cl["soilwcl"], sst_am, sice_am,
                       tice_am])
    return sfc, fx


def operands(bd, coeffs, carry, acc, flags, *, window=None, ok=None,
             do_couple=True, sstan=None, wsst=None, sstom12=None):
    """The launch's operands: (the INPUTS tensors by name, None where the
    form reads nothing; the OPTIONS values by name; the anomaly's forint
    weight).  The arguments are slab_couple's."""
    ins = dict.fromkeys(INPUTS)
    opts = dict(icland=flags.icland, icsea=flags.icsea, icice=flags.icice,
                add_anom=0, blend=0, do_couple=int(do_couple), an2=0)
    w_an = 0.0
    for k, f in enumerate(FLUX_FIELDS):
        ins["acc_" + f] = acc[k]
        if window is not None:
            ins["win_" + f] = window[k]
    if window is not None:
        ins["ok"] = ok
    if not do_couple:
        return ins, opts, w_an
    for nm in ("stl12", "snowd12", "soilw12", "sst12", "sice12"):
        ins[nm] = getattr(bd, nm)
    if flags.icsea >= 3:
        ins["om12"] = sstom12
    for nm in ("stl_lm", "sst_om", "tice_om"):
        ins[nm] = getattr(carry, nm)
    for nm in COEFF_FIELDS:
        ins[nm] = getattr(coeffs, nm)
    if sstan is not None:
        if torch.is_tensor(sstan):
            ins["sstan1"] = sstan
        else:
            planes, fmon = sstan
            ins["sstan0"], ins["sstan1"], ins["sstan2"] = planes
            opts["an2"], w_an = sstan_weights(fmon)
        opts["add_anom"] = int(flags.icsea <= 1 and flags.isstan > 0)
        opts["blend"] = int(flags.icsea >= 4 and wsst is not None)
        if opts["blend"]:
            ins["wsst"] = wsst
    return ins, opts, w_an


def slab_couple(bd, coeffs, carry, acc, month, flags, *, window=None,
                ok=None, do_couple=True, sstan=None, wsst=None,
                sstom12=None, scalars=None):
    """(the coupled surface (10, lat, lon), its planes SurfaceState's
    fields in order, or None when not coupling; the sums (4, lat, lon),
    FluxAccumulator's fields, or None without a window).

    bd: BoundaryData; coeffs: SlabCoeffs; carry: the carried SurfaceState
    (stl_lm, sst_om, tice_om are read); acc: the sums (hflux_l, hflux_s,
    hflux_i, precip; precip may be None without a window); month: (imon,
    fmon), host numbers; flags: CplFlags.  window: the window's sums, or
    None (the day form); ok: the gate's 0-d bool flag, or None (true);
    do_couple: a host bool.  sstan: the observed anomaly, None, a (lat,
    lon) plane, or ((prev, this, next) planes, fmon) (sstan_for_window);
    wsst: the elnino blend weights (icsea >= 4); sstom12: the ocean
    model's SST climatology (12, lat, lon) (icsea >= 3; None: bd.sst12).
    scalars: None, or the device-scalar form's float64 tensor on the card
    (surface_forcing.scalar_values of the month), read by the kernel in
    place of the month's indices and weights; the CPU route reads month."""
    if window is None and not do_couple:
        raise ValueError("slab_couple: without a window there is nothing "
                         "but the coupling to do")
    dev = bd.sst12.device
    if dev.type == "cpu":
        return slab_couple_plain(bd, coeffs, carry, acc, month, flags,
                                 window=window, ok=ok, do_couple=do_couple,
                                 sstan=sstan, wsst=wsst, sstom12=sstom12)
    if dev.type != "cuda":
        raise ValueError(f"slab_couple: no kernel for device {dev}")
    dt = bd.sst12.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"slab_couple: dtype {dt}, the kernel takes float32 "
                        "or float64")
    grid = tuple(bd.sst12.shape[-2:])
    ins, opts, w_an = operands(bd, coeffs, carry, acc, flags, window=window,
                               ok=ok, do_couple=do_couple, sstan=sstan,
                               wsst=wsst, sstom12=sstom12)
    for nm, t in ins.items():
        if t is None:
            continue
        if nm == "ok":
            kb.require(t, "ok", torch.bool, (), dev)
        else:
            kb.require(t, nm, dt, (12,) + grid if nm.endswith("12")
                       else grid, dev)
    if scalars is None:
        scal, ix = _scalars(month, 0.0, None, 0.0, 0.0)
    else:
        require_scalars(scalars, "scalars", dev)
        scal = ix = None
    sfc = torch.empty((len(SURFACE_FIELDS),) + grid, dtype=dt,
                      device=dev) if do_couple else None
    fx = torch.empty((len(FLUX_FIELDS),) + grid, dtype=dt,
                     device=dev) if window is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()
    ptrs = (ctypes.c_void_p * len(INPUTS))(*[ptr(ins[k]) for k in INPUTS])
    op = (ctypes.c_int * len(OPTIONS))(*[opts[k] for k in OPTIONS])
    code = kb.library().slab_couple_launch(
        kb.device_index(bd.sst12), int(dt == torch.float64),
        grid[0] * grid[1], ptrs, ptr(sfc), ptr(fx), scal, ix, float(w_an),
        op, ptr(scalars), kb.stream_of(bd.sst12))
    kb.check(code, "slab_couple")
    slab_couple.launches += 1
    slab_couple.dev_launches += scalars is not None
    return sfc, fx


slab_couple.launches = 0
slab_couple.dev_launches = 0   # of them, the device-scalar form's

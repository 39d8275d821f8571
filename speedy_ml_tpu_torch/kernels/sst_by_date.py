"""K23: the day's SST of a daily climatology table with the bias ramp
(csrc/sst_by_date.cu) and its plain version.

The JAX package's HybridAtmosphere.sst_by_date (hybrid/model.py:546-553,
get_sst_by_date, mpires.f90:1679-1725) takes day (hour_of_year // 24) %
365 of a (365, lat, lon) table and adds the non-stationary-climate bias
over open water: where(sst > 273, sst + bias, sst), the bias cast to the
table's dtype.  With an SST table, an hour of the year and no slab ocean,
its cycle replaces the state's SST grid with that plane before anything
reads it (:590-596).  One launch writes the plane; the day and the bias
are host numbers, kernel arguments, or in the device-scalar form (dev=),
which a captured CUDA graph of the cycle replays (hybrid/graph.py), two
doubles on the card.

On a CPU tensor `sst_by_date` runs `sst_by_date_plain`; on a CUDA tensor
it launches the kernel (float32 or float64) or raises.
"""

from __future__ import annotations

import torch

from speedy_ml_tpu_torch.kernels import build as kb

T_OPEN = 273.0   # K: the bias applies above it (open water)


def table_day(hour_of_year: int, n_days: int) -> int:
    """The table row of an hour into the 365-day year."""
    return (int(hour_of_year) // 24) % n_days


def sst_by_date_plain(table: torch.Tensor, day: int, bias) -> torch.Tensor:
    """The plain PyTorch version: (lat, lon)."""
    sst = table[day]
    b = torch.tensor(float(bias), dtype=table.dtype, device=table.device)
    return torch.where(sst > T_OPEN, sst + b, sst)


def sst_by_date(table: torch.Tensor, day: int, bias,
                dev=None) -> torch.Tensor:
    """table: (n_days, lat, lon) float32 or float64, contiguous; day: a host
    int in [0, n_days); bias: a host number (K).  Returns the day's SST
    plane (lat, lon) with the bias over open water, a tensor of its own.
    dev: None, or the device-scalar form's [day, bias] as a float64 tensor
    on the table's device, read in place of day and bias (on the card a
    day outside the table gives NaN)."""
    if table.dim() != 3:
        raise ValueError(f"sst_by_date: table {tuple(table.shape)}, expected "
                         "(n_days, lat, lon)")
    if dev is not None and table.device.type == "cpu":
        day, bias = int(dev[0]), float(dev[1])
    day = int(day)
    if not 0 <= day < table.shape[0]:
        raise ValueError(f"sst_by_date: day {day} outside the table's "
                         f"{table.shape[0]} days")
    device = table.device
    if device.type == "cpu":
        return sst_by_date_plain(table, day, bias)
    if device.type != "cuda":
        raise ValueError(f"sst_by_date: no kernel for device {device}")
    dt = table.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"sst_by_date: dtype {dt}, the kernel takes float32 "
                        "or float64")
    kb.require(table, "table", dt, None, device)
    n_days, nlat, nlon = table.shape
    out = torch.empty((nlat, nlon), dtype=dt, device=device)
    dev_ptr = None
    if dev is not None:
        kb.require(dev, "dev", torch.float64, (2,), device)
        dev_ptr = dev.data_ptr()
    code = kb.library().sst_by_date_launch(
        kb.device_index(table), int(dt == torch.float64), table.data_ptr(),
        n_days, day, nlat * nlon, float(bias), dev_ptr, out.data_ptr(),
        kb.stream_of(table))
    kb.check(code, "sst_by_date")
    sst_by_date.launches += 1
    sst_by_date.dev_launches += dev is not None
    return out


sst_by_date.launches = 0
sst_by_date.dev_launches = 0   # of them, the device-scalar form's

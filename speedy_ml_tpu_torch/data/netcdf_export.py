"""NetCDF export shim for prediction streams (VERDICT r3 #7).

The reference writes its hybrid prediction files as NetCDF with
dimensions Timestep/Sigma_Level/Lat/Lon and variables Temperature
[Kelvin], U-wind / V-wind [m/s], Specific-Humidity [g/kg], logp
[log(surfacepressure)], p6hr [mm of rain] and SST [Kelvin]
(write_netcdf_4d_multi_2d, mod_io.f90:138-480), which its analysis
scripts then open with xarray (scripts/hybrid_climo.py:64).

This module converts a PredictionWriter .npz stream into that exact
layout so the reference tooling can consume our output.  The file is
NetCDF-3 classic written via scipy.io.netcdf_file (netCDF4/xarray are
not in this image; NetCDF-3 is readable by both).
"""

from __future__ import annotations

import numpy as np


def export_prediction_netcdf(pred, path: str, *, lat=None, lon=None,
                             sigma=None, precip_epsilon: float = 0.001,
                             precip_already_physical: bool = True):
    """Write a prediction stream in the reference's NetCDF layout.

    pred: dict (or .npz path) with atmo (T, 4, K, lat, lon) ordered
    [T, u, v, q], logp (T, lat, lon), optional precip (T, lat, lon)
    [mm/s physical rate] and sst (T, lat, lon).

    The reference file stores 6-h accumulated precip recovered from the
    log transform (mod_io.f90:433-470); our stream already carries the
    physical rate, so by default it is written as the 6-h accumulation
    rate * 21600 s.  Set precip_already_physical=False if the stream
    holds log-transformed precip to apply eps*(e**x - 1) first.
    """
    from scipy.io import netcdf_file

    if isinstance(pred, (str, bytes)):
        z = np.load(pred)
        pred = {k: z[k] for k in z.files}

    atmo = np.asarray(pred["atmo"], dtype=np.float32)
    logp = np.asarray(pred["logp"], dtype=np.float32)
    T_, V, K, ny, nx = atmo.shape
    if lat is None or lon is None or sigma is None:
        from speedy_ml_tpu_torch.core.geometry import Geometry
        g = Geometry(nlon=nx, nlat=ny, nlev=K,
                     trunc=30 if (nx, ny) == (96, 48) else max(nx // 3 - 1, 4))
        lat = np.rad2deg(g.lat_radians) if lat is None else lat
        lon = (np.arange(nx) * 360.0 / nx) if lon is None else lon
        sigma = np.asarray(g.full_sigma) if sigma is None else sigma

    f = netcdf_file(path, "w")
    try:
        # scipy's NetCDF-3 writer requires the record dimension first
        f.createDimension("Timestep", None)
        f.createDimension("Lon", nx)
        f.createDimension("Lat", ny)
        f.createDimension("Sigma_Level", K)

        vlon = f.createVariable("Lon", np.float32, ("Lon",))
        vlat = f.createVariable("Lat", np.float32, ("Lat",))
        vsig = f.createVariable("Sigma_Level", np.float32, ("Sigma_Level",))
        # the reference swaps these unit strings (mod_io.f90:102-103);
        # keep the conventional assignment here
        vlon.units = b"degrees_east"
        vlat.units = b"degrees_north"
        vlon[:] = np.asarray(lon, dtype=np.float32)
        vlat[:] = np.asarray(lat, dtype=np.float32)
        vsig[:] = np.asarray(sigma, dtype=np.float32)

        dims4 = ("Timestep", "Sigma_Level", "Lat", "Lon")
        dims3 = ("Timestep", "Lat", "Lon")
        for i, (name, units) in enumerate(
                (("Temperature", b"Kelvin"), ("U-wind", b"m/s"),
                 ("V-wind", b"m/s"), ("Specific-Humidity", b"g/kg"))):
            v = f.createVariable(name, np.float32, dims4)
            v.units = units
            v[:] = atmo[:, i]
        v = f.createVariable("logp", np.float32, dims3)
        v.units = b"log(surfacepressure)"
        v[:] = logp

        if "precip" in pred:
            p = np.asarray(pred["precip"], dtype=np.float32)
            if not precip_already_physical:
                p = precip_epsilon * (np.exp(p) - 1.0)
            else:
                p = p * 21600.0          # mm/s -> 6-h accumulation [mm]
            v = f.createVariable("p6hr", np.float32, dims3)
            v.units = b"mm of rain"
            v[:] = p
        if "sst" in pred:
            v = f.createVariable("SST", np.float32, dims3)
            v.units = b"Kelvin"
            v[:] = np.asarray(pred["sst"], dtype=np.float32)
    finally:
        f.close()
    return path

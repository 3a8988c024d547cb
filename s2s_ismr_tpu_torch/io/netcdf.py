"""NetCDF classic read/write for Field objects.

The port's own copy of s2s_ismr_tpu/io/netcdf.py (numpy and scipy only),
so the port imports nothing of the JAX package.

The reference persists every result as netcdf through xarray
(tune_ECMWF_com.py:64-65,119-121) and reads IRIDL 'data.nc' downloads
(dataloader.py:143-148). Neither xarray nor netCDF4 exist in this image,
so the framework carries its own thin codec on scipy's netcdf3 engine,
with the same filesystem conventions (outputs/**/{ELR,unet}_rpss_*.nc) so
downstream aggregation (Bar_plot-style) keeps working.

Time coordinates are stored CF-style as 'days since 1970-01-01'.
"""

from __future__ import annotations

import os

import numpy as np
from scipy.io import netcdf_file

from ..field import Field

_EPOCH = np.datetime64("1970-01-01", "ns")
_DAY_NS = np.timedelta64(1, "D").astype("timedelta64[ns]")


def _encode_coord(name, values):
    values = np.asarray(values)
    if np.issubdtype(values.dtype, np.datetime64):
        days = (values.astype("datetime64[ns]") - _EPOCH) / _DAY_NS
        return days.astype(np.float64), {"units": "days since 1970-01-01",
                                         "calendar": "standard"}
    if values.dtype.kind in "OU":   # string coords (e.g. category labels)
        return np.arange(len(values), dtype=np.int32), \
            {"labels": ",".join(str(v) for v in values)}
    return values.astype(np.float64), {}


def _decode_coord(var):
    data = np.array(var[:]).copy()
    units = getattr(var, "units", b"")
    units = units.decode() if isinstance(units, bytes) else units
    labels = getattr(var, "labels", b"")
    labels = labels.decode() if isinstance(labels, bytes) else labels
    if units.startswith("days since 1970"):
        return _EPOCH + (data * 86400e9).astype("timedelta64[ns]")
    if labels:
        return np.array(labels.split(","))
    return data


def write_netcdf(field: Field, path, var_name=None):
    """Write a Field (any rank) with its coordinate vectors."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    name = var_name or field.name or "data"
    with netcdf_file(path, "w") as f:
        for dim, size in field.sizes().items():
            f.createDimension(dim, size)
            if dim in field.coords:
                data, attrs = _encode_coord(dim, field.coords[dim])
                v = f.createVariable(dim, data.dtype, (dim,))
                v[:] = data
                for k, val in attrs.items():
                    setattr(v, k, val)
        v = f.createVariable(name, np.float32, field.dims)
        v[:] = field.values.astype(np.float32)
    return path


def read_netcdf(path, var_name=None) -> Field:
    """Read one data variable (the first non-coordinate one by default)."""
    with netcdf_file(path, "r", mmap=False) as f:
        dims_set = set(f.dimensions)
        candidates = [k for k, v in f.variables.items() if k not in dims_set]
        if var_name is None:
            if not candidates:
                raise ValueError(f"no data variables in {path}")
            var_name = candidates[0]
        var = f.variables[var_name]
        values = np.array(var[:]).copy()
        dims = var.dimensions
        coords = {}
        for d in dims:
            if d in f.variables:
                coords[d] = _decode_coord(f.variables[d])
        return Field(values, dims, coords, var_name)

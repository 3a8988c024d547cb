from .netcdf import read_netcdf, write_netcdf  # noqa: F401

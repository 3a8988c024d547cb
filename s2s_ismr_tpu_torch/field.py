"""Lightweight labeled-array layer (host-side bookkeeping only).

The port's own copy of s2s_ismr_tpu/field.py (numpy only), so the port
imports nothing of the JAX package.

The reference keeps data in xarray DataArrays end to end
(the reference's utils/dataloader.py:298, preprocessing.py throughout).
Here the design is inverted: all *compute* happens on packed dense device
tensors (see data/bundle.py); ``Field`` only carries dimension names and
coordinate vectors across the host-side seams (netcdf in/out, plotting,
script-level assembly). It is deliberately tiny — not an xarray clone.

Conventions:
  * values: numpy ndarray
  * dims:   tuple of str, one per axis
  * coords: dict dim -> 1-D numpy array (optional per dim)
  * NaN encodes missing data, as in the reference.
"""

from __future__ import annotations

import numpy as np


class Field:
    __slots__ = ("values", "dims", "coords", "name")

    def __init__(self, values, dims, coords=None, name=None):
        values = np.asarray(values)
        dims = tuple(dims)
        if values.ndim != len(dims):
            raise ValueError(f"{values.ndim}-d values vs dims {dims}")
        coords = dict(coords or {})
        for d, c in coords.items():
            if d not in dims:
                raise ValueError(f"coord {d!r} not in dims {dims}")
            c = np.asarray(c)
            if c.ndim != 1 or c.shape[0] != values.shape[dims.index(d)]:
                raise ValueError(
                    f"coord {d!r} length {c.shape} mismatches axis "
                    f"{values.shape[dims.index(d)]}"
                )
            coords[d] = c
        self.values = values
        self.dims = dims
        self.coords = coords
        self.name = name

    # -- introspection -------------------------------------------------
    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self):
        return self.values.ndim

    def axis(self, dim):
        return self.dims.index(dim)

    def sizes(self):
        return dict(zip(self.dims, self.values.shape))

    def __repr__(self):
        dims = ", ".join(f"{d}={n}" for d, n in self.sizes().items())
        return f"Field({self.name or ''}; {dims}; dtype={self.values.dtype})"

    # -- construction helpers ------------------------------------------
    def _like(self, values, dims=None, coords=None):
        return Field(values, self.dims if dims is None else dims,
                     self.coords if coords is None else coords, self.name)

    def copy(self):
        return Field(self.values.copy(), self.dims, dict(self.coords), self.name)

    def with_coord(self, dim, coord):
        c = dict(self.coords)
        c[dim] = np.asarray(coord)
        return Field(self.values, self.dims, c, self.name)

    def rename(self, name):
        return Field(self.values, self.dims, self.coords, name)

    # -- indexing --------------------------------------------------------
    def isel(self, **indexers):
        """Integer/array/slice selection along named dims."""
        idx = [slice(None)] * self.ndim
        for d, sel in indexers.items():
            idx[self.axis(d)] = sel
        values = self.values[tuple(idx)]
        new_dims, new_coords = [], {}
        for d in self.dims:
            sel = indexers.get(d, slice(None))
            if np.isscalar(sel) or (isinstance(sel, np.ndarray) and sel.ndim == 0):
                continue  # dim dropped
            new_dims.append(d)
            if d in self.coords:
                new_coords[d] = np.asarray(self.coords[d])[sel]
        return Field(values, new_dims, new_coords, self.name)

    # -- transforms ------------------------------------------------------
    def transpose(self, *dims):
        perm = [self.axis(d) for d in dims]
        return Field(self.values.transpose(perm), dims, self.coords, self.name)

    def mean(self, dim=None, skipna=True):
        if dim is None:
            f = np.nanmean if skipna else np.mean
            return float(f(self.values))
        ax = self.axis(dim)
        f = np.nanmean if skipna else np.mean
        vals = f(self.values, axis=ax)
        dims = self.dims[:ax] + self.dims[ax + 1:]
        coords = {d: c for d, c in self.coords.items() if d != dim}
        return Field(vals, dims, coords, self.name)

    def fillna(self, value):
        return self._like(np.nan_to_num(self.values, nan=value))

    def where(self, mask, other=np.nan):
        """mask: boolean ndarray broadcastable against values; keep where True."""
        m = mask.values if isinstance(mask, Field) else np.asarray(mask)
        return self._like(np.where(m, self.values, other))

    def pad_dim(self, dim, after, fill=0.0, coord_fill=None):
        """Pad `after` slots at the end of `dim` (reference pads ECMWF full-period
        Y 23->24 with a synthetic 40.5 latitude row, tune_ECMWF_full.py:50-57)."""
        ax = self.axis(dim)
        widths = [(0, 0)] * self.ndim
        widths[ax] = (0, after)
        vals = np.pad(self.values, widths, constant_values=fill)
        coords = dict(self.coords)
        if dim in coords:
            c = np.asarray(coords[dim], dtype=float)
            extra = (np.full(after, coord_fill, dtype=float) if coord_fill is not None
                     else np.full(after, np.nan))
            coords[dim] = np.concatenate([c, extra])
        return Field(vals, self.dims, coords, self.name)


def concat(fields, dim, coord=None):
    """Concatenate along an existing or new leading dim."""
    first = fields[0]
    if dim in first.dims:
        ax = first.axis(dim)
        vals = np.concatenate([f.values for f in fields], axis=ax)
        coords = dict(first.coords)
        if all(dim in f.coords for f in fields):
            coords[dim] = np.concatenate([np.asarray(f.coords[dim]) for f in fields])
        else:
            coords.pop(dim, None)
        if coord is not None:
            coords[dim] = np.asarray(coord)
        return Field(vals, first.dims, coords, first.name)
    vals = np.stack([f.values for f in fields], axis=0)
    dims = (dim,) + first.dims
    coords = dict(first.coords)
    if coord is not None:
        coords[dim] = np.asarray(coord)
    return Field(vals, dims, coords, first.name)


def stack_mean(fields, dim="bootstrap"):
    """Bootstrap-mean used by the reference's map plots (plots.py:403-404)."""
    return concat(fields, dim).mean(dim)

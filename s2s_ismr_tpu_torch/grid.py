"""Grid geometry: domains, divisibility, padding.

The port's own copy of s2s_ismr_tpu/grid.py (numpy only), so the port
imports nothing of the JAX package.

The reference hardcodes (West, East, South, North) domain boxes per script
and relies on a comment that "lat and lon make a square divisible by 8"
(tune_ECMWF_com.py:26). The ECMWF full-period grid is 23x24 and is padded
with a zero row at synthetic latitude 40.5 (tune_ECMWF_full.py:50-57).
Here that becomes an explicit GridSpec with checked/auto padding so every
model sees a 2^n_blocks-divisible canvas, and the pad row carries a mask.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Domain:
    """Geographic box, reference order W,E,S,N (tune_ECMWF_com.py:26)."""
    west: float
    east: float
    south: float
    north: float

    def as_tuple(self):
        return (self.west, self.east, self.south, self.north)


@dataclass
class GridSpec:
    """Lat/lon rasters + pooling-divisibility bookkeeping.

    lats/lons are the *data* coordinates (Y ascending not required);
    pad_y/pad_x give rows/cols of zero padding appended so (ny+pad_y,
    nx+pad_x) is divisible by 2**n_blocks.
    """
    lats: np.ndarray
    lons: np.ndarray
    pad_y: int = 0
    pad_x: int = 0
    pad_lat_value: float = np.nan

    @property
    def ny(self):
        return len(self.lats)

    @property
    def nx(self):
        return len(self.lons)

    @property
    def padded_ny(self):
        return self.ny + self.pad_y

    @property
    def padded_nx(self):
        return self.nx + self.pad_x

    def padded_lats(self):
        if self.pad_y == 0:
            return np.asarray(self.lats, dtype=float)
        extra = np.full(self.pad_y, self.pad_lat_value, dtype=float)
        return np.concatenate([np.asarray(self.lats, dtype=float), extra])

    def padded_lons(self):
        if self.pad_x == 0:
            return np.asarray(self.lons, dtype=float)
        step = self.lons[1] - self.lons[0] if len(self.lons) > 1 else 1.0
        extra = self.lons[-1] + step * np.arange(1, self.pad_x + 1)
        return np.concatenate([np.asarray(self.lons, dtype=float), extra])

    def valid_mask(self):
        """(padded_ny, padded_nx) bool — False on synthetic pad rows/cols."""
        m = np.zeros((self.padded_ny, self.padded_nx), dtype=bool)
        m[: self.ny, : self.nx] = True
        return m


def divisible_by(n, blocks):
    return n % (2 ** blocks) == 0


def check_divisible(ny, nx, n_blocks):
    d = 2 ** n_blocks
    if ny % d or nx % d:
        raise ValueError(
            f"grid {ny}x{nx} not divisible by 2^{n_blocks}={d}; pad first "
            f"(reference requirement, tune_ECMWF_com.py:26)")


def make_grid(lats, lons, n_blocks_max=3, pad_lat_value=None):
    """Build a GridSpec, auto-padding to the next multiple of
    2**n_blocks_max the way tune_ECMWF_full.py:50-57 pads 23->24 rows."""
    lats = np.asarray(lats, dtype=float)
    lons = np.asarray(lons, dtype=float)
    d = 2 ** n_blocks_max
    pad_y = (-len(lats)) % d
    pad_x = (-len(lons)) % d
    if pad_lat_value is None:
        step = lats[1] - lats[0] if len(lats) > 1 else 1.0
        pad_lat_value = float(lats[-1] + step) if pad_y else np.nan
    return GridSpec(lats, lons, pad_y=pad_y, pad_x=pad_x,
                    pad_lat_value=pad_lat_value)


def regular_grid(domain: Domain, step: float):
    """1-deg (or `step`) raster covering the closed domain box; mirrors the
    IRIDL GRID/RANGE expressions used with regrid=1 (dataloader.py:41-51)."""
    lats = np.arange(domain.south, domain.north + step / 2, step)
    lons = np.arange(domain.west, domain.east + step / 2, step)
    return lats, lons


def fixed_grid(domain: Domain, n_lat: int, n_lon: int):
    """Grid with exact point counts spanning the domain box — stands in for
    a model's NATIVE grid in synthetic runs, where the point count (not the
    spacing) is what the pipeline depends on (e.g. ECMWF full-period native
    23 rows padded to 24, tune_ECMWF_full.py:50-57; IITM 0.5-deg 64x64,
    tune_IITM_full.py)."""
    return (np.linspace(domain.south, domain.north, n_lat),
            np.linspace(domain.west, domain.east, n_lon))

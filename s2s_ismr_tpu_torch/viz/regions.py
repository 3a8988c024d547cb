"""Pure-python ESRI shapefile reader + polygon rasterizer.

The port's own copy of s2s_ismr_tpu/viz/regions.py (numpy and struct
only), so the port imports nothing of the JAX package.

Bar_plot.ipynb (cells 12-13, 18) rasterizes the met-subdivision boundary
shapefile into homogeneous-climate-region masks with rasterio/geopandas;
neither exists in this image, so the framework reads .shp polygons itself
(the format is a simple well-documented binary layout) and rasterizes via
vectorized even-odd ray casting on grid-cell centers.

Works with any polygon/polyline shapefile, e.g. the reference's
shapes/indian_borders.shp and shapes/sd_boundary.shp assets.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List

import numpy as np

SHAPE_NULL, SHAPE_POLYLINE, SHAPE_POLYGON = 0, 3, 5


@dataclass
class Shape:
    shape_type: int
    rings: List[np.ndarray]        # each (n, 2) of (lon, lat)

    @property
    def bbox(self):
        pts = np.concatenate(self.rings)
        return pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max()


def read_shapefile(path) -> List[Shape]:
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack(">i", data[:4])[0] != 9994:
        raise ValueError(f"{path}: not a shapefile (bad magic)")
    shapes = []
    off = 100                                     # header is 100 bytes
    n = len(data)
    while off + 8 <= n:
        (_recno, content_len) = struct.unpack(">ii", data[off:off + 8])
        off += 8
        rec_end = off + content_len * 2
        stype = struct.unpack("<i", data[off:off + 4])[0]
        if stype in (SHAPE_POLYGON, SHAPE_POLYLINE):
            num_parts, num_points = struct.unpack("<ii", data[off + 36:off + 44])
            parts = np.frombuffer(data, "<i4", num_parts, off + 44)
            pts = np.frombuffer(data, "<f8", num_points * 2,
                                off + 44 + 4 * num_parts).reshape(-1, 2)
            bounds = list(parts) + [num_points]
            rings = [pts[bounds[i]:bounds[i + 1]].copy()
                     for i in range(num_parts)]
            shapes.append(Shape(stype, rings))
        off = rec_end
    return shapes


def points_in_ring(lon, lat, ring):
    """Vectorized even-odd rule. lon/lat: arrays of query points;
    ring: (n,2) closed or open polygon ring."""
    x = np.asarray(lon, float).ravel()
    y = np.asarray(lat, float).ravel()
    rx, ry = ring[:, 0], ring[:, 1]
    rx2, ry2 = np.roll(rx, -1), np.roll(ry, -1)
    inside = np.zeros(x.shape, bool)
    for x1, y1, x2, y2 in zip(rx, ry, rx2, ry2):
        cond = ((y1 > y) != (y2 > y))
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = x1 + (y - y1) * (x2 - x1) / (y2 - y1)
        inside ^= cond & (x < xint)
    return inside.reshape(np.asarray(lon).shape)


def rasterize(shapes, lats, lons) -> np.ndarray:
    """(len(shapes), ny, nx) bool: cell-center-inside masks, the equivalent
    of rasterio geometry_mask(invert=True) per polygon."""
    glon, glat = np.meshgrid(lons, lats)
    out = np.zeros((len(shapes), len(lats), len(lons)), bool)
    for i, s in enumerate(shapes):
        acc = np.zeros(glon.shape, bool)
        for ring in s.rings:
            acc ^= points_in_ring(glon, glat, ring)   # holes via even-odd
        out[i] = acc
    return out


def region_masks(shapefile_path, lats, lons):
    """Region masks for per-region skill aggregation (Bar_plot.ipynb cell
    13's South Peninsula / East-NE / North West / Central analysis)."""
    shapes = [s for s in read_shapefile(shapefile_path)
              if s.shape_type == SHAPE_POLYGON]
    return rasterize(shapes, lats, lons)


def read_dbf_records(path) -> List[dict]:
    """Minimal dBASE III reader for shapefile .dbf sidecars — the region
    attribute table geopandas reads in Bar_plot.ipynb cell 12 (names of
    the met subdivisions). Character/numeric fields only; values returned
    as stripped strings."""
    with open(path, "rb") as f:
        data = f.read()
    n_records = struct.unpack("<i", data[4:8])[0]
    header_len, record_len = struct.unpack("<hh", data[8:12])
    fields = []
    off = 32
    while off < header_len - 1 and data[off] != 0x0D:
        name = data[off:off + 11].split(b"\x00")[0].decode("ascii",
                                                           "replace")
        length = data[off + 16]
        fields.append((name, length))
        off += 32
    out = []
    off = header_len
    for _ in range(n_records):
        if off + record_len > len(data):
            break
        rec, pos = {}, off + 1            # first byte = deletion flag
        deleted = data[off:off + 1] == b"*"
        for name, length in fields:
            raw = data[pos:pos + length]
            rec[name] = raw.decode("latin-1", "replace").strip()
            pos += length
        if not deleted:
            out.append(rec)
        off += record_len
    return out


def region_names_from_dbf(shapefile_path, name_fields=("REGION", "NAME",
                                                       "SUBDIV", "ST_NM")):
    """Best-effort region labels from the .dbf next to a .shp (or from a
    .dbf path directly). Returns None when no sidecar/name field exists —
    callers fall back to region{i}."""
    import os
    base, _ = os.path.splitext(shapefile_path)
    dbf = base + ".dbf"
    if not os.path.exists(dbf):
        return None
    try:
        records = read_dbf_records(dbf)
    except Exception:
        return None
    if not records:
        return None
    keys = list(records[0])
    field = next((f for f in name_fields if f in keys),
                 next((k for k in keys if records[0][k] and
                       not records[0][k].replace(".", "").replace(
                           "-", "").isdigit()), None))
    if field is None:
        return None
    return [r.get(field, "") or f"region{i}"
            for i, r in enumerate(records)]

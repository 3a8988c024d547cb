"""Map helpers of the realtime figures (port of the parts of
s2s_ismr_tpu/viz/maps.py that `pipelines.realtime.render_figures` uses).

The boundary shapefiles (the reference's shapes/ assets: indian_borders.shp
and sd_boundary.shp, overlaid on every map, plots.py:417-420) are read by
the pure-python reader in viz/regions.py; whatever exists is drawn. This
module imports no matplotlib. The RPSS, climatology and skill-map plots of
the JAX module come with the reporting slice (ROADMAP queue A item 15).
"""

from __future__ import annotations

import os


def default_shapes_dir(out_root="."):
    """Boundary-shapefile directory resolution: the S2S_SHAPES_DIR
    environment override, then a shapes/ dir next to the outputs (the
    reference layout); None when neither exists."""
    for cand in (os.environ.get("S2S_SHAPES_DIR"),
                 os.path.join(out_root, "shapes")):
        if cand and os.path.isdir(cand):
            return cand
    return None


def _boundary_segments(shapes_dir):
    if not shapes_dir:
        return []
    segs = []
    try:
        from .regions import read_shapefile
        for name in ("indian_borders.shp", "sd_boundary.shp"):
            p = os.path.join(shapes_dir, name)
            if os.path.exists(p):
                for poly in read_shapefile(p):
                    segs.extend(poly.rings)
    except Exception:
        pass
    return segs

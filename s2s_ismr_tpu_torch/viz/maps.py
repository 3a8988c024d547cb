"""RPSS, climatology and CC/ACC map panels (port of
s2s_ismr_tpu/viz/maps.py; the reference's plots.py:394-555, cartopy-free).

The reference draws bootstrap-mean RPSS maps on a PlateCarree projection
with India border shapefiles and mean/max/min in bold panel titles. Here
panels are plain lat/lon pcolormesh; the boundary shapefiles (the
reference's shapes/ assets: indian_borders.shp and sd_boundary.shp,
plots.py:417-420) overlay when a shapes/ directory is found, read by the
pure-python reader in viz/regions.py.

The module imports no matplotlib: each drawing function imports it inside
the call, so the rest (the levels, the shapes directory) works on a
machine without it.
"""

from __future__ import annotations

import os

import numpy as np


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


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at the call."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_rpss_panels(panels, lats, lons, outdir, fname, mask=None,
                     vmin=-0.2, vmax=0.2, cmap="bwr", shapes_dir=None,
                     dpi=150):
    """panels: dict title -> Field (bootstrap, Y, X). Draws the bootstrap
    mean per panel with the reference's mean/max/min title convention
    (plots.py:440-441,526-528). Returns {fname: path}."""
    plt = _pyplot()
    os.makedirs(outdir, exist_ok=True)
    n = len(panels)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 4), squeeze=False)
    segs = _boundary_segments(shapes_dir)
    for ax, (title, fld) in zip(axes[0], panels.items()):
        m = fld.mean("bootstrap") if "bootstrap" in fld.dims else fld
        vals = m.values
        if mask is not None:
            vals = np.where(mask, np.nan, vals)
        pm = ax.pcolormesh(lons, lats, vals, vmin=vmin, vmax=vmax, cmap=cmap,
                           shading="nearest")
        for ring in segs:
            ax.plot(ring[:, 0], ring[:, 1], color="k", lw=0.5)
        with np.errstate(all="ignore"):
            ax.set_title(f"{title}:\n mean:{np.nanmean(vals):.2f}, "
                         f"max:{np.nanmax(vals):.2f}, "
                         f"min: {np.nanmin(vals):.2f}",
                         fontweight="bold", fontsize=10)
        ax.set_xlabel("Longitude")
        ax.set_ylabel("Latitude")
        fig.colorbar(pm, ax=ax, shrink=0.8)
    fig.tight_layout()
    path = os.path.join(outdir, f"{fname}.png")
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return {fname: path}


def plot_climatology(values, lats, lons, path, vmin=0.0, vmax=18.0,
                     dpi=150):
    """mm/day climatology map (ACCs.ipynb cells 10-11/23/36): light-gray
    base blending into reversed rainbow, proportional colorbar with the
    notebook's tick set, dashed grid."""
    plt = _pyplot()
    from matplotlib.colors import ListedColormap
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n_colors = 256
    rainbow = plt.get_cmap("rainbow_r", n_colors)
    gray_to_rainbow = np.vstack(
        (np.ones((20, 4)) * 0.9, rainbow(np.linspace(0, 1, n_colors - 20))))
    cmap = ListedColormap(gray_to_rainbow)
    fig, ax = plt.subplots(figsize=(5, 4))
    pm = ax.pcolormesh(lons, lats, values, vmin=vmin, vmax=vmax, cmap=cmap,
                       shading="nearest")
    fig.colorbar(pm, ax=ax, label="mm/day", spacing="proportional",
                 format="%.0f", ticks=[0, 1, 3, 5, 7, 9, 11, 15, 18])
    ax.set_xlabel("Longitude", fontsize=11)
    ax.set_ylabel("Latitude", fontsize=11)
    ax.tick_params(labelsize=10)
    ax.grid(True, linestyle="--", linewidth=0.5, alpha=0.7)
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return path


# the notebook's discrete contour levels (ACCs.ipynb cells 13/25/38):
# CC maps span +-0.6, ACC maps +-0.5, both at 0.1 steps with the color
# range pinned to +-0.4
CC_LEVELS = tuple(np.round(np.arange(-0.6, 0.61, 0.1), 1))
ACC_LEVELS = tuple(np.round(np.arange(-0.5, 0.51, 0.1), 1))


def plot_skill_map(values, lats, lons, path, title="", levels=None,
                   vmin=-0.4, vmax=0.4, cmap="RdBu_r", dpi=300):
    """Single CC/ACC map, styled as ACCs.ipynb cells 13/25/38: discrete
    0.1-wide color bins over the given levels (CC_LEVELS / ACC_LEVELS),
    RdBu_r pinned to +-0.4, tight bbox. The notebook exports these as
    PDFs at dpi 300; pass a .pdf path for the same artifact."""
    plt = _pyplot()
    from matplotlib.colors import BoundaryNorm, ListedColormap
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 4))
    if levels is not None:
        # reproduce contourf(levels=..., vmin=..., vmax=...): colors are
        # sampled from the cmap over [vmin, vmax] per 0.1 bin
        lv = np.asarray(levels, float)
        cmap_o = plt.get_cmap(cmap)
        centers = (lv[:-1] + lv[1:]) / 2
        colors = cmap_o(np.clip((centers - vmin) / (vmax - vmin), 0, 1))
        pm = ax.pcolormesh(lons, lats, values, cmap=ListedColormap(colors),
                           norm=BoundaryNorm(lv, len(colors)),
                           shading="nearest")
    else:
        pm = ax.pcolormesh(lons, lats, values, vmin=vmin, vmax=vmax,
                           cmap=cmap, shading="nearest")
    ax.set_title(title)
    fig.colorbar(pm, ax=ax, shrink=0.8)
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return path

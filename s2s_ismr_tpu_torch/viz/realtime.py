"""Realtime-forecast figures: GradCAM overlays, p(above) maps, MJO/ENSO
composite panels.

The port's own copy of s2s_ismr_tpu/viz/realtime.py (numpy and
matplotlib). Each drawing function imports matplotlib inside the call, so
nothing else on the realtime path needs it.

The reference's Realtime_fcast_MME.ipynb (missing from its snapshot,
.MISSING_LARGE_BLOBS) delivered *maps* — "GradCAM maps and MJO/ENSO
diagnostics" per README.md:22 — in the repo's map style (plots.py:394-461:
pcolormesh panels, shapefile boundary overlays, bold stat titles). The
netcdfs pipelines/realtime.py writes are the data; these renderers are
the deliverable figures, written under figures/Realtime/.
"""

from __future__ import annotations

import os

import numpy as np

from .maps import _boundary_segments, _pyplot


def _panel_grid(n, ncols=4, panel=3.2):
    plt = _pyplot()
    ncols = max(1, min(ncols, n))
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(panel * ncols, panel * nrows),
                             squeeze=False, layout="constrained")
    flat = [ax for row in axes for ax in row]
    for ax in flat[n:]:
        ax.set_visible(False)
    for ax in flat[:n]:
        ax.label_outer()     # ticks only on outer panels: titles stay clear
    return fig, flat[:n]


def _draw_boundaries(ax, segs):
    for ring in segs:
        ax.plot(ring[:, 0], ring[:, 1], color="k", lw=0.5)


def plot_probability_maps(p_above, lats, lons, path, titles=None,
                          shapes_dir=None, dpi=150):
    """p(above-normal) forecast maps, one panel per init/valid date.
    p_above: (N, Y, X) in [0, 1]. BrBG (dry brown -> wet green) centered
    on the 1/3 climatological rate, mean probability in the bold title
    (plots.py title convention)."""
    p_above = np.asarray(p_above)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    segs = _boundary_segments(shapes_dir)
    fig, axes = _panel_grid(p_above.shape[0])
    pm = None
    for i, ax in enumerate(axes):
        pm = ax.pcolormesh(lons, lats, p_above[i], vmin=0.0, vmax=1.0,
                           cmap="BrBG", shading="nearest")
        _draw_boundaries(ax, segs)
        t = titles[i] if titles is not None else f"forecast {i}"
        with np.errstate(all="ignore"):
            ax.set_title(f"{t}\nmean p(above): "
                         f"{np.nanmean(p_above[i]):.2f}",
                         fontweight="bold", fontsize=9)
    fig.colorbar(pm, ax=[a for a in axes], shrink=0.8,
                 label="p(above normal)")
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    _pyplot().close(fig)
    return path


def plot_gradcam_overlays(p_above, cams, lats, lons, path, titles=None,
                          shapes_dir=None, dpi=150, cam_floor=0.25):
    """GradCAM attribution over the forecast probability field: the
    p(above) map in muted BrBG underneath, the per-date CAM (normalized
    to [0, 1], values under `cam_floor` fully transparent) as a hot
    overlay — where the winner network looked for each forecast."""
    p_above = np.asarray(p_above)
    cams = np.asarray(cams, float)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    segs = _boundary_segments(shapes_dir)
    fig, axes = _panel_grid(p_above.shape[0])
    cam_pm = None
    for i, ax in enumerate(axes):
        ax.pcolormesh(lons, lats, p_above[i], vmin=0.0, vmax=1.0,
                      cmap="BrBG", alpha=0.55, shading="nearest")
        c = cams[i]
        with np.errstate(all="ignore"):
            lo, hi = np.nanmin(c), np.nanmax(c)
        cn = (c - lo) / (hi - lo) if hi > lo else np.zeros_like(c)
        # alpha ramps with attribution strength; weak regions vanish so
        # the probability field stays readable
        alpha = np.clip((cn - cam_floor) / (1 - cam_floor), 0.0, 0.85)
        cam_pm = ax.pcolormesh(lons, lats, np.ma.masked_invalid(cn),
                               vmin=0.0, vmax=1.0, cmap="inferno",
                               alpha=alpha, shading="nearest")
        _draw_boundaries(ax, segs)
        t = titles[i] if titles is not None else f"forecast {i}"
        ax.set_title(f"{t}\nGradCAM over p(above)",
                     fontweight="bold", fontsize=9)
    fig.colorbar(cam_pm, ax=[a for a in axes], shrink=0.8,
                 label="GradCAM (normalized)")
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    _pyplot().close(fig)
    return path


_MJO_ORDER = [str(p) for p in range(1, 9)] + ["inactive", "unknown"]
_ENSO_ORDER = ["elnino", "neutral", "lanina", "unknown"]


def plot_composite_panels(composites, lats, lons, path, kind="mjo",
                          shapes_dir=None, dpi=150):
    """MJO-phase / ENSO-state composite panels of mean p(above), anomaly
    vs the 1/3 climatological rate (bwr, +-0.2 like the RPSS maps) so
    phase-conditional wet/dry signals read directly."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    order = _MJO_ORDER if kind == "mjo" else _ENSO_ORDER
    keys = [k for k in order if k in composites] + \
        sorted(k for k in composites if k not in order)
    if not keys:
        raise ValueError(f"no {kind} composites to plot")
    segs = _boundary_segments(shapes_dir)
    fig, axes = _panel_grid(len(keys))
    pm = None
    for ax, k in zip(axes, keys):
        anom = np.asarray(composites[k], float) - 1.0 / 3.0
        pm = ax.pcolormesh(lons, lats, anom, vmin=-0.2, vmax=0.2,
                           cmap="bwr", shading="nearest")
        _draw_boundaries(ax, segs)
        label = f"MJO phase {k}" if kind == "mjo" and k.isdigit() else k
        with np.errstate(all="ignore"):
            ax.set_title(f"{label}\nmean: {np.nanmean(anom):+.2f}",
                         fontweight="bold", fontsize=9)
    fig.colorbar(pm, ax=[a for a in axes], shrink=0.8,
                 label="p(above) - 1/3")
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    _pyplot().close(fig)
    return path

"""Reliability diagrams (port of s2s_ismr_tpu/viz/reliability.py; the
reference's plots.py:141-390).

Calibration curves with normalized forecast histograms, the tercile
no-skill / no-resolution shading, and BSS/REL/RES annotations, single
model and NN-vs-ELR comparison variants. The annotated scores come from
the port's metrics on the run's device (`device=None`: the card), so
figures and logs agree; the drawn curves use the float64 numpy binning
below. matplotlib is imported inside the drawing calls only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import device as devices
from ..ops import metrics
from .maps import _pyplot

CATEGORIES = ("below", "normal", "above")
_NN_COLOR, _ELR_COLOR = "#008080", "#FF1493"


def _bin_stats(y_pred, t, num_bins=10, bin_minimum_pct=0.01):
    p = np.asarray(y_pred, float).ravel() * 0.9999999999999
    y = np.asarray(t, float).ravel()
    ok = ~np.isnan(p + y)
    p, y = p[ok], y[ok]
    total = max(len(p), 1)
    centers, avg_p, obs_f, counts = [], [], [], []
    for i in range(num_bins):
        m = (p >= i / num_bins) & (p < (i + 1) / num_bins)
        c = int(m.sum())
        if c / total >= bin_minimum_pct and c > 0:
            centers.append((i + 0.5) / num_bins)
            avg_p.append(p[m].mean())
            obs_f.append(y[m].mean())
            counts.append(c / total)
    return (np.array(centers), np.array(avg_p), np.array(obs_f),
            np.array(counts))


def _tercile_skill_area(ax):
    from matplotlib.patches import Polygon
    ur = Polygon([[1 / 3, 1 / 3], [1 / 3, 1], [1, 1], [1, (1 + 1 / 3) / 2]],
                 facecolor="gray", alpha=0.25)
    bl = Polygon([[1 / 3, 1 / 3], [1 / 3, 0], [0, 0], [0, 1 / 6]],
                 facecolor="gray", alpha=0.25)
    ax.add_patch(ur)
    ax.add_patch(bl)
    ax.plot([0, 1], [1 / 3, 1 / 3], lw=0.5, ls="dotted")
    ax.plot([0, 1], [1 / 6, (1 + 1 / 3) / 2], lw=0.5, ls="dotted")
    ax.plot([1 / 3, 1 / 3], [0, 1], lw=0.5, ls="dotted")
    ax.text(0.66, 0.28, "No Resolution", fontsize=8)
    ax.text(0.66, 0.45, "No Skill", fontsize=8, rotation=20)


def _scores(pred, t, device=None):
    """(BSS, REL, RES) of one category by the port's metrics on `device`."""
    device = devices.resolve(device)
    ok = ~np.isnan(np.asarray(pred, float) + np.asarray(t, float))
    args = [torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (pred, t, ok)]
    return (float(metrics.brier_skill_score(*args)),
            float(metrics.reliability_score(*args)),
            float(metrics.resolution_score(*args)))


def reliability_diagram(y_pred, t, path, title=None, dpi=150, device=None):
    """Single-model diagram (plots.py:141-249)."""
    plt = _pyplot()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots()
    _tercile_skill_area(ax)
    c, _, f, n = _bin_stats(y_pred, t)
    ax.plot(c, f, marker="o", color="red", label="Observed Frequency")
    ax.plot([0, 1], [0, 1], ls="--", color="blue", label="Perfect Reliability")
    ax.bar(c, n, width=0.1, color="violet", alpha=0.5, label="Normalized Counts")
    bss, rel, res = _scores(y_pred, t, device)
    ax.text(0.7, 0.11, f"BSS: {bss:.4f}")
    ax.text(0.7, 0.06, f"REL: {rel:.4f}")
    ax.text(0.7, 0.01, f"RES: {res:.4f}")
    ax.set_xlim(0, 1); ax.set_ylim(0, 1)
    ax.set_xlabel("Forecast Probability"); ax.set_ylabel("Observed Frequency")
    if title:
        ax.set_title(title)
    ax.legend(loc="upper left", fontsize=8)
    fig.savefig(path, dpi=dpi, transparent=True)
    plt.close(fig)
    return path


def reliability_compare(y_pred_nn, t_nn, y_pred_elr, t_elr, path,
                        title=None, dpi=150, device=None):
    """NN-vs-ELR comparison (plots.py:252-390)."""
    plt = _pyplot()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots()
    _tercile_skill_area(ax)
    for pred, t, color, label in [(y_pred_nn, t_nn, _NN_COLOR, "NN"),
                                  (y_pred_elr, t_elr, _ELR_COLOR, "ELR")]:
        c, _, f, n = _bin_stats(pred, t)
        ax.plot(c, f, marker="o", color=color, label=label)
        ax.bar(c, n, width=0.1, color=color, alpha=0.4)
    ax.plot([0, 1], [0, 1], ls="--", color="blue", label="Perfect Reliability")
    b1, r1, s1 = _scores(y_pred_nn, t_nn, device)
    b2, r2, s2 = _scores(y_pred_elr, t_elr, device)
    ax.text(0.72, 0.48, f"NN BSS: {b1:.4f}\nNN REL: {r1:.4f}\nNN RES: {s1:.4f}",
            va="top", transform=ax.transAxes, color=_NN_COLOR, fontsize=8)
    ax.text(0.72, 0.25, f"ELR BSS: {b2:.4f}\nELR REL: {r2:.4f}\n"
            f"ELR RES: {s2:.4f}", va="top", transform=ax.transAxes,
            color=_ELR_COLOR, fontsize=8)
    ax.set_xlim(0, 1); ax.set_ylim(0, 1)
    ax.set_xlabel("Forecast Probability"); ax.set_ylabel("Observed Frequency")
    if title:
        ax.set_title(title)
    ax.legend(loc="upper left", fontsize=8)
    fig.savefig(path, dpi=dpi, transparent=True)
    plt.close(fig)
    return path


def compare_categories(nn_res, elr_res, mask, cfg, figdir, device=None):
    """The three per-category NN-vs-ELR comparisons a tune script ends with
    (tune_ECMWF_com.py:140-181): test predictions concatenated across
    bootstraps, targets one-hot and skill-masked; scored on `device`."""
    from ..ops.terciles import one_hot_labels
    figures = {}
    F = nn_res.masks.n_folds

    def collect(preds, labels, masks_test, apply_mask):
        preds = torch.as_tensor(preds).cpu().numpy()
        ps, ts = [], []
        for f in range(F):
            sel = masks_test[f]
            p = preds[f][sel]
            t = one_hot_labels(torch.as_tensor(labels[f][sel])).numpy()
            if apply_mask:
                t = np.where(mask[None, :, :, None], np.nan, t)
            ps.append(p)
            ts.append(t)
        return np.concatenate(ps), np.concatenate(ts)

    p_nn, t_nn = collect(nn_res.predictions, nn_res.labels,
                         nn_res.masks.test, True)
    p_el, t_el = collect(elr_res.test_probs, elr_res.labels,
                         elr_res.masks.test, True)
    for k, catname in enumerate(("Below Normal", "Normal", "Above Normal")):
        title = f"{cfg.week}-{catname}"
        fname = title.replace("-", "_").replace(" ", "_") + ".pdf"
        path = os.path.join(figdir, fname)
        figures[fname] = reliability_compare(
            p_nn[..., k], t_nn[..., k], p_el[..., k], t_el[..., k],
            path, title=title, device=device)
    return figures

"""Rolling ISO-week tercile edges and labeling (port of
s2s_ismr_tpu/ops/terciles.py).

Reference semantics (rolling_labeler / rolling_labeler_ELR): per target ISO
week w, pool the observations whose week lies in the wrap-around window of
w; the tercile edges are the [1/3, 2/3] quantiles of the pool per pixel; a
sample of week v takes the edges of the nearest pooled week (ties go to the
larger week, as pandas' nearest does); label = 0 if y < q33, 2 if y > q66,
else 1, NaN where the edges are undefined.

All 53 weeks are computed in one batched sort instead of the JAX version's
`lax.map` over weeks. The sort holds (53, T, pixels) values and their int64
indices, so a long record is sorted a slice of pixels at a time (the
pixels are independent; the edges are the same bits either way).
"""

from __future__ import annotations

import torch

from ..timeutils import N_ISO_WEEKS
from .quantiles import masked_quantile

TERCILE_QS = (1.0 / 3.0, 2.0 / 3.0)
# elements of one pass of the (53, T, pixels) sort: 2**27 keeps a pass near
# 2.5 GB of device memory with the sort's indices. The 64x64 configs' T =
# 437 sorts all 4,096 pixels in one pass; the stacked predictor's 24 x 437
# rows take 17 passes of 241 pixels.
SORT_ELEMENTS = 1 << 27


def _weeks0(weeks, device):
    return torch.as_tensor(weeks, device=device).long() - 1


def rolling_edges(y, weeks, pool_mask, window_matrix):
    """Tercile edges per ISO week.

    y:             (T, *S) observations (NaN allowed)
    weeks:         (T,) ISO weeks 1..53
    pool_mask:     (T,) bool, the samples of the labeling pool
    window_matrix: (53, 53) bool, week w pools week v iff [w-1, v-1]

    Returns edges (53, 2, *S) float32 (NaN where a week has no pool) and
    present (53,) bool, the weeks with any pooled sample.
    """
    y = torch.as_tensor(y, dtype=torch.float32)
    dev = y.device
    weeks0 = _weeks0(weeks, dev)
    pool = torch.as_tensor(pool_mask, dtype=torch.bool, device=dev)
    wm = torch.as_tensor(window_matrix, dtype=torch.bool, device=dev)

    sel = wm[:, weeks0] & pool[None, :]                   # (53, T)
    present = torch.zeros(N_ISO_WEEKS, dtype=torch.bool, device=dev)
    present[weeks0[pool]] = True
    flat = y.reshape(y.shape[0], -1)[None]                # (1, T, P)
    step = max(1, SORT_ELEMENTS // (N_ISO_WEEKS * y.shape[0]))
    edges = torch.cat([masked_quantile(flat[..., i:i + step], sel[..., None],
                                       TERCILE_QS, axis=1)
                       for i in range(0, flat.shape[-1], step)], dim=-1)
    edges = edges.reshape(edges.shape[:2] + y.shape[1:])  # (2, 53, *S)
    return edges.movedim(0, 1), present                   # (53, 2, *S)


def nearest_present_week(present):
    """(53,) long: for each 0-based target week, the 0-based nearest week
    with present=True; ties prefer the LARGER week (pandas nearest)."""
    present = torch.as_tensor(present, dtype=torch.bool)
    w = torch.arange(N_ISO_WEEKS, device=present.device)
    dist = (w[:, None] - w[None, :]).abs()                # (target, cand)
    score = 2 * dist + (w[None, :] < w[:, None]).long()   # +1 if smaller
    score = torch.where(present[None, :], score,
                        torch.full_like(score, torch.iinfo(torch.int64).max))
    return torch.argmin(score, dim=1)


def _edges_for(weeks, edges, present):
    lookup = nearest_present_week(present.to(edges.device))
    e = edges[lookup[_weeks0(weeks, edges.device)]]      # (T, 2, *S)
    return e[:, 0], e[:, 1]


def label_terciles(y, weeks, edges, present, degenerate_mask=False):
    """Assign 0/1/2 tercile labels (float32, NaN where masked).

    y: (T, *S); weeks: (T,); edges: (53, 2, *S); present: (53,) bool.
    degenerate_mask: also mask q33==0 or q33==q66 pixels (ELR variant).
    """
    y = torch.as_tensor(y, dtype=torch.float32, device=edges.device)
    q0, q1 = _edges_for(weeks, edges, present)
    # NaN y falls through to label 1, as the reference's xr.where does
    lab = torch.where(y < q0, 0.0, torch.where(y > q1, 2.0, 1.0))
    mask = torch.isnan(q0) | torch.isnan(q1)
    if degenerate_mask:
        mask = mask | (q0 == 0.0) | (q0 == q1)
    return torch.where(mask, float("nan"), lab)


def elr_targets(y, weeks, edges, present):
    """Cumulative binary targets for ELR: (2, T, *S) with [y<=q33, y<=q66],
    NaN where the (degenerate-inclusive) mask applies."""
    y = torch.as_tensor(y, dtype=torch.float32, device=edges.device)
    q0, q1 = _edges_for(weeks, edges, present)
    below33 = torch.where(y <= q0, 1.0, 0.0)
    below66 = torch.where(y <= q1, 1.0, 0.0)
    mask = torch.isnan(q0) | torch.isnan(q1) | (q0 == 0.0) | (q0 == q1)
    out = torch.stack([below33, below66])
    return torch.where(mask[None], float("nan"), out)


def fit_and_label(y, weeks, pool_mask, window_matrix, label_masks,
                  degenerate_mask=False):
    """Edges from the pool, labels for the full T axis.

    label_masks is unused by the math (labels are computed for every T and
    selected by masks downstream); it is kept for the JAX signature.
    Returns (labels (T,*S), edges (53,2,*S), present (53,)).
    """
    edges, present = rolling_edges(y, weeks, pool_mask, window_matrix)
    labels = label_terciles(y, weeks, edges, present, degenerate_mask)
    return labels, edges, present


def static_terciles(y, pool_mask=None):
    """Static (non-rolling) tercile labeler: edges are the [1/3, 2/3]
    quantiles over the whole pooled T axis per pixel; labels 0/1/2, NaN
    where y is NaN. Returns (labels (T,*S), edges (2,*S))."""
    y = torch.as_tensor(y, dtype=torch.float32)
    if pool_mask is None:
        pool_mask = torch.ones(y.shape[0], dtype=torch.bool)
    sel = torch.as_tensor(pool_mask, dtype=torch.bool, device=y.device)
    sel = sel.reshape((y.shape[0],) + (1,) * (y.ndim - 1))
    edges = masked_quantile(y, sel, TERCILE_QS, axis=0)    # (2, *S)
    q0, q1 = edges[0], edges[1]
    lab = torch.where(y < q0, 0.0, torch.where(y > q1, 2.0, 1.0))
    lab = torch.where(torch.isnan(y) | torch.isnan(q0) | torch.isnan(q1),
                      float("nan"), lab)
    return lab, edges


def one_hot_labels(labels, n=3):
    """(..., n) one-hot of 0/1/2 float labels; NaN label -> all-NaN row."""
    lab = torch.as_tensor(labels)
    idx = torch.nan_to_num(lab, nan=0.0).long().clamp(0, n - 1)
    oh = torch.nn.functional.one_hot(idx, n).to(torch.float32)
    return torch.where(torch.isnan(lab)[..., None], float("nan"), oh)

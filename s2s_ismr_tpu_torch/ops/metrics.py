"""Probabilistic skill metrics as torch ops on the input's device (port
of s2s_ismr_tpu/ops/metrics.py).

  * climo_forecast: constant 1/3 forecast, NaN where the ensemble-mean
    predictor is NaN (reference climo_predict).
  * rps / rpss: ranked probability score via cumulative distributions,
    mean over time skipping NaN entries, and RPSS = 1 - RPS_fcst/RPS_ref
    per pixel; rpss_folds scores every CV fold in one computation.
  * BSS / reliability / resolution (plots.py:13-139): 10-bin diagnostics
    with the reference's binning and its pinned 1/3 base rate for BSS, in
    float32 and in the JAX package's order of operations.
  * CC / ACC (ACCs.ipynb cells 13/25/38): Pearson correlation over time of
    raw fields / ISO-week anomaly fields, optionally against an external
    lead-dependent climatology (GEFS dc0018).

The per-bin and per-week sums reduce a one-hot mask over rows with
`sum`, never a scatter-add: scatter-adds use atomics on CUDA, so their
sums would change order, and bits, from one run to the next.
"""

from __future__ import annotations

import torch

from .quantiles import masked_mean
from .terciles import one_hot_labels

N_CATEGORIES = 3


def climo_forecast(x_mean):
    """(T,*S) ensemble-mean predictor -> (T,*S,3) constant-1/3 forecast,
    NaN where the predictor is NaN."""
    x_mean = torch.as_tensor(x_mean, dtype=torch.float32)
    f = torch.full(x_mean.shape + (N_CATEGORIES,), 1.0 / N_CATEGORIES,
                   dtype=torch.float32, device=x_mean.device)
    return torch.where(torch.isnan(x_mean)[..., None], float("nan"), f)


def _score(fcst, obs_labels):
    """Per-sample RPS: squared distance of the cumulative distributions;
    fcst (..., 3) broadcasts against the one-hot labels. NaN propagates."""
    fcst = torch.as_tensor(fcst, dtype=torch.float32)
    obs_oh = one_hot_labels(torch.as_tensor(obs_labels, device=fcst.device),
                            N_CATEGORIES)
    cum_f = torch.cumsum(fcst, dim=-1)
    cum_o = torch.cumsum(obs_oh, dim=-1)
    return ((cum_f - cum_o) ** 2).sum(-1)


def rps(fcst, obs_labels, t_mask=None):
    """Ranked probability score per pixel.

    fcst: (T,*S,3) tercile probabilities; obs_labels: (T,*S) 0/1/2/NaN;
    t_mask: (T,) bool fold membership (None = all). Returns (*S,) float32,
    NaN where no valid samples.
    """
    score = _score(fcst, obs_labels)                 # (T,*S)
    if t_mask is None:
        t_mask = torch.ones(score.shape[0], dtype=torch.bool)
    m = torch.as_tensor(t_mask, dtype=torch.bool, device=score.device)
    m = m.reshape((-1,) + (1,) * (score.ndim - 1))
    return masked_mean(score, m, axis=0)


def rpss(reference_fcst, fcst, obs_labels, t_mask=None):
    """1 - RPS(fcst)/RPS(reference) per pixel."""
    return 1.0 - (rps(fcst, obs_labels, t_mask)
                  / rps(reference_fcst, obs_labels, t_mask))


def rpss_folds(reference_fcst, fcst, obs_labels, t_masks):
    """rpss of every fold in one computation (the JAX package's vmap of
    rpss over folds).

    reference_fcst: (T,*S,3), shared; fcst: (F,T,*S,3); obs_labels:
    (F,T,*S); t_masks: (F,T) bool. Returns (F,*S).
    """
    fcst = torch.as_tensor(fcst, dtype=torch.float32)
    labels = torch.as_tensor(obs_labels, device=fcst.device)
    m = torch.as_tensor(t_masks, dtype=torch.bool, device=fcst.device)
    m = m.reshape(m.shape + (1,) * (labels.ndim - 2))
    ref = torch.as_tensor(reference_fcst, device=fcst.device)
    return 1.0 - (masked_mean(_score(fcst, labels), m, axis=1)
                  / masked_mean(_score(ref, labels), m, axis=1))


# ------------------------------------------------------- binned diagnostics
_EDGE_SCALE = 0.9999999999999  # reference's digitize edge-case guard (plots.py:72)


def _flat(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1)


def _valid(valid, p, t):
    v = torch.as_tensor(valid, dtype=torch.bool, device=p.device).reshape(-1)
    return v & torch.isfinite(p) & torch.isfinite(t)


def _bin_stats(y_pred, y_true, valid, num_bins=10):
    """Counts, average prediction and observed frequency per bin, with the
    reference's binning (plots.py:36-39, 125-128): np.digitize(p,
    linspace(0,1,11), right=True) - 1 clipped to [0, nbins-1], i.e.
    left-exclusive bins (i/n, (i+1)/n] with p <= 0 in bin 0, computed as
    ceil(p*n) - 1 in float32."""
    p = _flat(y_pred)
    t = _flat(y_true, p.device)
    v = _valid(valid, p, t)
    idx = torch.clamp(torch.ceil(torch.nan_to_num(p) * num_bins).to(torch.int32)
                      - 1, 0, num_bins - 1)
    onehot = (idx[:, None] == torch.arange(num_bins, dtype=torch.int32,
                                           device=p.device)) & v[:, None]
    counts = onehot.to(torch.float32).sum(0)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    sum_p = torch.where(onehot, p[:, None], zero).sum(0)
    sum_t = torch.where(onehot, t[:, None], zero).sum(0)
    denom = torch.clamp(counts, min=1.0)
    return counts, sum_p / denom, sum_t / denom    # counts, avg pred, obs freq


def reliability_score(y_pred, y_true, valid=None, num_bins=10):
    """Count-weighted mean squared (avg-pred - obs-freq), the reference's
    compute_reliability_score (plots.py:13-58). The reference scales
    y_pred by 0.9999999999999 in BSS/resolution but not here: binning and
    averages both use the raw probabilities (plots.py:27-52)."""
    p = _flat(y_pred)
    if valid is None:
        valid = torch.ones_like(p, dtype=torch.bool)
    counts, avg_p, obs_f = _bin_stats(p, y_true, valid, num_bins)
    total = torch.clamp(counts.sum(), min=1.0)
    return ((avg_p - obs_f) ** 2 * counts).sum() / total


def brier_skill_score(y_pred, y_true, valid=None, base_rate=1.0 / 3.0):
    """BSS with the reference's pinned 1/3 base rate (plots.py:80-81)."""
    p = _flat(y_pred) * _EDGE_SCALE
    t = _flat(y_true, p.device)
    if valid is None:
        valid = torch.ones_like(p, dtype=torch.bool)
    v = _valid(valid, p, t)
    bs = masked_mean((p - t) ** 2, v)
    br = masked_mean((base_rate - t) ** 2, v)
    return 1.0 - bs / br


def resolution_score(y_pred, y_true, valid=None, num_bins=10):
    """Count-weighted (obs-freq - base-rate)^2; the base rate is the
    observed mean, and predictions are scaled by the reference's edge
    guard before binning (plots.py:109-128; reliability bins them raw)."""
    p = _flat(y_pred) * _EDGE_SCALE
    t = _flat(y_true, p.device)
    if valid is None:
        valid = torch.ones_like(p, dtype=torch.bool)
    v = _valid(valid, p, t)
    base = masked_mean(t, v)
    counts, _avg_p, obs_f = _bin_stats(p, t, v, num_bins)
    total = torch.clamp(counts.sum(), min=1.0)
    return (counts * (obs_f - base) ** 2).sum() / total


# ------------------------------------------------------------------ ACC / CC
def _time_mask(t_mask, like):
    m = torch.as_tensor(t_mask, dtype=torch.bool, device=like.device)
    return m.reshape((-1,) + (1,) * (like.ndim - 1))


def masked_corr(a, b, t_mask=None):
    """Pearson correlation over the leading (time) axis, skipping samples
    where either input is NaN (xr.corr semantics, ACCs.ipynb cell 13); NaN
    where fewer than 2 samples are valid or a variance is 0."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    ok = torch.isfinite(a) & torch.isfinite(b)
    if t_mask is not None:
        ok = ok & _time_mask(t_mask, a)
    n = ok.sum(0).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=a.device)
    nan = torch.full((), float("nan"), dtype=torch.float32, device=a.device)
    den = torch.clamp(n, min=1.0)
    ma = torch.where(ok, a, zero).sum(0) / den
    mb = torch.where(ok, b, zero).sum(0) / den
    da = torch.where(ok, a - ma, zero)
    db = torch.where(ok, b - mb, zero)
    cov = (da * db).sum(0)
    var = torch.sqrt((da * da).sum(0) * (db * db).sum(0))
    out = cov / torch.where(var > 0, var, nan)
    return torch.where(n > 1, out, nan)


def weekly_climatology(v, weeks, t_mask=None, n_weeks=53):
    """Per-ISO-week mean over time: (T,*S) -> (n_weeks,*S), NaN for a week
    without samples. The sample-mean climatology the ACC notebook builds
    per week (ACCs.ipynb cells 13/25)."""
    v = torch.as_tensor(v, dtype=torch.float32)
    w0 = torch.as_tensor(weeks, device=v.device).to(torch.int32) - 1
    ok = torch.isfinite(v)
    if t_mask is not None:
        ok = ok & _time_mask(t_mask, v)
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    vals = torch.where(ok, v, zero)
    num, den = [], []
    for w in range(n_weeks):             # one masked sum per week
        sel = ok & _time_mask(w0 == w, v)
        num.append(torch.where(sel, vals, zero).sum(0))
        den.append(sel.sum(0).to(torch.float32))
    num, den = torch.stack(num), torch.stack(den)
    return torch.where(den > 0, num / torch.clamp(den, min=1.0),
                       torch.full_like(num, float("nan")))


def anomaly_cc(x_mean, y, weeks, x_clim=None, y_clim=None, t_mask=None):
    """ACC: correlation of ISO-week anomalies. Pass x_clim (53,*S), or a
    per-sample (T,*S) climatology, to use an external lead-dependent
    product (the GEFS dc0018 path, ACCs.ipynb cell 38); the default is the
    sample weekly climatology. A climatology with 53 leading rows is read
    as per-week, as in the JAX package, also when T is 53."""
    x_mean = torch.as_tensor(x_mean, dtype=torch.float32)
    dev = x_mean.device
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    w0 = torch.as_tensor(weeks, device=dev).to(torch.long) - 1
    if x_clim is None:
        x_clim = weekly_climatology(x_mean, weeks, t_mask)
    if y_clim is None:
        y_clim = weekly_climatology(y, weeks, t_mask)
    x_clim = torch.as_tensor(x_clim, dtype=torch.float32, device=dev)
    y_clim = torch.as_tensor(y_clim, dtype=torch.float32, device=dev)
    xc = x_clim[w0] if x_clim.shape[0] == 53 else x_clim
    yc = y_clim[w0] if y_clim.shape[0] == 53 else y_clim
    return masked_corr(x_mean - xc, y - yc, t_mask)

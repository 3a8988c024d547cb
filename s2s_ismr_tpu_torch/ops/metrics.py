"""Probabilistic skill metrics (port of s2s_ismr_tpu/ops/metrics.py:31-60).

  * climo_forecast: constant 1/3 forecast, NaN where the ensemble-mean
    predictor is NaN (reference climo_predict).
  * rps / rpss: ranked probability score via cumulative distributions,
    mean over time skipping NaN entries, and RPSS = 1 - RPS_fcst/RPS_ref
    per pixel; rpss_folds scores every CV fold in one computation.

The binned REL/BSS/RES diagnostics and CC/ACC are ported with the
reporting slice (ROADMAP queue A item 9).
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

"""Losses with Keras-parity semantics and mask awareness (port of
s2s_ismr_tpu/train/losses.py).

Keras categorical_crossentropy on probability outputs clips to
[1e-7, 1 - 1e-7] and averages over every non-batch element; the mean here
is weighted by a per-sample weight vector so padded batches reproduce the
ragged-batch mean of the reference.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _weighted_mean(per_sample, sample_weight):
    if sample_weight is None:
        return per_sample.mean()
    w = torch.as_tensor(sample_weight, dtype=per_sample.dtype,
                        device=per_sample.device)
    return (per_sample * w).sum() / torch.clamp(w.sum(), min=1.0)


def categorical_crossentropy(probs, onehot, sample_weight=None):
    """Mean CE over weighted samples and all spatial positions.

    probs/onehot: (N, ..., C); sample_weight: (N,) or None.
    0-weight batches return 0 (callers gate updates).
    """
    p = torch.clamp(probs, _EPS, 1.0 - _EPS)
    ce = -(onehot * torch.log(p)).sum(-1)                # (N, ...)
    per_sample = ce.reshape(ce.shape[0], -1).mean(1)
    return _weighted_mean(per_sample, sample_weight)


def masked_mse(pred, target, sample_weight=None):
    """Mean squared error for the deterministic head. NaN target positions
    are excluded from each sample's mean; the batch mean is sample-weighted
    like the CE above."""
    valid = torch.isfinite(target)
    diff = pred - torch.where(valid, target, torch.zeros_like(target))
    sq = torch.where(valid, diff ** 2, torch.zeros_like(diff))
    nsp = sq.reshape(sq.shape[0], -1)
    nv = torch.clamp(valid.reshape(valid.shape[0], -1).sum(1)
                     .to(nsp.dtype), min=1.0)
    return _weighted_mean(nsp.sum(1) / nv, sample_weight)


def categorical_accuracy(probs, onehot, sample_weight=None):
    """Keras 'accuracy' metric: argmax match over all positions."""
    hit = (probs.argmax(-1) == onehot.argmax(-1)).to(torch.float32)
    per_sample = hit.reshape(hit.shape[0], -1).mean(1)
    return _weighted_mean(per_sample, sample_weight)

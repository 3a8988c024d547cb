"""Masked quantiles (port of s2s_ismr_tpu/ops/quantiles.py).

xarray's skipna linear-interpolation quantile as one sort along the pooled
axis with invalid entries pushed to the tail, then a gather at the
(possibly fractional) order statistic q*(n_valid-1). The float32 arithmetic
is the JAX version's as XLA compiles it (the interpolation is one fused
multiply-add), so tercile labels come out bit-equal.
"""

from __future__ import annotations

import torch

_BIG = 3.4e38  # +inf stand-in that still sorts correctly


def masked_quantile(values, valid, qs, axis=0):
    """Quantiles of `values` over `axis`, counting only `valid & finite`.

    values: float tensor; valid: bool, broadcast against values.
    qs: sequence of quantiles in [0,1].
    Returns a tensor with `axis` replaced by a leading len(qs) axis.
    All-invalid slices yield NaN; interpolation is numpy's 'linear'.
    """
    values = torch.as_tensor(values, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=values.device)
    values, valid = torch.broadcast_tensors(values, valid)
    ok = valid & torch.isfinite(values)
    x = torch.where(ok, values, torch.full_like(values, _BIG))
    xs = torch.sort(x.movedim(axis, 0), dim=0).values    # invalid -> tail
    n = ok.movedim(axis, 0).sum(0)                        # (...,) counts
    q = torch.as_tensor(qs, dtype=torch.float32,
                        device=values.device).reshape((-1,) + (1,) * n.ndim)
    pos = q * torch.clamp(n - 1, min=0).to(torch.float32)  # (Q, ...)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.to(torch.float32)
    xq = xs.unsqueeze(0).expand((q.shape[0],) + xs.shape)
    v_lo = torch.gather(xq, 1, lo.unsqueeze(1)).squeeze(1)
    v_hi = torch.gather(xq, 1, hi.unsqueeze(1)).squeeze(1)
    # v_lo * (1 - frac) + v_hi * frac as XLA compiles it in the JAX
    # package's jitted tercile fit: one fused multiply-add,
    # fma(v_lo, 1 - frac, v_hi * frac), its product exact in float64. The
    # rounding differs from two products by an ulp now and then, and a
    # tiled record (the stacked predictor repeats each value per member)
    # has values equal to its edges, whose labels then flip.
    out = (v_lo.double() * (1.0 - frac).double()
           + (v_hi * frac).double()).to(torch.float32)
    return torch.where(n > 0, out, torch.full_like(out, float("nan")))


def masked_mean(values, valid, axis=None):
    """Mean over valid & finite entries; empty -> NaN (xarray skipna)."""
    values = torch.as_tensor(values, dtype=torch.float32)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=values.device)
    ok = valid.expand(values.shape) & torch.isfinite(values)
    dims = tuple(range(values.ndim)) if axis is None else axis
    num = torch.where(ok, values, torch.zeros_like(values)).sum(dims)
    den = ok.sum(dims).to(torch.float32)
    return torch.where(den > 0, num / torch.clamp(den, min=1.0),
                       torch.full_like(num, float("nan")))

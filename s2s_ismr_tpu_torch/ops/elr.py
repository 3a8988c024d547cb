"""Extended Logistic Regression baseline, pixel-parallel IRLS (port of
s2s_ismr_tpu/ops/elr.py).

The reference fits one statsmodels GLM(Binomial) per grid point
(training.py:430-524) on [const, ensemble-mean precip, quantile
indicator], the indicator being the constant 33 for the P(y<=q33) rows and
67 for the P(y<=q66) rows. Cumulative probabilities become tercile
probabilities [p1, p2-p1, 1-p2]; label-invalid times get 1/3; pixels that
fail its validity guards are skipped and stay NaN.

Here every pixel of every fold is one lane of a tensor: with 3 features
the normal equations are 6 sums of products over the rows and the solve is
a closed-form 3x3 adjugate, so an IRLS iteration is a few elementwise ops
and row reductions on (F, 2T, P) tensors. The JAX `lax.scan` is a Python
loop whose tensors stay on the device; nothing in it reads back to the
host. The JAX package computes this in XLA, not Pallas, so it ports as
torch ops. With a mesh, the pixel rows are cut over its devices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

Q_INDICATOR = (33.0, 67.0)   # the reference's constant 'quantile' feature
N_IRLS_ITERS = 30
RIDGE = 1e-8
ETA_CLIP = 30.0

_Q_CENTER = 50.0
_Q_SCALE = 17.0   # (33-50)/17 = -1, (67-50)/17 = +1
# relative deviance rise that counts as a diverging IRLS step: ~170 float32
# ulps, far above the rounding of a row sum, far below a real jump
_DEV_RISE = 1e-5


def _irls_pixels(x, y, w, q, iters=N_IRLS_ITERS):
    """Pixel-parallel weighted logistic IRLS.

    x, y, w: (..., R, P), R = 2T stacked rows ([q33 block; q66 block]),
    P pixels, any leading batch axes; q: (R, 1) scaled quantile indicator.
    Rows with w = 0 are ignored. Returns (b0, b1, b2), each (..., P), in
    the SCALED feature basis.
    """
    y = torch.nan_to_num(y, nan=0.0)
    x = torch.nan_to_num(x, nan=0.0)   # NaN pixels are skipped downstream
    b0 = b1 = b2 = torch.zeros(x.shape[:-2] + x.shape[-1:],
                               dtype=torch.float32, device=x.device)
    b_prev = (b0, b1, b2)
    dev_prev = torch.full_like(b0, float("inf"))
    done = torch.zeros_like(b0, dtype=torch.bool)

    def rsum(v):
        return v.sum(-2)

    for _ in range(iters):
        eta = torch.clamp(b0[..., None, :] + b1[..., None, :] * x
                          + b2[..., None, :] * q, -ETA_CLIP, ETA_CLIP)
        # Divergence guard: a pixel whose step raised the binomial deviance
        # beyond rounding stops and keeps the betas before that step. A
        # block that saturates (all-one targets) runs eta up until its
        # IRLS weights fall below float32 resolution beside the other
        # block's; the 3x3 solve then turns to noise, and the JAX
        # version's betas end near 1e8 (ROADMAP section C). Newton steps
        # of a converging fit never raise the deviance, so every other
        # pixel runs all iterations as in JAX. softplus keeps -log(mu) and
        # -log(1 - mu) exact as mu -> 1.
        dev = 2.0 * rsum(w * (y * F.softplus(-eta)
                              + (1.0 - y) * F.softplus(eta)))
        stop = ~done & (dev > dev_prev * (1.0 + _DEV_RISE))
        b0, b1, b2 = (torch.where(stop, p, c)
                      for p, c in zip(b_prev, (b0, b1, b2)))
        done = done | stop
        b_prev, dev_prev = (b0, b1, b2), dev
        mu = torch.sigmoid(eta)
        s = torch.clamp(mu * (1.0 - mu), min=1e-8)
        wi = w * s
        z = eta + (y - mu) / s
        # normal equations: 6 unique entries of X^T W X, 3 of X^T W z
        wx, wq, wz = wi * x, wi * q, wi * z
        s1 = rsum(wi) + RIDGE
        sx, sq = rsum(wx), rsum(wq)
        sxx = rsum(wx * x) + RIDGE
        sxq, sqq = rsum(wx * q), rsum(wq * q) + RIDGE
        r0, rx, rq = rsum(wz), rsum(wz * x), rsum(wz * q)
        # closed-form symmetric 3x3 solve (adjugate / Cramer)
        c00 = sxx * sqq - sxq * sxq
        c01 = sq * sxq - sx * sqq
        c02 = sx * sxq - sq * sxx
        det = s1 * c00 + sx * c01 + sq * c02
        inv_det = 1.0 / torch.where(det.abs() > 1e-30, det,
                                    torch.ones_like(det))
        c11 = s1 * sqq - sq * sq
        c12 = sq * sx - s1 * sxq
        c22 = s1 * sxx - sx * sx
        b0 = torch.where(done, b0, (c00 * r0 + c01 * rx + c02 * rq) * inv_det)
        b1 = torch.where(done, b1, (c01 * r0 + c11 * rx + c12 * rq) * inv_det)
        b2 = torch.where(done, b2, (c02 * r0 + c12 * rx + c22 * rq) * inv_det)
    return b0, b1, b2


def elr_folds(x_mean, targets_folds, train_masks, test_masks, y_raw,
              mesh=None):
    """All pixels of all folds in one batched computation.

    x_mean: (T, *S) ensemble-mean predictor, shared by the folds;
    targets_folds: (F, 2, T, *S) cumulative targets; train_masks,
    test_masks: (F, T) bool; y_raw: (T, *S) observations.
    Returns (F, T, *S, 3) tercile probabilities, NaN at skipped pixels.
    Everything runs on x_mean's device, or with `mesh` (parallel.mesh),
    as JAX's P(None, 'lanes') shardings: the Y rows (axis 1 of x_mean)
    are cut into one contiguous block per device, each device fits its
    pixels (every pixel's GLM is independent: no communication), and the
    blocks come back concatenated on x_mean's device.
    """
    if mesh is not None:
        return _elr_folds_mesh(x_mean, targets_folds, train_masks,
                               test_masks, y_raw, mesh)
    x_mean = torch.as_tensor(x_mean, dtype=torch.float32)
    dev = x_mean.device
    tg = torch.as_tensor(targets_folds, dtype=torch.float32, device=dev)
    train = torch.as_tensor(train_masks, dtype=torch.bool, device=dev)
    test = torch.as_tensor(test_masks, dtype=torch.bool, device=dev)
    yr = torch.as_tensor(y_raw, dtype=torch.float32, device=dev)
    shape_s = tuple(x_mean.shape[1:])
    T = x_mean.shape[0]
    F = tg.shape[0]
    xs = x_mean.reshape(T, -1)                       # (T, P)
    tg = tg.reshape(F, 2, T, -1)
    yr = yr.reshape(T, -1)
    valid = ~torch.isnan(tg[:, 0])                   # (F, T, P)
    tr, te = train[..., None], test[..., None]       # (F, T, 1)

    x2 = torch.cat([xs, xs])                         # (2T, P)
    y2 = torch.cat([tg[:, 0], tg[:, 1]], dim=1)      # (F, 2T, P)
    q2 = torch.cat([
        torch.full((T, 1), (Q_INDICATOR[0] - _Q_CENTER) / _Q_SCALE),
        torch.full((T, 1), (Q_INDICATOR[1] - _Q_CENTER) / _Q_SCALE),
    ]).to(device=dev, dtype=torch.float32)
    valid2 = torch.cat([valid, valid], dim=1)
    w_train = (valid2 & torch.cat([tr, tr], dim=1)).to(torch.float32)

    # per-pixel center/scale of the precip feature over the TRAIN rows:
    # the fit is affine-equivariant in exact arithmetic, but the float32
    # 3x3 adjugate solve is not, and a (near-)constant x column is
    # collinear with the intercept. In the scaled basis it decouples.
    wsum = torch.clamp(w_train.sum(1), min=1e-8)     # (F, P)
    x_nn = torch.nan_to_num(x2, nan=0.0)
    xm = (w_train * x_nn).sum(1) / wsum
    xv = (w_train * (x_nn - xm[:, None]) ** 2).sum(1) / wsum
    # relative-degeneracy guard: a variance at float32 rounding scale
    # zeroes the column (the b1 = 0 minimum-norm solution for an all-zero
    # column; a deliberate, stable choice for a nonzero constant, see
    # tests/test_elr_edge_cases.py::test_train_constant_test_varying_pixel)
    degenerate = (xv < 1e-10 * (1.0 + xm * xm))[:, None]        # (F, 1, P)
    xsc = torch.where(degenerate, 1.0,
                      torch.sqrt(torch.clamp(xv, min=1e-12))[:, None])
    x2 = torch.where(degenerate, 0.0, (x2 - xm[:, None]) / xsc)  # (F, 2T, P)

    # reference skip guards (training.py:435, 465, 477, 480): any raw NaN
    # in the train rows, a NaN predictor at used rows, or <= 1 usable time
    x_nan = torch.isnan(xs)
    n_valid_train = (valid & tr).sum(1)
    n_valid_test = (valid & te).sum(1)
    x_nan_train = (x_nan & valid & tr).any(1)
    x_nan_test = (x_nan & valid & te).any(1)
    raw_nan = (torch.isnan(yr) & tr).any(1)
    skip = raw_nan | x_nan_train | x_nan_test | \
        (n_valid_train <= 1) | (n_valid_test <= 1)   # (F, P)

    b0, b1, b2 = _irls_pixels(x2, y2, w_train, q2)
    eta = torch.clamp(b0[:, None] + b1[:, None] * torch.nan_to_num(x2, nan=0.0)
                      + b2[:, None] * q2, -ETA_CLIP, ETA_CLIP)
    p = torch.sigmoid(eta)
    p1, p2 = p[:, :T], p[:, T:]
    probs = torch.stack([p1, p2 - p1, 1.0 - p2], dim=-1)     # (F, T, P, 3)
    probs = torch.where(valid[..., None], probs, 1.0 / 3.0)  # 1/3 fill
    probs = torch.where(skip[:, None, :, None], float("nan"), probs)
    return probs.reshape((F, T) + shape_s + (3,))


def _elr_folds_mesh(x_mean, targets_folds, train_masks, test_masks, y_raw,
                    mesh):
    """elr_folds with the Y rows cut over the mesh's devices."""
    from ..parallel.mesh import on_devices
    x_mean = torch.as_tensor(x_mean, dtype=torch.float32)
    tg = torch.as_tensor(targets_folds, dtype=torch.float32)
    yr = torch.as_tensor(y_raw, dtype=torch.float32)
    rows = torch.arange(x_mean.shape[1]).tensor_split(mesh.size)

    def part(i, dev):
        ys = rows[i]
        if not len(ys):
            return None
        ys = slice(int(ys[0]), int(ys[-1]) + 1)
        return elr_folds(x_mean[:, ys].to(dev), tg[:, :, :, ys].to(dev),
                         torch.as_tensor(train_masks).to(dev),
                         torch.as_tensor(test_masks).to(dev),
                         yr[:, ys].to(dev)).to(x_mean.device)
    parts = [p for p in on_devices(part, mesh) if p is not None]
    return torch.cat(parts, dim=2)


def elr_fold(x_mean, targets, train_mask, test_mask, y_raw):
    """One fold: x_mean (T, *S); targets (2, T, *S); masks (T,); y_raw
    (T, *S). Returns (T, *S, 3) tercile probabilities (NaN at skipped
    pixels)."""
    x_mean = torch.as_tensor(x_mean, dtype=torch.float32)
    dev = x_mean.device
    return elr_folds(
        x_mean, torch.as_tensor(targets, dtype=torch.float32, device=dev)[None],
        torch.as_tensor(train_mask, device=dev)[None],
        torch.as_tensor(test_mask, device=dev)[None], y_raw)[0]


def blend_probabilities(prob_list):
    """MME blend: average tercile probabilities across models and
    renormalize over the category axis (training.py:344-350, 622-626).
    NaN propagates."""
    p = torch.stack([torch.as_tensor(a, dtype=torch.float32)
                     for a in prob_list]).mean(0)
    return p / p.sum(-1, keepdim=True)

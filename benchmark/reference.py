"""The plain reference: the U-Net, its Keras-fit training of one lane, the
fold's winner and the winner's forward, in plain PyTorch.

It follows the reference's Keras model (deep_nn_models.py, after Horat &
Lerch 2023) and its fit: shuffled minibatches with the training rows of
the epoch's order first, Keras categorical crossentropy (probabilities
clipped to [1e-7, 1 - 1e-7]), BatchNormalization (momentum 0.99, epsilon
1e-3, biased variance) weighted by the rows of the batch that are training
rows, Keras Adam (epsilon 1e-7), the val loss each epoch, the weights of
the best epoch (strictly lower), early stop after `patience` epochs
without a gain, and per fold the first trial of least val loss.

  encoder   n_blocks x [conv3x3 ELU, conv3x3 ELU, BN, avgpool 2]
  bottleneck conv3x3 ELU, conv3x3 ELU, BN
  decoder   n_blocks x [convT(ct_kernel, stride 2, TF SAME), concat skip,
            conv3x3 ELU, conv3x3 ELU, BN (not in the last block)]
  head      conv1x1, softmax over the three terciles

Parameters live in one flat vector (their gradient is one vector, and
Adam is a few whole-vector ops) and are read as views named as the
program's state_dict names them, so the initial weights the benchmark
makes load into either. Everything runs in the dtype of its inputs: the
caller fixes the precision (float32 with TF32 off for the check). It
imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS_CE = 1e-7
BN_MOMENTUM, BN_EPS = 0.99, 1e-3
B1, B2, EPS_ADAM = 0.9, 0.999, 1e-7


def block_width(filters, k):
    return filters * 4 * 2 ** (k - 1)


def unet_spec(trial, in_ch=1, n_out=3):
    """[(state_dict name, shape, init)] of the U-Net of `trial`, in the
    program's order; kernels are stored (kh, kw, in, out), a transposed
    conv's (kh, kw, out, in) as the adjoint of a forward conv."""
    spec = []

    def conv(name, c, o, k=(3, 3)):
        spec.extend([(f"{name}.conv.kernel", (*k, c, o), "glorot"),
                     (f"{name}.conv.bias", (o,), "zeros")])

    def bn(name, c):
        spec.extend([(f"{name}.scale", (c,), "ones"),
                     (f"{name}.bias", (c,), "zeros"),
                     (f"{name}.mean", (c,), "zeros"),
                     (f"{name}.var", (c,), "ones")])

    n, c = trial.n_blocks, in_ch
    for k in range(1, n + 1):
        w = block_width(trial.filters, k)
        conv(f"down{k}_conv1", c, w)
        conv(f"down{k}_conv2", w, w)
        bn(f"down{k}_bn", w)
        c = w
    wb = block_width(trial.filters, n + 1)
    conv("bottleneck_conv1", c, wb)
    conv("bottleneck_conv2", wb, wb)
    bn("bottleneck_bn", wb)
    c = wb
    for k in range(n, 0, -1):
        w = block_width(trial.filters, k)
        spec.extend([(f"up{k}_convT.kernel", (*trial.ct_kernel, w, c),
                      "glorot"), (f"up{k}_convT.bias", (w,), "zeros")])
        conv(f"up{k}_conv1", 2 * w, w)
        conv(f"up{k}_conv2", w, w)
        if k > 1:
            bn(f"up{k}_bn", w)
        c = w
    conv("head", c, n_out, (1, 1))
    return spec


def _is_buffer(name):
    return name.endswith(".mean") or name.endswith(".var")


class Layout:
    """Where each named tensor sits in the flat parameter vector or the
    flat buffer vector."""

    def __init__(self, spec):
        self.params, self.buffers = [], []
        for name, shape, _ in spec:
            (self.buffers if _is_buffer(name) else self.params).append(
                (name, tuple(shape)))

    @staticmethod
    def _views(vec, entries):
        out, off = {}, 0
        for name, shape in entries:
            n = math.prod(shape)
            out[name] = vec[off:off + n].view(shape)
            off += n
        return out

    def unflatten(self, theta, stats):
        return {**self._views(theta, self.params),
                **self._views(stats, self.buffers)}

    def flatten(self, state):
        def cat(entries):
            return torch.cat([state[n].reshape(-1) for n, _ in entries])
        return cat(self.params).clone(), cat(self.buffers).clone()

    def stats_vector(self, updates, stats):
        """The buffer vector with the names in `updates` replaced."""
        old = self._views(stats, self.buffers)
        return torch.cat([updates.get(n, old[n]).reshape(-1)
                          for n, _ in self.buffers])


def forward(trial, P, x, train, w=None, updates=None):
    """Probabilities (N, H, W, 3) of images x (N, H, W, C) under the named
    tensors P. In training BN uses the batch statistics weighted by w (N,)
    and writes the new running statistics into `updates` (left as they
    were when the weights sum to 0); in eval it uses the running ones."""
    h = x.permute(0, 3, 1, 2)

    def conv(name, v):
        k = P[f"{name}.conv.kernel"].permute(3, 2, 0, 1)
        return F.elu(F.conv2d(v, k, P[f"{name}.conv.bias"], padding=1))

    def bn(name, v):
        scale, bias = P[f"{name}.scale"], P[f"{name}.bias"]
        if train:
            wv = w.to(v.dtype)[:, None, None, None]
            tot = torch.clamp(wv.sum() * v.shape[2] * v.shape[3], min=1.0)
            mean = (v * wv).sum((0, 2, 3)) / tot
            var = (wv * (v - mean[:, None, None]) ** 2).sum((0, 2, 3)) / tot
            has = w.sum() > 0
            for key, stat in (("mean", mean), ("var", var)):
                old = P[f"{name}.{key}"]
                updates[f"{name}.{key}"] = torch.where(
                    has, BN_MOMENTUM * old + (1 - BN_MOMENTUM) * stat.detach(),
                    old)
        else:
            mean, var = P[f"{name}.mean"], P[f"{name}.var"]
        inv = torch.rsqrt(var + BN_EPS)
        return ((v - mean[:, None, None]) * inv[:, None, None]
                * scale[:, None, None] + bias[:, None, None])

    n = trial.n_blocks
    skips = []
    for k in range(1, n + 1):
        h = conv(f"down{k}_conv2", conv(f"down{k}_conv1", h))
        h = bn(f"down{k}_bn", h)
        skips.append(h)
        h = F.avg_pool2d(h, 2)
    h = bn("bottleneck_bn", conv("bottleneck_conv2",
                                 conv("bottleneck_conv1", h)))
    for k in range(n, 0, -1):
        kern = P[f"up{k}_convT.kernel"]
        pad = tuple((kk - 2) // 2 for kk in kern.shape[:2])
        u = F.conv_transpose2d(h, kern.permute(3, 2, 0, 1), stride=2,
                               padding=pad)
        u = u[:, :, :2 * h.shape[2], :2 * h.shape[3]]
        u = u + P[f"up{k}_convT.bias"][:, None, None]
        u = torch.cat([skips[k - 1], u], dim=1)
        h = conv(f"up{k}_conv2", conv(f"up{k}_conv1", u))
        if k > 1:
            h = bn(f"up{k}_bn", h)
    logits = (torch.einsum("nchw,co->nhwo", h, P["head.conv.kernel"][0, 0])
              + P["head.conv.bias"])
    return torch.softmax(logits, dim=-1)


def crossentropy(probs, onehot, w=None):
    """Keras categorical crossentropy, the mean over pixels per row, then
    the mean over rows weighted by w (every row when None)."""
    p = torch.clamp(probs, EPS_CE, 1.0 - EPS_CE)
    per_row = -(onehot * torch.log(p)).sum(-1).reshape(p.shape[0], -1).mean(1)
    if w is None:
        return per_row.mean()
    return (per_row * w).sum() / torch.clamp(w.sum(), min=1.0)


def train_lane(trial, x, y, train_mask, val_mask, init, orders, epochs,
               patience):
    """One lane's Keras fit. x (T, H, W, C), y (T, H, W, 3), the fold's
    masks (T,) bool, init a state_dict, orders (epochs, T) permutations.
    Returns (best val loss, best state_dict, val loss per epoch run)."""
    dev, dt = x.device, x.dtype
    T, bs = x.shape[0], trial.batch_size
    lay = Layout(unet_spec(trial, x.shape[-1], y.shape[-1]))
    theta, stats = lay.flatten({k: v.to(dev, dt) for k, v in init.items()})
    theta.requires_grad_(True)
    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    count = torch.zeros((), device=dev)
    lr = torch.tensor(trial.lr, dtype=dt, device=dev)
    train = torch.as_tensor(train_mask, device=dev)
    n_real = math.ceil(int(train.sum()) / bs)
    pad = -(-T // bs) * bs - T
    x_pad = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    y_pad = torch.cat([y, y.new_zeros((1,) + y.shape[1:])])
    w_pad = torch.cat([train.to(dt), x.new_zeros(1)])
    vrows = torch.as_tensor(val_mask, device=dev).nonzero()[:, 0]
    x_val, y_val = x[vrows], y[vrows]
    best_v, best, wait, hist = math.inf, None, 0, []
    for e in range(epochs):
        if e > 0 and wait >= patience:
            break
        perm = torch.as_tensor(orders[e], device=dev)
        first = torch.argsort((~train[perm]).to(torch.int32), stable=True)
        order = torch.cat([perm[first], perm.new_full((pad,), T)])
        for rows in order.reshape(-1, bs)[:n_real]:
            wb = w_pad[rows]
            updates = {}
            probs = forward(trial, lay.unflatten(theta, stats), x_pad[rows],
                            True, wb, updates)
            loss = crossentropy(probs, y_pad[rows], wb)
            (g,) = torch.autograd.grad(loss, theta)
            with torch.no_grad():
                ok = (wb.sum() > 0) & torch.isfinite(loss)
                mu_n = (1 - B1) * g + B1 * mu
                nu_n = (1 - B2) * g * g + B2 * nu
                c = count + 1
                u = (mu_n / (1 - B1 ** c)) / (torch.sqrt(nu_n / (1 - B2 ** c))
                                              + EPS_ADAM)
                theta.copy_(torch.where(ok, theta - lr * u, theta))
                stats = torch.where(ok, lay.stats_vector(updates, stats),
                                    stats)
                mu = torch.where(ok, mu_n, mu)
                nu = torch.where(ok, nu_n, nu)
                count = torch.where(ok, c, count)
        with torch.no_grad():
            v = float(crossentropy(forward(trial, lay.unflatten(theta, stats),
                                           x_val, False), y_val))
        hist.append(v)
        if v < best_v:
            best_v, wait = v, 0
            best = (theta.detach().clone(), stats.clone())
        else:
            wait += 1
    if best is None:           # every val loss NaN: the initial weights
        best = lay.flatten({k: v.to(dev, dt) for k, v in init.items()})
    state = lay.unflatten(*best)
    return best_v, {k: v.clone() for k, v in state.items()}, hist


def predict(trial, state, x, rows=128):
    """Eval-mode probabilities (T, H, W, 3) of x under `state`, in blocks of
    `rows` rows."""
    with torch.no_grad():
        return torch.cat([forward(trial, state, x[i:i + rows], False)
                          for i in range(0, x.shape[0], rows)])


def fold_winner(losses):
    """Index of the first least val loss (the reference's strict `<` over
    trials in product order)."""
    best = 0
    for i, v in enumerate(losses):
        if v < losses[best]:
            best = i
    return best

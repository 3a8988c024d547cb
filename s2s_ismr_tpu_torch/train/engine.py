"""The training engine: one fold x trial = one `train_fold` call (port of
s2s_ismr_tpu/train/engine.py).

Keras-fit semantics of the reference (shuffled minibatches, per-epoch
val_loss, ModelCheckpoint on the best val_loss, EarlyStopping with
patience and restore_best_weights):
  * improvement = strictly lower val_loss
  * after `patience` epochs without improvement the lane stops
  * the returned weights / val loss are those of the best epoch

Ragged folds are masks over the full T axis. Batches are index gathers;
padded slots carry weight 0, and a batch whose weights sum to 0 or whose
loss is not finite changes nothing: parameters, BN statistics and the Adam
state (its step count included) are kept with `torch.where` on the device,
so the loop never waits on the host inside an epoch. The one host read per
epoch is `stopped`, when `early_exit` is on.

The JAX `lax.scan` loops are Python loops here. Each epoch runs only the
batches that hold a training sample: the train-first partition puts every
all-padding batch at the end, and those are no-ops under the gate above,
so skipping them changes no result.

Parameters and BN buffers are re-seated as views of one flat vector each,
so the Adam update, the gate and the best-epoch copy are a few whole-vector
ops, like the JAX version's optax.flatten.

Dropout masks come from a per-lane generator on the lane's device, handed
to the model's forward once per batch (JAX's per-batch dropout keys).

Every eval forward (the per-epoch val loss, the winner forward, the replay
of a saved winner) runs in fixed row chunks, `row_chunk` rows each, so no
conv kernel launch exceeds its N*H*W limit (the stacked predictor has
thousands of rows). Eval rows are independent, and one rule everywhere
keeps a replay bit-equal to the run it replays.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
from torch import nn

from ..kernels.conv import MAX_PIXELS
from .losses import categorical_crossentropy, masked_mse

_LOSSES = {"categorical_crossentropy": categorical_crossentropy,
           "mse": masked_mse}


@dataclass(frozen=True)
class TrainSettings:
    epochs: int = 100
    batch_size: int = 16
    patience: int = 10
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-7            # Keras Adam epsilon
    val_rows: int | None = None  # upper bound on validation rows: the val
    # loss is evaluated on a compacted (val_rows, ...) gather instead of
    # the full masked T axis (same value: weights zero any overshoot)
    early_exit: bool = False     # stop the epoch loop once the lane has
    # stopped (patience exceeded); otherwise all epochs run with the
    # result frozen. Outputs are identical; history past the exit is NaN.
    loss: str = "categorical_crossentropy"   # | 'mse' (deterministic head)


class Adam:
    """Keras-default Adam on one flat vector: optax.flatten(scale_by_adam(
    b1, b2, eps, eps_root=0)). The learning rate is applied by the caller
    (p - lr * u). State: (count, mu, nu), all on the vector's device."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-7):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, flat):
        count = torch.zeros((), dtype=torch.int32, device=flat.device)
        return count, torch.zeros_like(flat), torch.zeros_like(flat)

    def update(self, g, state):
        count, mu, nu = state
        mu = (1 - self.b1) * g + self.b1 * mu
        nu = (1 - self.b2) * g * g + self.b2 * nu
        count = count + 1
        c = count.to(torch.float32)
        mu_hat = mu / (1 - self.b1 ** c)
        nu_hat = nu / (1 - self.b2 ** c)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps), (count, mu, nu)


def train_batches(n_train, batch_size):
    """Batches per epoch that hold a training sample (the rest are no-ops)."""
    return math.ceil(n_train / batch_size)


def _flatten_storage(tensors, device):
    """Re-seat `tensors` as views of one new flat vector and return it."""
    if not tensors:
        return torch.zeros(0, device=device)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    off = 0
    for t in tensors:
        t.data = flat[off:off + t.numel()].view_as(t)
        off += t.numel()
    return flat


@dataclass
class LaneState:
    """A model's parameters and BN buffers as views of two flat vectors,
    with the Adam state over the parameter vector."""
    model: nn.Module
    params: list
    flat: torch.Tensor
    stats: torch.Tensor
    opt: Adam
    opt_state: tuple

    @classmethod
    def create(cls, model: nn.Module, settings: TrainSettings, device):
        params = list(model.parameters())
        flat = _flatten_storage(params, device)
        stats = _flatten_storage(list(model.buffers()), device)
        opt = Adam(settings.b1, settings.b2, settings.eps)
        return cls(model, params, flat, stats, opt, opt.init(flat))


def row_chunk(x):
    """Rows per eval forward of images x (N, H, W, C): the most that keep
    one conv kernel launch at full map size within its N*H*W limit."""
    return max(1, MAX_PIXELS // (x.shape[1] * x.shape[2]))


def eval_rows(fn, x):
    """fn(chunk) over x in fixed chunks of row_chunk(x) rows,
    concatenated."""
    rows = row_chunk(x)
    if x.shape[0] <= rows:
        return fn(x)
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def train_step(lane: LaneState, xb, yb, wb, lr, loss_impl,
               dropout_generator: torch.Generator | None = None):
    """One gated optimizer step on a batch; returns the loss (0-d tensor).
    A batch with zero total weight or a non-finite loss leaves parameters,
    BN statistics and Adam state (count included) as they were. The
    model's dropout, if any, draws from `dropout_generator`."""
    stats_before = lane.stats.clone()
    out = lane.model(xb, train=True, sample_weight=wb,
                     dropout_generator=dropout_generator)
    loss = loss_impl(out, yb, wb)
    grads = torch.autograd.grad(loss, lane.params)
    g = torch.cat([gp.reshape(-1) for gp in grads])
    with torch.no_grad():
        u, new_opt = lane.opt.update(g, lane.opt_state)
        ok = (wb.sum() > 0) & torch.isfinite(loss)
        lane.flat.copy_(torch.where(ok, lane.flat - lr * u, lane.flat))
        lane.stats.copy_(torch.where(ok, lane.stats, stats_before))
        lane.opt_state = tuple(torch.where(ok, n, o)
                               for n, o in zip(new_opt, lane.opt_state))
    return loss


def train_fold(model: nn.Module, x, y_onehot, train_mask, val_mask, lr,
               generator: torch.Generator | None, settings: TrainSettings,
               init_variables: dict | None = None, epoch_perms=None,
               dropout_generator: torch.Generator | None = None):
    """Train one lane in place; return (best_state, best_val_loss, history).

    model:     module with forward(x, train, sample_weight); trained in
               place and left holding the best-epoch state
    x:         (T, H, W, C) float32 predictor images, on the model's device
    y_onehot:  (T, H, W, 3) targets for this lane's fold
    train_mask/val_mask: (T,) bool
    lr:        float learning rate
    generator: CPU torch.Generator for the per-epoch batch permutations
    init_variables: optional state_dict loaded before training
    epoch_perms: optional (epochs, T) int64 permutations used instead of
               the generator's (a test seam: feeds JAX's batch orders)
    dropout_generator: generator on x's device for the model's dropout
               masks (models without dropout ignore it)
    Returns the best state_dict (copies), the best val loss (0-d tensor)
    and the per-epoch val losses (epochs,), NaN past an early exit.
    """
    dev = x.device
    T = x.shape[0]
    bs = settings.batch_size
    n_batches = -(-T // bs)
    pad = n_batches * bs - T
    train_mask = torch.as_tensor(train_mask, dtype=torch.bool, device=dev)
    val_mask = torch.as_tensor(val_mask, dtype=torch.bool, device=dev)

    def pad0(a):
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])

    x_pad, y_pad = pad0(x), pad0(y_onehot)
    w_pad = pad0(train_mask.to(torch.float32))
    n_real = train_batches(int(train_mask.sum()), bs)

    if init_variables is not None:
        model.load_state_dict(init_variables)
    lane = LaneState.create(model, settings, dev)
    flat, stats = lane.flat, lane.stats
    loss_impl = _LOSSES[settings.loss]

    if settings.val_rows is not None and settings.val_rows < T:
        # val rows first (stable argsort), fixed size; slots past this
        # lane's true count carry weight 0
        vidx = torch.argsort((~val_mask).to(torch.int32),
                             stable=True)[:settings.val_rows]
        x_val, y_val = x[vidx], y_onehot[vidx]
        w_val = val_mask[vidx].to(torch.float32)
    else:
        x_val, y_val, w_val = x, y_onehot, val_mask.to(torch.float32)

    best_flat, best_stats = flat.clone(), stats.clone()
    best_vloss = torch.tensor(float("inf"), device=dev)
    wait = torch.zeros((), dtype=torch.int32, device=dev)
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    hist = torch.full((settings.epochs,), float("nan"), device=dev)

    for e in range(settings.epochs):
        if settings.early_exit and e > 0 and bool(stopped):
            break
        perm = (torch.as_tensor(epoch_perms[e]) if epoch_perms is not None
                else torch.randperm(T, generator=generator)).to(dev)
        # Keras shuffle=True; the stable partition puts train rows first
        train_first = torch.argsort((~train_mask[perm]).to(torch.int32),
                                    stable=True)
        idx = perm[train_first]
        if pad:
            # pad slots point at row T: a zero row with weight 0
            idx = torch.cat([idx, idx.new_full((pad,), T)])
        batches = idx.reshape(n_batches, bs)
        for bidx in batches[:n_real]:
            train_step(lane, x_pad[bidx], y_pad[bidx], w_pad[bidx], lr,
                       loss_impl, dropout_generator)

        with torch.no_grad():
            out = eval_rows(lambda v: model(v, train=False), x_val)
            vloss = loss_impl(out, y_val, w_val)
            improved = (vloss < best_vloss) & ~stopped
            best_flat = torch.where(improved, flat, best_flat)
            best_stats = torch.where(improved, stats, best_stats)
            best_vloss = torch.where(improved, vloss, best_vloss)
            wait = torch.where(improved, torch.zeros_like(wait),
                               wait + (~stopped).to(torch.int32))
            stopped = stopped | (wait >= settings.patience)
            hist[e] = vloss

    with torch.no_grad():
        flat.copy_(best_flat)
        stats.copy_(best_stats)
    best = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return best, best_vloss, hist


@contextlib.contextmanager
def deterministic_cudnn():
    """Hold cuDNN to deterministic algorithms inside the block: its
    transposed conv may otherwise sum in another order from call to call."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def predict(model: nn.Module, variables, x):
    """Inference forward over the full T axis (eval mode, running BN), in
    fixed chunks of row_chunk(x) rows.
    variables: a state_dict, or None for the model's own state.

    cuDNN is held deterministic, so a winner's predictions reproduce bit
    for bit when it is reloaded."""
    def fwd(v):
        if variables is None:
            return model(v, train=False)
        return torch.func.functional_call(model, variables, (v,),
                                          {"train": False})
    with deterministic_cudnn(), torch.no_grad():
        return eval_rows(fwd, x)

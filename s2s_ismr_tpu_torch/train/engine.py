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

`train_lanes` trains L lanes of one architecture together, the
counterpart of JAX's `vmap(train_fold)`: parameters and BN buffers are
(L, P) and (L, S) flats, one `torch.func.vmap(grad_and_value(...))` step
runs all lanes' batches (each lane its own batch order and dropout masks,
drawn outside the vmap from its own generators in its serial order), and
Adam, the gate, the best-epoch copy and early stopping are the same
`torch.where` logic over the lane axis. Each lane computes what its own
`train_fold` computes.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
from torch import nn

from ..kernels.conv import MAX_PIXELS
from ..models.layers import Dropout, functional_batchnorm
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
    (p - lr * u). State: (count, mu, nu), all on the vector's device. For
    lanes the flat is (L, P) and the count (L,): one count per lane."""

    def __init__(self, b1=0.9, b2=0.999, eps=1e-7):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, flat):
        count = torch.zeros(flat.shape[:-1], dtype=torch.int32,
                            device=flat.device)
        return count, torch.zeros_like(flat), torch.zeros_like(flat)

    def update(self, g, state):
        count, mu, nu = state
        mu = (1 - self.b1) * g + self.b1 * mu
        nu = (1 - self.b2) * g * g + self.b2 * nu
        count = count + 1
        c = count.to(torch.float32)[..., None]
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


def row_chunk(x, axis=0):
    """Rows per eval forward of images x (N, H, W, C), their rows along
    `axis` (1 for lane-stacked images (L, N, H, W, C)): the most that keep
    one conv kernel launch at full map size within its N*H*W limit (per
    lane: a lane-mode launch of L lanes takes L times the rows)."""
    return max(1, MAX_PIXELS // (x.shape[axis + 1] * x.shape[axis + 2]))


def eval_rows(fn, x, axis=0):
    """fn(chunk) over x in fixed chunks of row_chunk(x, axis) rows along
    `axis`, concatenated."""
    rows, n = row_chunk(x, axis), x.shape[axis]
    if n <= rows:
        return fn(x)
    return torch.cat([fn(x.narrow(axis, i, min(rows, n - i)))
                      for i in range(0, n, rows)], dim=axis)


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


def _pad_rows(a, pad, axis=0):
    """a with `pad` zero rows appended along axis."""
    shape = list(a.shape)
    shape[axis] = pad
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _epoch_batches(perm, train_mask, pad, bs):
    """The epoch's batch rows (..., n_batches, bs) from its permutation(s)
    perm (..., T): Keras shuffle=True, the stable partition putting train
    rows first; pad slots point at row T, a zero row with weight 0."""
    T = perm.shape[-1]
    train_first = torch.argsort(
        (~torch.gather(train_mask, -1, perm)).to(torch.int32), dim=-1,
        stable=True)
    idx = torch.gather(perm, -1, train_first)
    if pad:
        idx = torch.cat([idx, idx.new_full(idx.shape[:-1] + (pad,), T)], -1)
    return idx.reshape(idx.shape[:-1] + (-1, bs))


def _val_index(val_mask, settings):
    """Rows of the val loss (..., val_rows): val rows first (stable
    argsort), fixed size; slots past a lane's true count carry weight 0.
    None: every row (settings.val_rows unset or >= T)."""
    T = val_mask.shape[-1]
    if settings.val_rows is None or settings.val_rows >= T:
        return None
    return torch.argsort((~val_mask).to(torch.int32), dim=-1,
                         stable=True)[..., :settings.val_rows]


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
    pad = -(-T // bs) * bs - T
    train_mask = torch.as_tensor(train_mask, dtype=torch.bool, device=dev)
    val_mask = torch.as_tensor(val_mask, dtype=torch.bool, device=dev)

    x_pad, y_pad = _pad_rows(x, pad), _pad_rows(y_onehot, pad)
    w_pad = _pad_rows(train_mask.to(torch.float32), pad)
    n_real = train_batches(int(train_mask.sum()), bs)

    if init_variables is not None:
        model.load_state_dict(init_variables)
    lane = LaneState.create(model, settings, dev)
    flat, stats = lane.flat, lane.stats
    loss_impl = _LOSSES[settings.loss]

    vidx = _val_index(val_mask, settings)
    if vidx is not None:
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
        batches = _epoch_batches(perm, train_mask, pad, bs)
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


@dataclass
class LanesResult:
    """What `train_lanes` returns: per lane what `train_fold` returns, and
    what the batched loop ran."""
    best: list                   # L best state_dicts (copies)
    best_vloss: torch.Tensor     # (L,) best val losses
    hist: torch.Tensor           # (L, epochs) val losses, NaN where the
    # lane did not run the epoch (past its early exit)
    batched_steps: int = 0       # vmapped optimizer steps (all lanes each)
    batched_epochs: int = 0      # epochs of the batched loop


def _stack_flat(tensors_per_lane):
    """(L, P): each lane's tensors flattened and concatenated."""
    return torch.stack([torch.cat([t.detach().reshape(-1) for t in ts])
                        if ts else torch.zeros(0) for ts in tensors_per_lane])


def _unflatten(vec, spec):
    """{name: view of vec} for spec [(name, shape)], in order."""
    out, off = {}, 0
    for name, shape in spec:
        n = math.prod(shape)
        out[name] = vec[off:off + n].view(shape)
        off += n
    return out


def train_lanes(models, x, y_onehot, train_masks, val_masks, lrs,
                generators, settings: TrainSettings, init_variables=None,
                epoch_perms=None, dropout_generators=None) -> LanesResult:
    """Train L lanes of one architecture together: JAX's vmap(train_fold).

    models:     L modules of one architecture on x's device, each holding
                its lane's initialisation (not trained in place)
    x:          (T, H, W, C) predictor images, shared by the lanes
    y_onehot:   (L, T, H, W, K) each lane's targets
    train_masks/val_masks: (L, T) bool
    lrs:        L learning rates
    generators: L CPU generators for the lanes' batch orders
    init_variables, epoch_perms, dropout_generators: per lane, as
                train_fold's (lists of L, or None)
    Lane i gets exactly what train_fold gives it with its own arguments,
    up to float32 sum order: one vmapped step runs every lane's batch j;
    a lane past its real batches, or stopped, gets a weight-0 batch (a
    no-op under the gate) and draws no batch order and no dropout mask.
    The loop ends when every lane has stopped (one host read per epoch,
    with early_exit), as JAX's vmapped while_loop runs to the last lane's
    stop. Val losses run lane-batched in row chunks of row_chunk(x) rows
    per lane.
    """
    dev = x.device
    L, T = len(models), x.shape[0]
    bs = settings.batch_size
    n_batches = -(-T // bs)
    pad = n_batches * bs - T
    train_masks = torch.as_tensor(train_masks, dtype=torch.bool, device=dev)
    val_masks = torch.as_tensor(val_masks, dtype=torch.bool, device=dev)
    y_onehot = torch.as_tensor(y_onehot, device=dev)
    init_variables = init_variables or [None] * L
    epoch_perms = epoch_perms or [None] * L
    dropout_generators = dropout_generators or [None] * L

    x_pad = _pad_rows(x, pad)
    y_pad = _pad_rows(y_onehot, pad, axis=1)
    w_pad = _pad_rows(train_masks.to(torch.float32), pad, axis=1)
    n_real = [train_batches(int(n), bs) for n in train_masks.sum(1).cpu()]
    lane_rows = torch.arange(L, device=dev)[:, None]

    for m, init in zip(models, init_variables):
        if init is not None:
            m.load_state_dict(init)
    model = models[0]
    p_spec = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    b_spec = [(n, tuple(b.shape)) for n, b in model.named_buffers()]
    flat = _stack_flat([list(m.parameters()) for m in models]).to(dev)
    stats = _stack_flat([list(m.buffers()) for m in models]).to(dev)
    opt = Adam(settings.b1, settings.b2, settings.eps)
    opt_state = opt.init(flat)
    lr_col = torch.tensor([float(v) for v in lrs], dtype=torch.float32,
                          device=dev)[:, None]
    loss_impl = _LOSSES[settings.loss]
    drop = next((m for m in model.modules()
                 if isinstance(m, Dropout) and m.rate > 0), None)
    drop_shapes = (model.dropout_shapes(bs, *x.shape[1:3])
                   if drop is not None else [])

    def forward(p, s, xv, **kw):
        state = {**_unflatten(p, p_spec), **_unflatten(s, b_spec)}
        return torch.func.functional_call(model, state, (xv,), kw), state

    def lane_loss(p, s, xb, yb, wb, masks):
        kw = {"dropout_masks": masks} if masks else {}
        with functional_batchnorm(model) as updates:
            out, state = forward(p, s, xb, train=True, sample_weight=wb,
                                 **kw)
        new_s = (torch.cat([updates.get(n, state[n]).reshape(-1)
                            for n, _ in b_spec]) if b_spec else s)
        return loss_impl(out, yb, wb), new_s

    step = torch.func.vmap(torch.func.grad_and_value(lane_loss, has_aux=True))
    val_fwd = torch.func.vmap(lambda p, s, xv: forward(p, s, xv,
                                                       train=False)[0])
    val_loss = torch.func.vmap(loss_impl)

    vidx = _val_index(val_masks, settings)
    if vidx is not None:
        x_val, y_val = x[vidx], y_onehot[lane_rows, vidx]
        w_val = torch.gather(val_masks, 1, vidx).to(torch.float32)
    else:
        x_val, y_val = x.expand((L,) + x.shape), y_onehot
        w_val = val_masks.to(torch.float32)

    best_flat, best_stats = flat.clone(), stats.clone()
    best_vloss = torch.full((L,), float("inf"), device=dev)
    wait = torch.zeros(L, dtype=torch.int32, device=dev)
    stopped = torch.zeros(L, dtype=torch.bool, device=dev)
    hist = torch.full((L, settings.epochs), float("nan"), device=dev)
    steps = epochs = 0

    for e in range(settings.epochs):
        active = [True] * L
        if settings.early_exit and e > 0:
            active = (~stopped).tolist()
            if not any(active):
                break
        perms = torch.stack([
            (torch.as_tensor(epoch_perms[i][e]) if epoch_perms[i] is not None
             else torch.randperm(T, generator=generators[i])) if active[i]
            else torch.arange(T) for i in range(L)]).to(dev)
        batches = _epoch_batches(perms, train_masks, pad, bs)
        n_steps = max(n for n, a in zip(n_real, active) if a)
        # live[i][j]: lane i trains on its batch j (else a weight-0 batch)
        live = [[a and j < n for j in range(n_steps)]
                for n, a in zip(n_real, active)]
        live_t = torch.tensor(live, dtype=torch.float32, device=dev)
        for j in range(n_steps):
            bidx = batches[:, j]                                  # (L, bs)
            wb = w_pad[lane_rows, bidx] * live_t[:, j:j + 1]
            masks = []
            if drop_shapes:
                lane_masks = [
                    [drop.draw_mask(sh, dropout_generators[i], dev)
                     for sh in drop_shapes] if live[i][j]
                    else [torch.ones(sh, dtype=torch.bool, device=dev)
                          for sh in drop_shapes] for i in range(L)]
                masks = [torch.stack(ms) for ms in zip(*lane_masks)]
            grads, (loss, new_stats) = step(flat, stats, x_pad[bidx],
                                            y_pad[lane_rows, bidx], wb, masks)
            with torch.no_grad():
                u, new_opt = opt.update(grads, opt_state)
                ok = ((wb.sum(1) > 0) & torch.isfinite(loss))[:, None]
                flat = torch.where(ok, flat - lr_col * u, flat)
                stats = torch.where(ok, new_stats, stats)
                opt_state = tuple(
                    torch.where(ok.reshape((L,) + (1,) * (n.ndim - 1)), n, o)
                    for n, o in zip(new_opt, opt_state))
        steps += n_steps
        epochs += 1

        with torch.no_grad():
            out = eval_rows(lambda v: val_fwd(flat, stats, v), x_val, axis=1)
            vloss = val_loss(out, y_val, w_val)
            ran = torch.tensor(active, device=dev)
            improved = (vloss < best_vloss) & ~stopped & ran
            best_flat = torch.where(improved[:, None], flat, best_flat)
            best_stats = torch.where(improved[:, None], stats, best_stats)
            best_vloss = torch.where(improved, vloss, best_vloss)
            wait = torch.where(improved, torch.zeros_like(wait),
                               wait + (~stopped & ran).to(torch.int32))
            stopped = stopped | (wait >= settings.patience)
            hist[:, e] = torch.where(ran, vloss, hist[:, e])

    keys = list(model.state_dict())
    best = []
    for i in range(L):
        state = {**_unflatten(best_flat[i], p_spec),
                 **_unflatten(best_stats[i], b_spec)}
        best.append({k: state[k].clone() for k in keys})
    return LanesResult(best, best_vloss, hist, steps, epochs)


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

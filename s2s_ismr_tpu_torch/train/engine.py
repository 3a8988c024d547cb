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

A lane's epoch is one program (`programs.Program`), JAX's jitted
`epoch_step` (its minibatch scan and the val / best-epoch update): its
body is written once over the program's static buffers. On a CUDA device
the body is captured once into a CUDA graph and each epoch is a replay; on
the CPU the body is called directly. An epoch of more than EPOCH_CHUNK
real steps (the stacked predictor's) is captured in four segments instead
(`_ChunkedFoldProgram`: a prologue, a chunk of EPOCH_CHUNK steps launched
again and again, a single step for the rest, an epilogue), which every
fold of those shapes shares whatever its count of steps: the capture
stays bounded and the arithmetic is the whole epoch's, in its order.
The programs live in the process's memo (`programs`), keyed by the
model's structure, the shapes and the statics, so every lane, fold and
config of the same shapes reuses one: data, masks, learning rate, batch
orders and initial weights are copied into the program's buffers before
a lane runs, and its best state copied out after. The epoch loop around the program stays on the host, with its
one read per epoch (`stopped`, under `early_exit`), as JAX's early-exit
`while_loop` reads its condition. Each epoch runs only the batches that
hold a training sample: the train-first partition puts every all-padding
batch at the end, and those are no-ops under the gate above, so skipping
them changes no result. The private keyword `_uncaptured` runs the same
body without capture on the card: a test seam to compare against.

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
`train_fold` computes. Its program is keyed also by the epoch's step count
(the most real steps among the lanes still running) and, when the model
draws dropout, by which lanes run: both change only when a lane stops.

`predict`, the winner forward, is a program too (JAX's memoized
`winner_forward`): keyed by the model's structure, the rows and their
chunking.
"""

from __future__ import annotations

import contextlib
import copy
import math
from dataclasses import dataclass

import torch
from torch import nn

from .. import profiling, programs
from ..kernels.conv import MAX_PIXELS
from ..models.layers import Dropout, functional_batchnorm
from .losses import categorical_crossentropy, masked_mse

_LOSSES = {"categorical_crossentropy": categorical_crossentropy,
           "mse": masked_mse}

# The most minibatch steps one lane's epoch captures into one graph. A
# longer epoch (the stacked predictor's 458-461 batches) runs as the
# segments of _ChunkedFoldProgram, whose chunk holds this many steps. The
# chunk trades capture time, which grows with it, against launches an
# epoch (n // chunk + n % chunk + 2). At 64x64 (n_blocks 5) on the H100,
# 458 steps: a chunk of 24-32 steps captures in 0.8-1.0 s, of 40 in
# 1.3-1.6 s, of 120 in 3.8 s, of 240 in 8.7 s, and 32 gives 26 launches.
# The epoch's launches take about its device time (1.40-1.46 s) at every
# chunk of 20-240 steps, since each launch waits for the graph before it:
# the chunk does not shorten them (chip_smoke.py --epoch-chunks).
EPOCH_CHUNK = 32


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
    model's dropout, if any, draws from `dropout_generator`. lr is a float
    or a 0-d tensor on the lane's device. The state is updated in place, so
    it keeps its storage (a program's buffers)."""
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
        for s, n in zip(lane.opt_state, new_opt):
            s.copy_(torch.where(ok, n, s))
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


def _has_dropout(model):
    return any(isinstance(m, Dropout) and m.rate > 0 for m in model.modules())


def _state_vector(state, names, device):
    """The tensors of `state` (a state_dict) named `names`, flattened and
    concatenated on `device`."""
    if not names:
        return torch.zeros(0, device=device)
    return torch.cat([state[n].detach().reshape(-1).to(device)
                      for n in names])


def _settings_key(settings):
    return (settings.batch_size, settings.patience, settings.b1,
            settings.b2, settings.eps, settings.loss)


def fold_key(model, x, y, n_real, val_rows, settings):
    """The memo key of train_fold's program: the model's structure, the
    images' and targets' shapes (T, H, W, C, K), the batch size, the real
    steps per epoch (past EPOCH_CHUNK the chunk instead, ("chunk",
    EPOCH_CHUNK): every such epoch shares one program), the val rows, the
    loss and Adam's constants, the device and the backend flags. The
    learning rate, the data and the initial weights are inputs, not parts
    of the key."""
    steps = n_real if n_real <= EPOCH_CHUNK else ("chunk", EPOCH_CHUNK)
    return ("train_fold", programs.module_key(model),
            programs._avals_key((x, y)), steps, val_rows,
            _settings_key(settings), programs.device_key(x.device),
            programs.flags_key())


def lanes_key(model, x, y, n_real, val_rows, settings):
    """The memo key of train_lanes' programs, less the epoch's statics
    (its steps and, with dropout, the lanes that run): fold_key's with the
    lane count in y's shape, each lane's real steps and early_exit."""
    return ("train_lanes", programs.module_key(model),
            programs._avals_key((x, y)), tuple(n_real), val_rows,
            settings.early_exit, _settings_key(settings),
            programs.device_key(x.device), programs.flags_key())


def predict_key(model, x):
    """The memo key of predict's program: the model's structure, the rows
    and their chunking, the device and the backend flags."""
    return ("predict", programs.module_key(model), programs._avals_key((x,)),
            row_chunk(x), programs.device_key(x.device),
            programs.flags_key())


def _program(key, build, uncaptured):
    """A fresh uncaptured program (the test seam), else the memo's."""
    return build(False) if uncaptured else programs.memoized(
        key, lambda: build(True))


class _FoldProgram(programs.Program):
    """One lane's epoch, JAX's `epoch_step` (s2s_ismr_tpu/train/engine.py
    :162-189): the batches from the epoch's permutation, the real
    minibatch steps, the val forward and loss, and the best-epoch /
    patience update, over static buffers:
      inputs  x_pad, y_pad, w_pad (T + pad rows; the pad rows stay zero),
              train_mask, the val rows x_val / y_val / w_val, lr (0-d) and
              perm (the epoch's permutation, loaded before each run);
      state   the program's module, its parameters and BN buffers views of
              lane.flat / lane.stats, the Adam state, best_flat /
              best_stats / best_vloss, wait and stopped;
      output  vloss, the epoch's val loss."""

    def __init__(self, model, x, y, val_rows, n_real, settings, capture):
        super().__init__(x.device, capture)
        dev, T = self.device, x.shape[0]
        bs = settings.batch_size
        self.T, self.bs, self.n_real = T, bs, n_real
        self.steps = n_real
        self.pad = -(-T // bs) * bs - T
        self.patience = settings.patience
        self.loss_impl = _LOSSES[settings.loss]
        self.model = copy.deepcopy(model).to(dev)
        self.pnames = [n for n, _ in self.model.named_parameters()]
        self.bnames = [n for n, _ in self.model.named_buffers()]
        self.lane = LaneState.create(self.model, settings, dev)
        rows = T + self.pad
        self.x_pad = x.new_zeros((rows,) + x.shape[1:])
        self.y_pad = y.new_zeros((rows,) + y.shape[1:])
        self.w_pad = torch.zeros(rows, device=dev)
        self.train_mask = torch.zeros(T, dtype=torch.bool, device=dev)
        self.perm = torch.arange(T, device=dev)
        if val_rows is None:
            self.x_val, self.y_val = self.x_pad[:T], self.y_pad[:T]
            self.w_val = torch.zeros(T, device=dev)
        else:
            self.x_val = x.new_zeros((val_rows,) + x.shape[1:])
            self.y_val = y.new_zeros((val_rows,) + y.shape[1:])
            self.w_val = torch.zeros(val_rows, device=dev)
        self.lr = torch.zeros((), device=dev)
        self.best_flat = self.lane.flat.clone()
        self.best_stats = self.lane.stats.clone()
        self.best_vloss = torch.full((), float("inf"), device=dev)
        self.wait = torch.zeros((), dtype=torch.int32, device=dev)
        self.stopped = torch.zeros((), dtype=torch.bool, device=dev)
        self.vloss = torch.zeros((), device=dev)
        self.generators = [torch.Generator(device=dev)
                           if self.capture and _has_dropout(model) else None]
        self.build()

    def warm_state(self):
        return [self.lane.flat, self.lane.stats, *self.lane.opt_state]

    def body(self, steps=None):
        batches = _epoch_batches(self.perm, self.train_mask, self.pad,
                                 self.bs)
        for j in range(self.n_real if steps is None
                       else min(steps, self.n_real)):
            self._step(batches[j])
        self._epilogue()

    def _step(self, bidx):
        """The minibatch step on the batch rows bidx (bs,)."""
        train_step(self.lane, self.x_pad[bidx], self.y_pad[bidx],
                   self.w_pad[bidx], self.lr, self.loss_impl,
                   self.generators[0])

    def _epilogue(self):
        """The val forward and loss, and the best-epoch / patience
        update."""
        lane = self.lane
        with torch.no_grad():
            out = eval_rows(lambda v: self.model(v, train=False), self.x_val)
            vloss = self.loss_impl(out, self.y_val, self.w_val)
            improved = (vloss < self.best_vloss) & ~self.stopped
            self.best_flat.copy_(torch.where(improved, lane.flat,
                                             self.best_flat))
            self.best_stats.copy_(torch.where(improved, lane.stats,
                                              self.best_stats))
            self.best_vloss.copy_(torch.where(improved, vloss,
                                              self.best_vloss))
            self.wait.copy_(torch.where(
                improved, torch.zeros_like(self.wait),
                self.wait + (~self.stopped).to(torch.int32)))
            self.stopped.copy_(self.stopped | (self.wait >= self.patience))
            self.vloss.copy_(vloss)

    def load(self, x, y, train_mask, val_mask, vidx, lr, state):
        """A lane's inputs and initial state into the buffers."""
        T, dev = self.T, self.device
        with torch.no_grad():
            self.x_pad[:T].copy_(x)
            self.y_pad[:T].copy_(y)
            self.w_pad[:T].copy_(train_mask)
            self.train_mask.copy_(train_mask)
            if vidx is None:
                self.w_val.copy_(val_mask)
            else:
                self.x_val.copy_(x[vidx])
                self.y_val.copy_(y[vidx])
                self.w_val.copy_(val_mask[vidx])
            if isinstance(lr, torch.Tensor):
                self.lr.copy_(lr)
            else:
                self.lr.fill_(lr)
            self.lane.flat.copy_(_state_vector(state, self.pnames, dev))
            self.lane.stats.copy_(_state_vector(state, self.bnames, dev))
            for t in self.lane.opt_state:
                t.zero_()
            self.best_flat.copy_(self.lane.flat)
            self.best_stats.copy_(self.lane.stats)
            self.best_vloss.fill_(float("inf"))
            self.wait.zero_()
            self.stopped.zero_()

    def best_state(self):
        """The best epoch's state_dict (copies); the module is left holding
        it."""
        with torch.no_grad():
            self.lane.flat.copy_(self.best_flat)
            self.lane.stats.copy_(self.best_stats)
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}


class _ChunkedFoldProgram(_FoldProgram):
    """_FoldProgram's epoch for any count of real steps, in four segments
    that every lane of these shapes shares, whatever its fold:
      0 prologue  the epoch's batches from perm into the buffer `batches`,
                  the step counter `offset` set to 0;
      1 chunk     EPOCH_CHUNK steps on the batches from `offset` on, which
                  it then advances by EPOCH_CHUNK;
      2 step      one step, the same with 1;
      3 epilogue  _FoldProgram's val forward and best-epoch update.
    A run of n real steps (`n_real`, set for each lane after its load)
    launches the prologue, the chunk n // EPOCH_CHUNK times, the step n %
    EPOCH_CHUNK times and the epilogue: the whole epoch's arithmetic in its
    order, EPOCH_CHUNK + 1 steps captured and no host read between."""

    def __init__(self, model, x, y, val_rows, n_real, settings, capture):
        dev, bs = x.device, settings.batch_size
        self.chunk = EPOCH_CHUNK
        self.batches = torch.zeros((-(-x.shape[0] // bs), bs),
                                   dtype=torch.int64, device=dev)
        self.offset = torch.zeros((), dtype=torch.int64, device=dev)
        self.ahead = torch.arange(self.chunk, device=dev)
        super().__init__(model, x, y, val_rows, n_real, settings, capture)

    def segments(self):
        return [(self._prologue, 0),
                (lambda: self._steps(self.chunk), self.chunk),
                (lambda: self._steps(1), 1), (self._epilogue, 0)]

    def schedule(self, steps=None):
        n = self.n_real if steps is None else min(steps, self.n_real)
        return ((0,) + (1,) * (n // self.chunk) + (2,) * (n % self.chunk)
                + (3,))

    def body(self, steps=None):
        parts = self.segments()
        for i in self.schedule(steps):
            parts[i][0]()

    def _prologue(self):
        self.batches.copy_(_epoch_batches(self.perm, self.train_mask,
                                          self.pad, self.bs))
        self.offset.zero_()

    def _steps(self, k):
        rows = self.batches.index_select(0, self.offset + self.ahead[:k])
        for j in range(k):
            self._step(rows[j])
        self.offset.add_(k)


def train_fold(model: nn.Module, x, y_onehot, train_mask, val_mask, lr,
               generator: torch.Generator | None, settings: TrainSettings,
               init_variables: dict | None = None, epoch_perms=None,
               dropout_generator: torch.Generator | None = None,
               _uncaptured: bool = False):
    """Train one lane; return (best_state, best_val_loss, history).

    model:     module with forward(x, train, sample_weight), on x's
               device; left holding the best-epoch state
    x:         (T, H, W, C) float32 predictor images, on the model's device
    y_onehot:  (T, H, W, 3) targets for this lane's fold
    train_mask/val_mask: (T,) bool
    lr:        learning rate (a float or a 0-d tensor)
    generator: CPU torch.Generator for the per-epoch batch permutations
    init_variables: optional state_dict loaded before training
    epoch_perms: optional (epochs, T) int64 permutations used instead of
               the generator's (a test seam: feeds JAX's batch orders)
    dropout_generator: generator on x's device for the model's dropout
               masks (models without dropout ignore it)
    _uncaptured: run the epoch body without capture on the card, in a
               program of its own (a test seam: the graph's yardstick)
    Returns the best state_dict (copies), the best val loss (0-d tensor)
    and the per-epoch val losses (epochs,), NaN past an early exit.
    An epoch of at most EPOCH_CHUNK real steps is one graph
    (_FoldProgram); a longer one the segments of _ChunkedFoldProgram.
    Spans: engine.load (to the first replay); per epoch engine.wait (the
    stop check), engine.epoch (the batch order drawn and uploaded, up to
    the launch) and the replay's, programs.train_replay, around one
    programs.graph_launch per segment launched; engine.best.
    """
    dev = x.device
    T = x.shape[0]
    bs = settings.batch_size
    gens = [dropout_generator]
    with contextlib.ExitStack() as held:
        with profiling.span("engine.load"):
            train_mask = torch.as_tensor(train_mask, dtype=torch.bool,
                                         device=dev)
            val_mask = torch.as_tensor(val_mask, dtype=torch.bool, device=dev)
            n_real = train_batches(int(train_mask.sum()), bs)
            if init_variables is not None:
                model.load_state_dict(init_variables)
            vidx = _val_index(val_mask, settings)
            val_rows = None if vidx is None else vidx.shape[0]
            key = fold_key(model, x, y_onehot, n_real, val_rows, settings)
            kind = (_FoldProgram if n_real <= EPOCH_CHUNK
                    else _ChunkedFoldProgram)
            prog = _program(key, lambda capture: kind(
                model, x, y_onehot, val_rows, n_real, settings, capture),
                _uncaptured)
            hist = torch.full((settings.epochs,), float("nan"), device=dev)
            held.enter_context(prog.lock)
            prog.load(x, y_onehot, train_mask, val_mask, vidx, lr,
                      model.state_dict())
            prog.n_real = n_real       # a chunked program's, per lane
            prog.bind(gens)
        try:
            for e in range(settings.epochs):
                if settings.early_exit and e > 0:
                    with profiling.span("engine.wait"):
                        stopped = bool(prog.stopped)
                    if stopped:
                        break
                with profiling.span("engine.epoch"):
                    prog.perm.copy_(
                        torch.as_tensor(epoch_perms[e])
                        if epoch_perms is not None
                        else torch.randperm(T, generator=generator))
                prog.run()
                hist[e].copy_(prog.vloss)
        finally:
            prog.unbind(gens)
        with profiling.span("engine.best"):
            best = prog.best_state()
            best_vloss = prog.best_vloss.clone()
            model.load_state_dict(best)
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


class _LanesProgram(programs.Program):
    """L lanes' epoch batched, JAX's vmapped `epoch_step`: _FoldProgram's
    buffers with a leading lane axis (x_pad shared), the lanes' parameters
    and BN buffers as (L, P) and (L, S) flats, and one vmapped
    grad_and_value step for all lanes' batch j. Statics besides the
    shapes: each lane's real steps (n_real), the epoch's steps (n_steps)
    and, when the model draws dropout, which lanes run (`active`: a lane
    draws masks only for the batches it trains on). Without dropout the
    lanes that run are data: `active` is ~stopped, read on the device."""

    def __init__(self, model, L, x, y, val_rows, n_real, n_steps, active,
                 settings, capture):
        super().__init__(x.device, capture)
        dev, T = self.device, x.shape[0]
        bs = settings.batch_size
        self.L, self.T, self.bs = L, T, bs
        self.pad = -(-T // bs) * bs - T
        self.n_steps, self.statics = n_steps, (n_steps, active)
        self.steps = n_steps
        self.patience, self.early_exit = settings.patience, settings.early_exit
        loss_impl = _LOSSES[settings.loss]
        self.model = model = copy.deepcopy(model).to(dev)
        p_spec = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
        b_spec = [(n, tuple(b.shape)) for n, b in model.named_buffers()]
        self.p_spec, self.b_spec = p_spec, b_spec
        P = sum(math.prod(s) for _, s in p_spec)
        S = sum(math.prod(s) for _, s in b_spec)
        self.flat = torch.zeros((L, P), device=dev)
        self.stats = torch.zeros((L, S), device=dev)
        self.opt = Adam(settings.b1, settings.b2, settings.eps)
        self.opt_state = self.opt.init(self.flat)
        rows = T + self.pad
        self.x_pad = x.new_zeros((rows,) + x.shape[1:])
        self.y_pad = y.new_zeros((L, rows) + y.shape[2:])
        self.w_pad = torch.zeros((L, rows), device=dev)
        self.train_masks = torch.zeros((L, T), dtype=torch.bool, device=dev)
        self.perms = torch.arange(T, device=dev).repeat(L, 1)
        if val_rows is None:
            self.x_val = self.x_pad[:T].expand((L,) + x.shape)
            self.y_val = self.y_pad[:, :T]
            self.w_val = torch.zeros((L, T), device=dev)
        else:
            self.x_val = x.new_zeros((L, val_rows) + x.shape[1:])
            self.y_val = y.new_zeros((L, val_rows) + y.shape[2:])
            self.w_val = torch.zeros((L, val_rows), device=dev)
        self.lr_col = torch.zeros((L, 1), device=dev)
        self.n_real_t = torch.tensor(n_real, device=dev)
        self.lane_rows = torch.arange(L, device=dev)[:, None]
        self.best_flat = torch.zeros_like(self.flat)
        self.best_stats = torch.zeros_like(self.stats)
        self.best_vloss = torch.full((L,), float("inf"), device=dev)
        self.wait = torch.zeros(L, dtype=torch.int32, device=dev)
        self.stopped = torch.zeros(L, dtype=torch.bool, device=dev)
        self.hist_col = torch.zeros(L, device=dev)
        self.drop = next((m for m in model.modules()
                          if isinstance(m, Dropout) and m.rate > 0), None)
        self.drop_shapes = (model.dropout_shapes(bs, *x.shape[1:3])
                            if self.drop is not None else [])
        self.live = [[a and j < n for j in range(n_steps)]
                     for n, a in zip(n_real, active or [True] * L)]
        self.generators = [torch.Generator(device=dev)
                           if self.capture and self.drop is not None
                           else None for _ in range(L)]

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

        self.step = torch.func.vmap(
            torch.func.grad_and_value(lane_loss, has_aux=True))
        self.val_fwd = torch.func.vmap(
            lambda p, s, xv: forward(p, s, xv, train=False)[0])
        self.val_loss = torch.func.vmap(loss_impl)
        self.build()

    def carry(self):
        """The state an epoch hands the next."""
        return [self.flat, self.stats, *self.opt_state, self.best_flat,
                self.best_stats, self.best_vloss, self.wait, self.stopped]

    def warm_state(self):
        return [self.flat, self.stats, *self.opt_state]

    def body(self, steps=None):
        L, dev = self.L, self.device
        rows = self.lane_rows
        active = (~self.stopped if self.early_exit
                  else torch.ones(L, dtype=torch.bool, device=dev))
        batches = _epoch_batches(self.perms, self.train_masks, self.pad,
                                 self.bs)
        # live[i, j]: lane i trains on its batch j (else a weight-0 batch)
        live = (active[:, None] & (torch.arange(self.n_steps, device=dev)
                                   < self.n_real_t[:, None])
                ).to(torch.float32)
        for j in range(self.n_steps if steps is None
                       else min(steps, self.n_steps)):
            bidx = batches[:, j]                                  # (L, bs)
            wb = self.w_pad[rows, bidx] * live[:, j:j + 1]
            masks = []
            if self.drop_shapes:
                lane_masks = [
                    [self.drop.draw_mask(sh, self.generators[i], dev)
                     for sh in self.drop_shapes] if self.live[i][j]
                    else [torch.ones(sh, dtype=torch.bool, device=dev)
                          for sh in self.drop_shapes] for i in range(L)]
                masks = [torch.stack(ms) for ms in zip(*lane_masks)]
            grads, (loss, new_stats) = self.step(
                self.flat, self.stats, self.x_pad[bidx],
                self.y_pad[rows, bidx], wb, masks)
            with torch.no_grad():
                u, new_opt = self.opt.update(grads, self.opt_state)
                ok = ((wb.sum(1) > 0) & torch.isfinite(loss))[:, None]
                self.flat.copy_(torch.where(ok, self.flat - self.lr_col * u,
                                            self.flat))
                self.stats.copy_(torch.where(ok, new_stats, self.stats))
                for s, n in zip(self.opt_state, new_opt):
                    s.copy_(torch.where(
                        ok.reshape((L,) + (1,) * (n.ndim - 1)), n, s))

        with torch.no_grad():
            out = eval_rows(lambda v: self.val_fwd(self.flat, self.stats, v),
                            self.x_val, axis=1)
            vloss = self.val_loss(out, self.y_val, self.w_val)
            improved = (vloss < self.best_vloss) & ~self.stopped & active
            self.best_flat.copy_(torch.where(improved[:, None], self.flat,
                                             self.best_flat))
            self.best_stats.copy_(torch.where(improved[:, None], self.stats,
                                              self.best_stats))
            self.best_vloss.copy_(torch.where(improved, vloss,
                                              self.best_vloss))
            self.wait.copy_(torch.where(
                improved, torch.zeros_like(self.wait),
                self.wait + (~self.stopped & active).to(torch.int32)))
            self.stopped.copy_(self.stopped | (self.wait >= self.patience))
            self.hist_col.copy_(torch.where(
                active, vloss, torch.full_like(vloss, float("nan"))))

    def load(self, x, y, train_masks, val_masks, vidx, lr_col, carry):
        """The lanes' inputs and the carried state into the buffers."""
        T = self.T
        with torch.no_grad():
            self.x_pad[:T].copy_(x)
            self.y_pad[:, :T].copy_(y)
            self.w_pad[:, :T].copy_(train_masks)
            self.train_masks.copy_(train_masks)
            if vidx is None:
                self.w_val.copy_(val_masks)
            else:
                self.x_val.copy_(x[vidx])
                self.y_val.copy_(y[self.lane_rows, vidx])
                self.w_val.copy_(torch.gather(val_masks, 1, vidx))
            self.lr_col.copy_(lr_col)
            for dst, src in zip(self.carry(), carry):
                dst.copy_(src)


def train_lanes(models, x, y_onehot, train_masks, val_masks, lrs,
                generators, settings: TrainSettings, init_variables=None,
                epoch_perms=None, dropout_generators=None,
                _uncaptured: bool = False) -> LanesResult:
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
    _uncaptured: as train_fold's (a test seam)
    Lane i gets exactly what train_fold gives it with its own arguments,
    up to float32 sum order: one vmapped step runs every lane's batch j;
    a lane past its real batches, or stopped, gets a weight-0 batch (a
    no-op under the gate) and draws no batch order and no dropout mask.
    The loop ends when every lane has stopped (one host read per epoch,
    with early_exit), as JAX's vmapped while_loop runs to the last lane's
    stop. Val losses run lane-batched in row chunks of row_chunk(x) rows
    per lane. When the epoch's program changes (a lane stopped), the
    state carries over into the next program.
    Spans as train_fold's; engine.epoch includes a program change.
    """
    dev = x.device
    L, T = len(models), x.shape[0]
    bs = settings.batch_size
    hist = torch.full((L, settings.epochs), float("nan"), device=dev)
    steps = epochs = 0
    prog = None

    def use(active):
        """The program of the epoch's active lanes, the state carried over
        from the last one when it changes; its minibatch steps."""
        nonlocal prog, carry
        n_steps = max(n for n, a in zip(n_real, active) if a)
        statics = (n_steps, tuple(active) if has_drop else None)
        if prog is None or prog.statics != statics:
            if prog is not None:
                carry = [t.clone() for t in prog.carry()]
                prog.unbind(dropout_generators)
                prog.lock.release()
                prog = None
            new = _program(base + statics, lambda capture: _LanesProgram(
                model, L, x, y_onehot, val_rows, n_real, *statics,
                settings, capture), _uncaptured)
            new.lock.acquire()
            prog = new
            prog.load(x, y_onehot, train_masks, val_masks, vidx, lr_col,
                      carry)
            prog.bind(dropout_generators)
        return n_steps

    try:
        with profiling.span("engine.load"):
            train_masks = torch.as_tensor(train_masks, dtype=torch.bool,
                                          device=dev)
            val_masks = torch.as_tensor(val_masks, dtype=torch.bool,
                                        device=dev)
            y_onehot = torch.as_tensor(y_onehot, device=dev)
            init_variables = init_variables or [None] * L
            epoch_perms = epoch_perms or [None] * L
            dropout_generators = dropout_generators or [None] * L
            n_real = [train_batches(int(n), bs)
                      for n in train_masks.sum(1).cpu()]
            for m, init in zip(models, init_variables):
                if init is not None:
                    m.load_state_dict(init)
            model = models[0]
            flat = _stack_flat([list(m.parameters()) for m in models]).to(dev)
            stats = _stack_flat([list(m.buffers()) for m in models]).to(dev)
            lr_col = torch.tensor([float(v) for v in lrs],
                                  dtype=torch.float32, device=dev)[:, None]
            vidx = _val_index(val_masks, settings)
            val_rows = None if vidx is None else vidx.shape[1]
            has_drop = _has_dropout(model)
            base = lanes_key(model, x, y_onehot, n_real, val_rows, settings)
            carry = [flat, stats, torch.zeros(L, dtype=torch.int32,
                                              device=dev),
                     torch.zeros_like(flat), torch.zeros_like(flat),
                     flat.clone(), stats.clone(),
                     torch.full((L,), float("inf"), device=dev),
                     torch.zeros(L, dtype=torch.int32, device=dev),
                     torch.zeros(L, dtype=torch.bool, device=dev)]
            active = [True] * L
            use(active)
        for e in range(settings.epochs):
            if settings.early_exit and e > 0:
                with profiling.span("engine.wait"):
                    active = (~prog.stopped).tolist()
                if not any(active):
                    break
            with profiling.span("engine.epoch"):
                n_steps = use(active)
                prog.perms.copy_(torch.stack([
                    (torch.as_tensor(epoch_perms[i][e])
                     if epoch_perms[i] is not None
                     else torch.randperm(T, generator=generators[i]))
                    if active[i] else torch.arange(T) for i in range(L)]))
            prog.run()
            hist[:, e].copy_(prog.hist_col)
            steps += n_steps
            epochs += 1
        with profiling.span("engine.best"):
            best_flat, best_stats, best_vloss = (
                t.clone() for t in prog.carry()[5:8])
            p_spec = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
            b_spec = [(n, tuple(b.shape)) for n, b in model.named_buffers()]
            keys = list(model.state_dict())
            best = []
            for i in range(L):
                state = {**_unflatten(best_flat[i], p_spec),
                         **_unflatten(best_stats[i], b_spec)}
                best.append({k: state[k].clone() for k in keys})
    finally:
        if prog is not None:
            prog.unbind(dropout_generators)
            prog.lock.release()
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


class _PredictProgram(programs.Program):
    """A model's eval forward over every row of x in row chunks, JAX's
    memoized `winner_forward` (s2s_ismr_tpu/train/sweep.py:113-126):
    inputs the module's state (flat / stats) and x, output `out`."""

    kind = "predict"

    def __init__(self, model, x, capture):
        super().__init__(x.device, capture)
        self.model = copy.deepcopy(model).to(self.device)
        self.pnames = [n for n, _ in self.model.named_parameters()]
        self.bnames = [n for n, _ in self.model.named_buffers()]
        self.flat = _flatten_storage(list(self.model.parameters()),
                                     self.device)
        self.stats = _flatten_storage(list(self.model.buffers()),
                                      self.device)
        self.x = torch.zeros_like(x)
        self.out = None       # allocated by the first run (the warm-up)
        self.build()

    def warm_state(self):
        return [self.flat, self.stats]

    def body(self, steps=None):
        with torch.no_grad():
            y = eval_rows(lambda v: self.model(v, train=False), self.x)
            if self.out is None:
                self.out = y
            else:
                self.out.copy_(y)

    def load(self, state, x):
        with torch.no_grad():
            self.flat.copy_(_state_vector(state, self.pnames, self.device))
            self.stats.copy_(_state_vector(state, self.bnames, self.device))
            self.x.copy_(x)


def predict(model: nn.Module, variables, x, _uncaptured: bool = False):
    """Inference forward over the full T axis (eval mode, running BN), in
    fixed chunks of row_chunk(x) rows, through the memo's program for the
    model's structure and x's shape.
    variables: a state_dict, or None for the model's own state.
    _uncaptured: as train_fold's (a test seam).

    cuDNN is held deterministic, so a winner's predictions reproduce bit
    for bit when it is reloaded."""
    state = model.state_dict()
    if variables is not None:
        state.update(variables)
    with deterministic_cudnn(), torch.no_grad():
        key = predict_key(model, x)
        prog = _program(key, lambda capture: _PredictProgram(model, x,
                                                             capture),
                        _uncaptured)
        with prog.lock:
            prog.load(state, x)
            prog.run()
            return prog.out.clone()

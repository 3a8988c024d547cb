"""What decides `correct`: a sample of the answers the window's sweep calls
gave, drawn from the seed, worked out again by the plain reference.

Each sweep call of the window preselects PAIRS of its folds (drawn
from the seed) and keeps their answers: every lane's best val loss, the
fold's winner and the winner's predictions over all T rows. After the
window the check draws PAIRS (call, fold) pairs from the seed among
them, trains every lane of each such fold with the reference from the
same initial weights and batch orders, picks the fold's winner, runs its
forward, and compares:

  vloss_gap  the largest |program - reference| / reference of a lane's
             best val loss (the whole fit: forward, backward, Adam,
             BatchNorm, the best-epoch bookkeeping);
  pred_gap   the largest |program - reference| of a winner's predicted
             probability (the winner choice and the winner forward);
  vloss_median_gap  the median over the compared lanes of the first:
             steadier, where one lane's fit amplifies float32 rounding
             as much as the control's lower precision does;
  winner_misses  the compared folds whose winner is not the reference's
             although the reference's val losses of the two lie more than
             WINNER_MARGIN apart (relative): an exact comparison.

The same four numbers, named with the prefix EARLY, are read from the
set-up call: the one-epoch sweep call through the window's own entry and
programs (the epoch graph the window replays), whose lanes stop after
their first epoch. Its PAIRS preselected folds are compared in full, each
lane's one epoch trained again by the reference. Those numbers are read
before float32 rounding has grown over a lane's later steps, where a
lane's best val loss after a hundred Adam steps moves as far under a
change of float32 algorithm as under the control's TF32. They are read
only in a cell whose file gives one of them a limit.

A number is compared where the cell's file gives its limit, set from the
readings in PERF.md: the lower, the most that sound runs read over a dozen
seeds or more, and the upper, the least the lower-precision control reads,
or where the control does not read three times the lower, the least that a
planted fault of the training path reads ten times the lower or more (a
state left unchanged: three times). A number that neither separates has no
limit in that cell: it is printed, not compared.
The reference runs in float32 with TF32 off in cuDNN and matmuls, and
cuDNN deterministic. The lower-precision control is the same reference
with TF32 on in cuDNN and matmuls, so in every conv, transposed conv,
head and their gradients, put in the program's place (`control_answers`).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference, workload

# (call, fold) pairs a run checks: three folds' lanes take the reference
# 8-25 s on the H100, under the window's 51 s
PAIRS = 3
# a fold's winner must be the reference's where the reference's val losses
# of the two differ by more than this share: ten times the widest gap of a
# lane's val loss in sound runs on the H100 (9.46e-5), a sixth of the
# least gap between the trials of a fold that they met (5.9e-3)
WINNER_MARGIN = 1e-3
# the prefix of the numbers read from the set-up call, and its call index
EARLY, SETUP_CALL = "epoch1_", -1


def draw(seed, tag, n, k):
    """k distinct values drawn from range(n) with the seed."""
    rng = np.random.default_rng(workload.derive_seed(seed, 3, tag))
    return rng.choice(n, size=k, replace=False).tolist()


def preselect(seed, call, folds):
    """The folds call `call` keeps answers of."""
    return draw(seed, 1000 + call, folds, min(PAIRS, folds))


def pairs(seed, kept):
    """PAIRS (call, fold) pairs drawn from `kept` {call: [folds]}."""
    items = [(c, f) for c, fs in sorted(kept.items()) for f in fs]
    return [items[i] for i in draw(seed, 7, len(items),
                                   min(PAIRS, len(items)))]


def _precision(tf32):
    """Set float32 (TF32 off, or on for the control) with cuDNN
    deterministic; returns the flags to restore."""
    b = torch.backends
    flags = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
             b.cudnn.deterministic)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = tf32
    b.cudnn.deterministic = True
    return flags


def _restore(flags):
    b = torch.backends
    (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
     b.cudnn.deterministic) = flags


def reference_fold(inputs, call, fold, epochs, patience):
    """The reference's answers for fold `fold` of call `call`: each trial's
    best val loss, the winner's index and its predictions, in the
    precision the caller set."""
    x, y = inputs.x, inputs.y_onehot[fold]
    T = x.shape[0]
    losses, states = [], []
    for t in inputs.trials:
        spec = reference.unet_spec(t, x.shape[-1], y.shape[-1])
        init = workload.lane_init(spec, inputs.seed, call, fold, t.index,
                                  x.device)
        orders = workload.lane_orders(inputs.seed, call, fold, t.index,
                                      epochs, T)
        v, state, _ = reference.train_lane(t, x, y, inputs.train[fold],
                                           inputs.val[fold], init, orders,
                                           epochs, patience)
        losses.append(v)
        states.append(state)
    win = reference.fold_winner(losses)
    pred = reference.predict(inputs.trials[win], states[win], x)
    return losses, win, pred


def control_answers(inputs, kept, epochs, patience):
    """The control's answers {(call, fold): (val losses, winner index,
    predictions)} for the pairs `compare` will draw from `kept`: the
    reference with TF32 on, in the program's place."""
    flags = _precision(True)
    try:
        out = {}
        for call, fold in pairs(inputs.seed, kept):
            losses, win, pred = reference_fold(inputs, call, fold, epochs,
                                               patience)
            out[(call, fold)] = (torch.tensor(losses), win, pred)
        return out
    finally:
        _restore(flags)


def early(cell):
    """Whether the cell's limits name a number of the set-up call."""
    return any(k.startswith(EARLY) for k in cell["limits"])


def compare(inputs, kept, answers, epochs, patience, log=print, prefix=""):
    """{prefix + name: reading} over the drawn pairs; answers[(call,
    fold)] = (val losses per trial, winner index, predictions)."""
    flags = _precision(False)
    vgaps, pgap, misses = [], 0.0, 0
    try:
        for call, fold in pairs(inputs.seed, kept):
            losses, win, pred = reference_fold(inputs, call, fold, epochs,
                                               patience)
            p_losses, p_win, p_pred = answers[(call, fold)]
            for a, b in zip(p_losses, losses):
                gap = abs(float(a) - b) / abs(b)
                vgaps.append(gap if np.isfinite(gap) else np.inf)
            apart = abs(losses[p_win] - losses[win]) / abs(losses[win])
            misses += int(p_win != win and not apart <= WINNER_MARGIN)
            d = float((p_pred.to(pred.device) - pred).abs().max())
            pgap = max(pgap, d if np.isfinite(d) else np.inf)
            log(f"check: call {call} fold {fold}: val losses program "
                f"{[float(v) for v in p_losses]} reference {losses}; winner "
                f"{p_win} / {win}")
    finally:
        _restore(flags)
    out = {"vloss_gap": max(vgaps), "vloss_median_gap":
           float(np.median(vgaps)), "pred_gap": pgap,
           "winner_misses": misses}
    return {prefix + k: v for k, v in out.items()}

"""Work counted from the model's shapes, by the benchmark's own arithmetic,
so a count reads the same whatever implements the work.

  * conv_shapes: the U-Net's 3x3 convs (the conv kernel's launches) in one
    forward, as (N, H, W, C, O);
  * launch_bound: the least time of one conv kernel launch, the larger of
    its FLOP at the float32 peak and its bytes at the memory peak, each
    input byte read once and each output byte written once (the
    arithmetic of the program's conv_bench.bound_parts, rewritten here);
  * sweep_launches: the conv kernel's launches in one sweep call, by shape
    and mode, from its lanes, epochs and batch counts;
  * row_flops: a row's model FLOP in a training step and in an eval
    forward, for the whole-step share of the peak.
"""

from __future__ import annotations

import math
from collections import Counter

from . import peaks

# the conv kernel takes N*H*W <= 2,000,000 pixels per launch, so every
# eval forward runs in chunks of that many rows over H*W
MAX_PIXELS = 2_000_000


def conv_shapes(trial, n, h, w, c_in=1):
    """[(N, H, W, C, O)] of the 3x3 convs of one U-Net forward of n rows of
    h x w, in order; the first takes the input and has no dx launch."""
    out, c = [], c_in
    for k in range(1, trial.n_blocks + 1):
        hk, wk = h >> (k - 1), w >> (k - 1)
        width = trial.filters * 4 * 2 ** (k - 1)
        out += [(n, hk, wk, c, width), (n, hk, wk, width, width)]
        c = width
    nb = trial.n_blocks
    wb = trial.filters * 4 * 2 ** nb
    out += [(n, h >> nb, w >> nb, c, wb), (n, h >> nb, w >> nb, wb, wb)]
    for k in range(nb, 0, -1):
        hk, wk = h >> (k - 1), w >> (k - 1)
        width = trial.filters * 4 * 2 ** (k - 1)
        out += [(n, hk, wk, 2 * width, width), (n, hk, wk, width, width)]
    return out


def launch_bound(shape, dx=False, lanes=1):
    """(seconds of its FLOP at the float32 peak, seconds of its bytes at
    the HBM rate) of one launch over `lanes` lanes. The forward reads x,
    w, b and writes y; the dx mode (with ELU') reads g, the saved output
    and w, and writes dx and g'."""
    n, h, w, c, o = shape
    m = n * h * w
    flop = 2 * m * 9 * c * o
    floats = (3 * m * o + 9 * c * o + m * c) if dx else \
        (m * c + 9 * c * o + o + m * o)
    return (lanes * flop / peaks.FLOAT32_3XTF32,
            lanes * 4 * floats / peaks.HBM_BYTES)


def least_time(launches):
    """Least seconds of a Counter {(shape, dx, lanes): count}."""
    return sum(max(launch_bound(s, dx, lanes)) * k
               for (s, dx, lanes), k in launches.items())


def chunks(rows, h, w):
    """Row counts of the chunks of an eval forward of `rows` rows."""
    step = max(1, MAX_PIXELS // (h * w))
    return [min(step, rows - i) for i in range(0, rows, step)]


def sweep_launches(trial, h, w, lanes, epochs, n_real, val_rows, T, folds,
                   batched):
    """Counter {(shape, dx, lanes): launches} of the conv kernel in one sweep
    call of one trial bucket. lanes: the lanes' folds (lane i trains fold
    lanes[i]); epochs: epochs each lane ran (batched: the epochs of the
    batched loop); n_real: each fold's batches holding a training row;
    val_rows: the val rows each epoch evaluates per lane; folds: the
    folds whose winner is run forward over the T rows."""
    got = Counter()
    bs = trial.batch_size
    step = conv_shapes(trial, bs, h, w)
    val = [conv_shapes(trial, r, h, w) for r in chunks(val_rows, h, w)]

    def add(shapes, dx, lanes_per_launch, times):
        for i, s in enumerate(shapes):
            if dx and i == 0:
                continue
            got[(s, dx, lanes_per_launch)] += times

    if batched:
        L = len(lanes)
        n_steps = max(n_real[f] for f in lanes)
        add(step, False, L, epochs * n_steps)
        add(step, True, L, epochs * n_steps)
        for v in val:
            add(v, False, L, epochs)
    else:
        for f, e in zip(lanes, epochs):
            add(step, False, 1, e * n_real[f])
            add(step, True, 1, e * n_real[f])
            for v in val:
                add(v, False, 1, e)
    for r in chunks(T, h, w):
        add(conv_shapes(trial, r, h, w), False, 1, len(folds))
    return got


def row_flops(trial, h, w, c_in=1, n_out=3):
    """(FLOP of one row in a training step, FLOP of one row in an eval
    forward) of the U-Net's convs, transposed convs and 1x1 head: a
    training row counts each one's forward, input gradient (not the first
    conv's) and weight gradient."""
    fwd = train = 0
    for i, (_, hh, ww, c, o) in enumerate(conv_shapes(trial, 1, h, w, c_in)):
        f = 2 * hh * ww * 9 * c * o
        fwd += f
        train += f * (2 if i == 0 else 3)
    kh, kw = trial.ct_kernel
    for k in range(trial.n_blocks, 0, -1):
        width = trial.filters * 4 * 2 ** (k - 1)
        c = trial.filters * 4 * 2 ** k
        f = 2 * (h >> k) * (w >> k) * kh * kw * c * width
        fwd += f
        train += 3 * f
    f = 2 * h * w * (trial.filters * 4) * n_out
    fwd += f
    train += 3 * f
    return train, fwd


def lane_epoch_flops(trial, h, w, n_train, n_val):
    """Model FLOP of one lane's epoch: its training rows' steps and its
    val forward."""
    tr, fw = row_flops(trial, h, w)
    return n_train * tr + n_val * fw


def n_real(train_mask, batch_size):
    """Batches of an epoch that hold a training row."""
    return math.ceil(int(train_mask.sum()) / batch_size)

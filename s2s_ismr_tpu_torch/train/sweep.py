"""The tuning sweep (port of s2s_ismr_tpu/train/sweep.py).

Reference behavior: per CV fold, iterate itertools.product(batch_sizes,
learning_rates, ct_kernels, n_filters, n_blocks); each trial builds a fresh
U-Net, fits it with checkpoint / early stop, and the trial with the lowest
best-epoch val_loss wins the fold, the *first* one in product order on ties.

Lanes (fold x trial) run one after another on one device (the JAX
package's serial lane dispatch). Eager torch has no compile to hide, so the
JAX program memo, compile-ahead and thread pools have no counterpart;
batched lanes and multi-GPU lanes are later work (ROADMAP).
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models import UNet, UNetConfig
from .engine import TrainSettings, predict, train_batches, train_fold


@dataclass(frozen=True)
class TuningGrid:
    """Mirrors the reference tuning_grid dict (tune_ECMWF_com.py:91-92)."""
    n_blocks: Sequence[int] = (3,)
    n_filters: Sequence[int] = (2, 3)
    ct_kernels: Sequence[Tuple[int, int]] = ((2, 2), (3, 3), (5, 5))
    batch_sizes: Sequence[int] = (16, 32)
    learning_rates: Sequence[float] = (1e-3, 1e-4)
    patience: int = 15


@dataclass(frozen=True)
class Trial:
    index: int                   # position in the reference's product order
    batch_size: int
    lr: float
    ct_kernel: Tuple[int, int]
    filters: int
    n_blocks: int

    def bucket_key(self):
        return (self.batch_size, self.ct_kernel, self.filters, self.n_blocks)

    def hparams(self):
        return {"batch_size": self.batch_size, "lr": self.lr,
                "ct_kernel": self.ct_kernel, "filters": self.filters,
                "blocks": self.n_blocks}


def enumerate_trials(grid: TuningGrid) -> List[Trial]:
    """Exact reference iteration order (training.py:87)."""
    return [Trial(i, bs, lr, tuple(kern), filt, blocks)
            for i, (bs, lr, kern, filt, blocks) in enumerate(
                itertools.product(grid.batch_sizes, grid.learning_rates,
                                  grid.ct_kernels, grid.n_filters,
                                  grid.n_blocks))]


def bucket_trials(trials: List[Trial]) -> Dict[tuple, List[Trial]]:
    buckets: Dict[tuple, List[Trial]] = {}
    for t in trials:
        buckets.setdefault(t.bucket_key(), []).append(t)
    return buckets


@dataclass
class SweepResult:
    """Per-fold winners + the full val-loss table for diagnostics."""
    best_val_loss: np.ndarray            # (F,)
    best_trial: List[Trial]              # per fold
    predictions: torch.Tensor            # (F, T, H, W, 3) winner preds,
    # on the sweep's device
    val_loss_table: np.ndarray           # (F, n_trials) in product order
    winner_variables: List[Any]          # per fold: state_dict
    winner_configs: List[UNetConfig]     # per fold
    train_steps: int = 0                 # optimizer steps executed
    epochs_run: int = 0                  # epochs executed, summed over lanes
    timings: Dict[str, float] = field(default_factory=dict)  # phase seconds


def lane_generator(base_seed, fold_idx, trial_idx) -> torch.Generator:
    """Deterministic per-(fold, trial) CPU generator for init and batch
    order, standing in for the reference's reset_random_seeds()."""
    seed = np.random.SeedSequence([base_seed, fold_idx, trial_idx])
    return torch.Generator().manual_seed(int(seed.generate_state(1)[0]))


def build_winner(config: UNetConfig, state, in_channels, device="cpu"):
    """A fresh U-Net holding `state`. The sweep's winner forward and the
    checkpoint replay both build the model this way, so a reloaded winner
    runs exactly the computation the sweep ran."""
    # a private generator: the throw-away init must not draw from the
    # global RNG
    model = UNet(config, in_channels, generator=torch.Generator(),
                 device=device)
    model.load_state_dict(state)
    return model


def run_unet_sweep(x, y_oh_folds, train_masks, val_masks,
                   grid: TuningGrid, epochs: int = 100, base_seed: int = 42,
                   device="cpu") -> SweepResult:
    """Run the full tuning sweep, lane after lane, each with early exit.

    x:           (T, H, W, C) predictor images
    y_oh_folds:  (F, T, H, W, 3) per-fold one-hot labels
    train_masks: (F, T) bool; val_masks: (F, T) bool
    device:      where the lanes train
    """
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    y_oh_folds = torch.as_tensor(y_oh_folds, dtype=torch.float32).to(device)
    train_masks = np.asarray(train_masks, bool)
    val_masks = np.asarray(val_masks, bool)
    F, T = train_masks.shape
    val_rows = int(val_masks.sum(1).max())

    trials = enumerate_trials(grid)
    val_table = np.full((F, len(trials)), np.inf, np.float32)
    lane_state: Dict[Tuple[int, int], Any] = {}
    lane_vloss: Dict[Tuple[int, int], torch.Tensor] = {}
    total_steps = total_epochs = 0

    def config(t: Trial):
        return UNetConfig(filters=t.filters, n_blocks=t.n_blocks,
                          ct_kernel=t.ct_kernel)

    t0 = time.perf_counter()
    for key_, bucket in bucket_trials(trials).items():
        settings = TrainSettings(epochs=epochs, batch_size=key_[0],
                                 patience=grid.patience, val_rows=val_rows,
                                 early_exit=True)
        for f in range(F):
            n_real = train_batches(int(train_masks[f].sum()), key_[0])
            for t in bucket:
                gen = lane_generator(base_seed, f, t.index)
                model = UNet(config(t), x.shape[-1], generator=gen,
                             device=device)
                best, vloss, hist = train_fold(
                    model, x, y_oh_folds[f], train_masks[f], val_masks[f],
                    t.lr, gen, settings)
                n_ep = int(torch.isfinite(hist).sum())
                total_epochs += n_ep
                total_steps += n_ep * n_real
                lane_state[f, t.index] = best
                lane_vloss[f, t.index] = vloss
    t_execute = time.perf_counter() - t0

    t0 = time.perf_counter()
    keys = list(lane_vloss)
    vl = torch.stack([lane_vloss[k] for k in keys]).cpu().numpy()
    for (f, ti), v in zip(keys, vl):
        val_table[f, ti] = v
    # winner per fold: first minimum in product order (reference tie-break
    # via `<`, training.py:108); np.argmin returns the first minimum
    best_idx = np.argmin(val_table, axis=1)
    best_trials = [trials[i] for i in best_idx]
    winner_cfgs = [config(t) for t in best_trials]
    winner_vars, preds = [], []
    for f, t in enumerate(best_trials):
        state = lane_state[f, t.index]
        winner_vars.append(state)
        model = build_winner(winner_cfgs[f], state, x.shape[-1], device)
        preds.append(predict(model, None, x))
    return SweepResult(
        best_val_loss=val_table[np.arange(F), best_idx],
        best_trial=best_trials,
        predictions=torch.stack(preds),
        val_loss_table=val_table,
        winner_variables=winner_vars,
        winner_configs=winner_cfgs,
        train_steps=total_steps,
        epochs_run=total_epochs,
        timings={"execute_s": t_execute,
                 "collect_s": time.perf_counter() - t0})

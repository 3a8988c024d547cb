"""The tuning sweep (port of s2s_ismr_tpu/train/sweep.py).

Reference behavior: per CV fold, iterate itertools.product(batch_sizes,
learning_rates, ct_kernels, n_filters, n_blocks); each trial builds a fresh
U-Net, fits it with checkpoint / early stop, and the trial with the lowest
best-epoch val_loss wins the fold, the *first* one in product order on ties.

Lanes (fold x trial) run as the JAX sweep's `lane_dispatch` says:
  * 'serial' (and 'auto' without a mesh, JAX's default): one lane after
    another on one device, each through `train_fold`, each stopping at its
    own early-stop epoch;
  * 'vmap': each bucket's F folds x R learning rates as L = F*R batched
    lanes through `engine.train_lanes` (one vmapped step for all lanes, the
    conv kernel's lane mode), running to the last lane's stop;
  * a mesh (`parallel.mesh`): the bucket's lanes, flattened lane-major and
    padded to a device multiple with copies of lane 0, cut into one block
    per device, each device running its block in a thread of its own, lane
    after lane ('auto') or batched ('vmap').
Every lane trains through the engine's programs (`programs`, JAX's program
memo): the lanes of a bucket and fold share one program, and so do the MME
models and suite configs of the same shapes; each lane's learning rate,
data and initial weights are the program's inputs. The winner forwards are
programs too (`engine.predict`). A capture takes about a second, so the
JAX sweep's compile-ahead and compile thread pools have no counterpart.

`run_fixed_training` is the fixed single-configuration training of the
cnn/mlp models and of training_type='train': one lane per fold.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import device as devices
from .. import profiling
from ..models import UNet, UNetConfig
from ..parallel import mesh as pmesh
from .engine import (TrainSettings, predict, train_batches, train_fold,
                     train_lanes)

# model_factory(generator) -> a fresh module on the run's device, its
# parameters drawn from the generator
ModelFactory = Callable[[torch.Generator], nn.Module]


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
    epochs_table: np.ndarray | None = None   # (F, n_trials) epochs each
    # lane ran, in product order (its steps: epochs x train_batches)


def lane_generator(base_seed, fold_idx, trial_idx, device="cpu",
                   stream=0) -> torch.Generator:
    """Deterministic per-(fold, trial) generator, standing in for the
    reference's reset_random_seeds(): stream 0 on the CPU draws the init
    and the batch orders, stream 1 on the lane's device the dropout
    masks."""
    seed = np.random.SeedSequence([base_seed, fold_idx, trial_idx])
    return torch.Generator(device=device).manual_seed(
        int(seed.generate_state(stream + 1)[stream]))


def rebuild(model_factory: ModelFactory, state):
    """A fresh model from the factory holding `state`. Every winner forward
    (the sweep's, the fixed training's) and the checkpoint replay build
    the model this way, so a reloaded winner runs exactly the computation
    the run did."""
    # a private generator: the throw-away init must not draw from the
    # global RNG
    model = model_factory(torch.Generator())
    model.load_state_dict(state)
    return model


def build_winner(config: UNetConfig, state, in_channels, device=None):
    """A fresh U-Net of `config` holding `state`, on `device` (None: the
    card)."""
    device = devices.resolve(device)
    return rebuild(lambda g: UNet(config, in_channels, generator=g,
                                  device=device), state)


def _settings(epochs, batch_size, patience, val_masks, early_exit, output):
    if output not in ("proba", "deterministic"):
        raise ValueError(f"output must be 'proba' or 'deterministic', got "
                         f"{output!r}")
    # the deterministic head regresses raw precipitation (NaN-masked MSE)
    return TrainSettings(epochs=epochs, batch_size=batch_size,
                         patience=patience,
                         val_rows=int(np.asarray(val_masks).sum(1).max()),
                         early_exit=early_exit,
                         loss=("mse" if output == "deterministic"
                               else "categorical_crossentropy"))


def _overrides(lane_overrides, f, trial_idx):
    """train_fold's init_variables / epoch_perms for lane (f, trial_idx)
    from the test seam, or none."""
    if lane_overrides is None:
        return {}
    with profiling.span("sweep.overrides"):
        init, perms = lane_overrides(f, trial_idx)
    return {"init_variables": init, "epoch_perms": perms}


_DISPATCH = ("auto", "serial", "vmap")


def _lane_models(lanes, config, in_channels, base_seed, device):
    """Per lane (f, trial) of `lanes`: its U-Net on `device` drawn from its
    lane generator, the generator (batch orders next) and its dropout
    generator on `device`."""
    with profiling.span("sweep.lane_models"):
        gens = [lane_generator(base_seed, f, t.index) for f, t in lanes]
        models = [UNet(config(t), in_channels, generator=g, device=device)
                  for (f, t), g in zip(lanes, gens)]
        drops = [lane_generator(base_seed, f, t.index, device, stream=1)
                 for f, t in lanes]
    return models, gens, drops


def _train_serial(lanes, ctx, device):
    """Lanes one after another through train_fold on `device`: [(best
    state, best val loss, epochs run)]."""
    x, y, tm, vm, config, settings, base_seed, overrides = ctx
    models, gens, drops = _lane_models(lanes, config, x.shape[-1],
                                       base_seed, device)
    out = []
    for (f, t), model, gen, drop in zip(lanes, models, gens, drops):
        best, vloss, hist = train_fold(
            model, x, y[f], tm[f], vm[f], t.lr, gen, settings,
            dropout_generator=drop, **_overrides(overrides, f, t.index))
        with profiling.span("engine.wait"):        # the lane's last epoch
            n_ep = int(torch.isfinite(hist).sum())
        out.append((best, vloss, n_ep))
    return out, 0, 0


def _train_batched(lanes, ctx, device):
    """The lanes batched through train_lanes on `device`: [(best state,
    best val loss, epochs run)], batched steps, batched epochs."""
    x, y, tm, vm, config, settings, base_seed, overrides = ctx
    models, gens, drops = _lane_models(lanes, config, x.shape[-1],
                                       base_seed, device)
    fs = [f for f, _ in lanes]
    ov = [_overrides(overrides, f, t.index) for f, t in lanes]
    res = train_lanes(
        models, x, y[fs], tm[fs], vm[fs], [t.lr for _, t in lanes], gens,
        settings, init_variables=[o.get("init_variables") for o in ov],
        epoch_perms=[o.get("epoch_perms") for o in ov],
        dropout_generators=drops)
    with profiling.span("engine.wait"):            # the lanes' last epoch
        n_ep = torch.isfinite(res.hist).sum(1).tolist()
    return (list(zip(res.best, res.best_vloss, n_ep)), res.batched_steps,
            res.batched_epochs)


def _mesh_lanes(lanes, ctx, mesh, local, device):
    """The bucket's lanes sharded over the mesh: flattened lane-major,
    padded to a device multiple with copies of lane 0, one contiguous
    block per device, run there lane after lane through train_fold (local
    'scan') or batched through train_lanes ('vmap'); results gathered on
    `device`, the pad lanes dropped."""
    pad = (-len(lanes)) % mesh.size
    ids = torch.tensor(list(range(len(lanes))) + [0] * pad)

    def run(xd, yd, tmd, vmd, idx):
        # one lane ('scan': idx 0-d) or the device's block ('vmap')
        train = _train_batched if local == "vmap" else _train_serial
        out, _, _ = train([lanes[i] for i in idx.reshape(-1).tolist()],
                          (xd, yd, tmd, vmd) + ctx[4:], xd.device)
        best, vloss, n_ep = zip(*out)
        n_ep = torch.tensor(n_ep, device=xd.device)
        if local == "scan":
            return best[0], vloss[0], n_ep[0]
        return ({k: torch.stack([b[k] for b in best]) for k in best[0]},
                torch.stack(vloss), n_ep)

    fn = pmesh.shard_map_lanes(run, mesh, n_shared=4, local=local)
    return _unflatten_lanes(fn(*ctx[:4], ids), len(lanes), device)


def _unflatten_lanes(out, n, device):
    """Gathered lane-major mesh outputs (best states, val losses, epochs
    run) back to per-lane tuples on `device`, the pad lanes dropped."""
    best, vloss, n_ep = out
    return [({k: v[i].to(device) for k, v in best.items()},
             vloss[i].to(device), int(n_ep[i])) for i in range(n)]


def run_unet_sweep(x, y_oh_folds, train_masks, val_masks,
                   grid: TuningGrid, epochs: int = 100, base_seed: int = 42,
                   output: str = "proba", device=None,
                   lane_overrides=None, lane_dispatch: str = "auto",
                   mesh=None, conv_backend: str = "auto",
                   compute_dtype: str = "auto") -> SweepResult:
    """Run the full tuning sweep; every lane stops early on patience.

    x:           (T, H, W, C) predictor images
    y_oh_folds:  (F, T, H, W, 3) per-fold one-hot labels, or for
                 output='deterministic' (F, T, H, W, 1) raw targets (NaN
                 where the loss ignores them)
    train_masks: (F, T) bool; val_masks: (F, T) bool
    device:      where the lanes train (None: the card), and, with a mesh,
                 where the results and the winner forwards go
    lane_dispatch: 'serial' (lane after lane), 'vmap' (each bucket's
                 folds x learning rates batched through train_lanes) or
                 'auto': serial without a mesh, as in JAX. 'serial' with a
                 mesh is refused: a mesh runs each device's lanes in turn
                 ('auto') or batched ('vmap')
    mesh:        optional parallel.mesh.Mesh sharding each bucket's lanes
                 over its devices (sweep_mesh())
    lane_overrides: optional (fold, trial index) -> (init state_dict,
                 (epochs, T) batch orders) used instead of the lane
                 generator's (a test seam: feeds JAX's init and batch
                 orders)
    conv_backend, compute_dtype: the UNetConfig fields of every trial
    timings reports execute_s, collect_s and lane_dispatch ('serial',
    'vmap' or 'mesh'); a 'vmap' sweep also the batched loop's
    batched_steps and batched_epochs, summed over buckets; and the call's
    spans ({name: total seconds}).
    train_steps counts every lane's own steps (its epochs run times its
    batches holding a training sample) in every mode; epochs_table holds
    each lane's epochs run, so a lane's steps and depth can be read apart.
    The call is the span `sweep.call` and a call record (profiling.call)
    with the counter `lane_steps` (= train_steps).
    """
    with profiling.call("sweep.call") as rec:
        res = _sweep(x, y_oh_folds, train_masks, val_masks, grid, epochs,
                     base_seed, output, device, lane_overrides,
                     lane_dispatch, mesh, conv_backend, compute_dtype)
    rec.count("lane_steps", res.train_steps)
    res.timings["spans"] = rec.totals()
    return res


def _sweep(x, y_oh_folds, train_masks, val_masks, grid, epochs, base_seed,
           output, device, lane_overrides, lane_dispatch, mesh,
           conv_backend, compute_dtype):
    if lane_dispatch not in _DISPATCH:
        raise ValueError(f"lane_dispatch={lane_dispatch!r}: one of "
                         f"{_DISPATCH}")
    if lane_dispatch == "serial" and mesh is not None:
        raise ValueError("lane_dispatch='serial' is a single-device "
                         "execution model; mesh sweeps shard the lane axis "
                         "and run each device's lanes in turn")
    mode = ("mesh" if mesh is not None else
            "vmap" if lane_dispatch == "vmap" else "serial")
    device = devices.resolve(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    y_oh_folds = torch.as_tensor(y_oh_folds, dtype=torch.float32).to(device)
    train_masks = np.asarray(train_masks, bool)
    val_masks = np.asarray(val_masks, bool)
    F, T = train_masks.shape
    tm = torch.as_tensor(train_masks, device=device)
    vm = torch.as_tensor(val_masks, device=device)

    trials = enumerate_trials(grid)
    val_table = np.full((F, len(trials)), np.inf, np.float32)
    epochs_table = np.zeros((F, len(trials)), np.int64)
    lane_state: Dict[Tuple[int, int], Any] = {}
    lane_vloss: Dict[Tuple[int, int], torch.Tensor] = {}
    total_steps = total_epochs = batched_steps = batched_epochs = 0

    def config(t: Trial):
        return UNetConfig(filters=t.filters, n_blocks=t.n_blocks,
                          ct_kernel=t.ct_kernel, output=output,
                          conv_backend=conv_backend,
                          compute_dtype=compute_dtype)

    with profiling.span("sweep.execute") as execute:
        for key_, bucket in bucket_trials(trials).items():
            settings = _settings(epochs, key_[0], grid.patience, val_masks,
                                 True, output)
            lanes = [(f, t) for f in range(F) for t in bucket]
            ctx = (x, y_oh_folds, tm, vm, config, settings, base_seed,
                   lane_overrides)
            if mode == "mesh":
                results = _mesh_lanes(lanes, ctx, mesh, "vmap" if
                                      lane_dispatch == "vmap" else "scan",
                                      device)
            else:
                train = _train_batched if mode == "vmap" else _train_serial
                results, steps, n_epochs = train(lanes, ctx, device)
                batched_steps += steps
                batched_epochs += n_epochs
            for (f, t), (best, vloss, n_ep) in zip(lanes, results):
                epochs_table[f, t.index] = n_ep
                total_epochs += n_ep
                total_steps += n_ep * train_batches(
                    int(train_masks[f].sum()), key_[0])
                lane_state[f, t.index] = best
                lane_vloss[f, t.index] = vloss

    with profiling.span("sweep.collect") as collect:
        keys = list(lane_vloss)
        vl = torch.stack([lane_vloss[k] for k in keys]).cpu().numpy()
        for (f, ti), v in zip(keys, vl):
            val_table[f, ti] = v
        # winner per fold: first minimum in product order (reference
        # tie-break via `<`, training.py:108); np.argmin returns the first
        # minimum
        best_idx = np.argmin(val_table, axis=1)
        best_trials = [trials[i] for i in best_idx]
        winner_cfgs = [config(t) for t in best_trials]
        winner_vars, preds = [], []
        for f, t in enumerate(best_trials):
            state = lane_state[f, t.index]
            winner_vars.append(state)
            with profiling.span("sweep.winners"):
                model = build_winner(winner_cfgs[f], state, x.shape[-1],
                                     device)
            preds.append(predict(model, None, x))
    timings = {"execute_s": execute.seconds,
               "collect_s": collect.seconds,
               "lane_dispatch": mode}
    if mode == "vmap":
        timings.update(batched_steps=batched_steps,
                       batched_epochs=batched_epochs)
    return SweepResult(
        best_val_loss=val_table[np.arange(F), best_idx],
        best_trial=best_trials,
        predictions=torch.stack(preds),
        val_loss_table=val_table,
        winner_variables=winner_vars,
        winner_configs=winner_cfgs,
        train_steps=total_steps,
        epochs_run=total_epochs,
        timings=timings,
        epochs_table=epochs_table)


@dataclass
class FixedResult:
    """Per-fold outcome of one configuration trained over every fold."""
    val_loss: np.ndarray                 # (F,) best-epoch val loss
    predictions: torch.Tensor            # (F, T, H, W, n_out), on the
    # run's device
    winner_variables: List[Any]          # per fold: state_dict
    train_steps: int = 0                 # optimizer steps executed
    epochs_run: int = 0                  # epochs executed, summed over folds


def run_fixed_training(model_factory: ModelFactory, x, y_oh_folds,
                       train_masks, val_masks, lr: float = 1e-3,
                       batch_size: int = 16, epochs: int = 100,
                       patience: int = 10, base_seed: int = 42,
                       early_exit: bool = True, output: str = "proba",
                       device=None, lane_overrides=None) -> FixedResult:
    """One configuration over every fold, lane after lane: the cnn/mlp
    branch (training.py:53-64) and training_type='train'
    (training.py:119-125), port of the JAX run_fixed_training.

    model_factory(generator) builds a fresh model on `device` (None: the
    card); fold f's lane draws its init and batch orders from
    lane_generator(base_seed, f, 0), as JAX keys it _lane_keys(base_seed,
    f, 0). The reference's 'train' branch has no EarlyStopping
    (ModelCheckpoint only), so callers replicating it pass
    early_exit=False: all epochs run and the best-val weights are kept.
    output='deterministic' regresses raw targets with NaN-masked MSE.
    Winners are rebuilt and predicted as the sweep's are.

    lane_overrides: as run_unet_sweep's, called with trial index 0."""
    device = devices.resolve(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    y_oh_folds = torch.as_tensor(y_oh_folds, dtype=torch.float32).to(device)
    train_masks = np.asarray(train_masks, bool)
    settings = _settings(epochs, batch_size, patience, val_masks, early_exit,
                         output)
    vloss, states, preds = [], [], []
    steps = n_epochs = 0
    for f in range(train_masks.shape[0]):
        gen = lane_generator(base_seed, f, 0)
        best, v, hist = train_fold(
            model_factory(gen), x, y_oh_folds[f], train_masks[f],
            val_masks[f], lr, gen, settings,
            dropout_generator=lane_generator(base_seed, f, 0, device,
                                             stream=1),
            **_overrides(lane_overrides, f, 0))
        n_ep = int(torch.isfinite(hist).sum())
        n_epochs += n_ep
        steps += n_ep * train_batches(int(train_masks[f].sum()), batch_size)
        vloss.append(v)
        states.append(best)
        preds.append(predict(rebuild(model_factory, best), None, x))
    return FixedResult(val_loss=torch.stack(vloss).cpu().numpy(),
                       predictions=torch.stack(preds),
                       winner_variables=states, train_steps=steps,
                       epochs_run=n_epochs)

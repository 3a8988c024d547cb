"""The tune pipeline's NN branch (port of s2s_ismr_tpu/pipelines/tune.py).

Reference flow of the NN branch (tune_ECMWF_com.py): year-bootstrap
splits, per-fold rolling tercile labels fit on the fold's train years,
the grid-search tuning sweep, then RPSS of the fold winners against the
constant-1/3 climatology, per fold and split.

This slice covers the U-Net / `tune` / `proba` / `mean`-predictor /
single-model path. The ELR branch and `run_pipeline` come with the next
slice; the other branches raise NotImplementedError naming their ROADMAP
item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Dict

import numpy as np
import torch

from s2s_ismr_tpu import timeutils
from s2s_ismr_tpu.data.bundle import DataBundle
from s2s_ismr_tpu.field import Field
from s2s_ismr_tpu.grid import check_divisible
from s2s_ismr_tpu.train import splits

from ..ops import metrics, terciles
from ..train.sweep import SweepResult, TuningGrid, run_unet_sweep
from .configs import PipelineConfig

_LATER = {
    "elr": "the ELR branch and run_pipeline (ROADMAP queue A items 10-11)",
    "flags": "the remaining flag surface (ROADMAP queue A item 13)",
    "mme": "MME blending, with the ELR slice (ROADMAP queue A items 10-11)",
}


def _later(what, key):
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"{_LATER[key]}")


# ----------------------------------------------------------------- data load
def load_bundles(cfg: PipelineConfig, source="synthetic", seed=0,
                 synthetic_step=None) -> Dict[str, DataBundle]:
    """One DataBundle per model from the synthetic generator."""
    if source != "synthetic":
        raise _later(f"source={source!r}", "elr")
    from s2s_ismr_tpu.data import synthetic
    step = synthetic_step or (cfg.regrid or 1.0)
    # native-grid configs (regrid=None) carry explicit point counts; an
    # explicit step overrides them (smoke runs shrink the grid)
    gshape = None if synthetic_step else cfg.synthetic_grid
    if cfg.is_mme:
        xs, _ = synthetic.synthetic_ensemble(
            models=cfg.models, seed=seed, years=cfg.years,
            season=cfg.season, domain=cfg.domain, step=step,
            lead=cfg.lead(cfg.models[0]), grid_shape=gshape)
        return xs
    return {cfg.models[0]: synthetic.synthetic_hindcast(
        model=cfg.models[0], obs=cfg.obs, years=cfg.years,
        season=cfg.season, domain=cfg.domain, step=step, seed=seed,
        lead=cfg.lead(), grid_shape=gshape)}


def _apply_pad(cfg: PipelineConfig, b: DataBundle) -> DataBundle:
    """ECMWF full-period 23->24 Y pad with synthetic lat + zero fill
    (tune_ECMWF_full.py:50-57)."""
    if cfg.pad_y_rows == 0:
        return b
    py = cfg.pad_y_rows
    x = np.pad(b.x, ((0, 0), (0, 0), (0, py), (0, 0)))
    y = np.pad(b.y, ((0, 0), (0, py), (0, 0)))
    lats = np.concatenate([b.lats, [cfg.pad_lat_value] * py])
    return replace(b, x=x, y=y, lats=lats)


# --------------------------------------------------------------- NN branch
@dataclass
class NNResult:
    rpss_train: Field
    rpss_val: Field
    rpss_test: Field
    predictions: torch.Tensor       # (F, T, Y, X, 3) winner predictions
    labels: np.ndarray              # (F, T, Y, X)
    masks: splits.FoldMasks
    sweeps: Dict[str, SweepResult]
    best_hparams: list


def _nn_setup(cfg: PipelineConfig, bundles, log, device="cpu"):
    """NN-branch preamble: fillna, year-bootstrap splits, per-fold rolling
    tercile labels fit on each fold's train years only.

    Returns (names, filled, first, fold masks, labels (F,T,Y,X) numpy,
    one-hot (F,T,Y,X,3) tensor with NaN -> 0, (edges, present) per fold).
    """
    names = list(bundles)
    if cfg.is_mme:
        raise _later("an MME config", "mme")
    if cfg.predictor != "mean":
        raise _later(f"predictor={cfg.predictor!r}", "flags")
    filled = {n: b.fillna(0.0) for n, b in bundles.items()}
    first = filled[names[0]]
    fm = splits.bootstrap_masks(first.years, cfg.n_bootstraps,
                                frac_valid=cfg.nn_frac_valid,
                                frac_test=cfg.nn_frac_test)
    for i in range(fm.n_folds):
        log(f"[nn] fold {i + 1}: train={sorted(fm.train_years[i])} "
            f"val={sorted(fm.val_years[i])} test={sorted(fm.test_years[i])}")

    wm = timeutils.week_window_matrix(1)
    y = torch.as_tensor(first.y, device=device)
    fits = [terciles.fit_and_label(y, first.weeks, fm.train[f], wm, None)
            for f in range(fm.n_folds)]
    lab = torch.stack([f[0] for f in fits])
    edges = torch.stack([f[1] for f in fits])
    present = torch.stack([f[2] for f in fits])
    y_oh = torch.nan_to_num(terciles.one_hot_labels(lab), nan=0.0)
    return (names, filled, first, fm, lab.cpu().numpy(), y_oh,
            (edges, present))


def _nn_rpss(filled, names, preds, labels):
    """RPSS of the winner predictions vs the constant-1/3 climatology of
    the last-iterated model's predictor (performance_metrics.py:11-23)."""
    dev = preds.device
    climo = metrics.climo_forecast(
        torch.as_tensor(filled[names[-1]].ensemble_mean(), device=dev))
    labels = torch.as_tensor(labels, device=dev)

    def _r(mask_set):
        return torch.stack([
            metrics.rpss(climo, preds[f], labels[f], mask_set[f])
            for f in range(len(mask_set))]).cpu().numpy()
    return _r


def resolve_batch_sizes(grid: TuningGrid, T: int) -> TuningGrid:
    """Resolve the batch-size sentinel 0 = 'full' to the training-set
    length (a documented non-parity opt-in, never a default)."""
    if 0 not in grid.batch_sizes:
        return grid
    seen = []
    for b in (T if b == 0 else b for b in grid.batch_sizes):
        if b not in seen:
            seen.append(b)           # dedupe: T may collide with explicit bs
    return replace(grid, batch_sizes=tuple(seen))


def run_nn_branch(cfg: PipelineConfig, bundles, log=print,
                  training_type="tune", device="cpu") -> NNResult:
    """The NN branch of a tune run on `device`: splits, labels, the U-Net
    sweep and RPSS maps (train / val / test) per fold."""
    if cfg.architecture != "unet":
        raise _later(f"architecture={cfg.architecture!r}", "flags")
    if cfg.output != "proba":
        raise _later(f"output={cfg.output!r}", "flags")
    if training_type != "tune":
        raise _later(f"training_type={training_type!r}", "flags")
    names, filled, first, fm, labels, y_oh, _ = \
        _nn_setup(cfg, bundles, log, device)

    sweeps: Dict[str, SweepResult] = {}
    n = names[0]
    x = filled[n].predictor_images(cfg.predictor)
    try:
        check_divisible(x.shape[1], x.shape[2], max(cfg.tuning.n_blocks))
    except ValueError as e:
        raise ValueError(f"model {n}: {e} — choose a domain/step that "
                         f"yields a divisible grid or pad via "
                         f"DataBundle.pad_to_grid") from None
    t0 = time.time()
    grid_n = resolve_batch_sizes(cfg.tuning, int(x.shape[0]))
    res = run_unet_sweep(x, y_oh, fm.train, fm.val, grid_n,
                         epochs=cfg.epochs, device=device)
    log(f"[nn] model {n}: sweep of {res.val_loss_table.shape[1]} trials x "
        f"{fm.n_folds} folds in {time.time() - t0:.1f}s {res.timings}; "
        f"winners={[t.hparams() for t in res.best_trial]}")
    sweeps[n] = res

    preds = res.predictions
    _r = _nn_rpss(filled, names, preds, labels)
    coords = {"Y": first.lats, "X": first.lons}

    def field(masks):
        return Field(_r(masks), ("bootstrap", "Y", "X"), coords, "rpss")
    return NNResult(
        rpss_train=field(fm.train), rpss_val=field(fm.val),
        rpss_test=field(fm.test),
        predictions=preds, labels=labels, masks=fm, sweeps=sweeps,
        best_hparams=[{n: t.hparams()} for t in res.best_trial])

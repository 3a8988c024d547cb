"""The tune pipeline runner (port of s2s_ismr_tpu/pipelines/tune.py):
one call = one reference tune_*.py script.

Reference flow (tune_ECMWF_com.py:22-186): data fetch -> ELR branch
(year-bootstrap splits, per-pixel GLM, RPSS netcdfs) -> NN branch (splits,
grid-search tuning, RPSS netcdfs) -> skill mask -> checkpoints. MME configs
blend per-model tercile probabilities and renormalize (training.py:344-350,
622-626).

Every entry point takes `device=` (None: the card, never a fallback to the
CPU); tensors live there from labeling to RPSS, and the host moves data in
and writes the outputs tree of the JAX CLI. The NN branch runs the U-Net
sweep (`training_type='tune'`), the fixed training of one configuration
(cnn/mlp, and `'train'` for any architecture) or the replay of saved
winners (`'load'`), with the proba or deterministic head and the mean,
multi_predictor or stacked predictor.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field, replace
from typing import Dict

import numpy as np
import torch

from .. import device as devices
from .. import timeutils
from ..data.bundle import DataBundle
from ..field import Field
from ..grid import check_divisible
from ..io import write_netcdf
from ..ops import elr as elr_ops
from ..ops import metrics, terciles
from ..profiling import StageTimer, trace
from ..train import checkpoint, splits
from ..models import UNetConfig
from ..train.engine import predict
from ..train.sweep import (SweepResult, TuningGrid, enumerate_trials,
                           run_fixed_training, run_unet_sweep)
from .configs import PipelineConfig

# ----------------------------------------------------------------- data load
def load_bundles(cfg: PipelineConfig, source="synthetic", seed=0,
                 synthetic_step=None, download=True) -> Dict[str, DataBundle]:
    """One DataBundle per model, from the synthetic generator or the IRIDL
    gateway (the port's copy of the JAX package's numpy host code)."""
    if source == "synthetic":
        from ..data import synthetic
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
    if source == "iridl":
        from ..data import gateway
        out = {}
        for m in cfg.models:
            x, y = gateway.get_data(
                years=cfg.years, download=download, week=cfg.week, model=m,
                obs=cfg.obs, domain=cfg.domain.as_tuple(), season=cfg.season,
                regrid=cfg.regrid, custom_lead=cfg.lead(m))
            out[m] = gateway.to_bundle(x, y, name=f"{m}_{cfg.obs}")
        if cfg.is_mme:
            out = _align_mme(out)
        return out
    raise ValueError(f"unknown source {source!r}")


def _align_mme(bundles: Dict[str, DataBundle]) -> Dict[str, DataBundle]:
    """T-midpoint alignment across models (tune_MME.py:66-81)."""
    names = list(bundles)
    t1 = bundles[names[0]].t
    t2 = bundles[names[1]].t
    mid = t1 + (t2 - t1) / 2
    out = {}
    for n, b in bundles.items():
        if len(b.t) != len(mid):
            raise ValueError(f"MME model {n} time axis length mismatch")
        out[n] = replace(b, t=mid)
    return out


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


def _rpss_fields(climo, preds, labels, coords):
    """RPSS Field (bootstrap, Y, X) of all folds for one mask set."""
    def fld(masks):
        r = metrics.rpss_folds(climo, preds, labels, masks)
        return Field(r.cpu().numpy(), ("bootstrap", "Y", "X"), coords, "rpss")
    return fld


# -------------------------------------------------------------- ELR branch
@dataclass
class ElrResult:
    rpss_train: Field
    rpss_test: Field
    test_probs: torch.Tensor        # (F, T, Y, X, 3), on the branch's device
    labels: np.ndarray              # (F, T, Y, X) degenerate-masked labels
    masks: splits.FoldMasks


def _elr_fit_folds(y, weeks, train_masks, wm):
    """Per fold: rolling tercile edges fit on the fold's train years, the
    cumulative ELR targets and the degenerate-masked labels. Folds run one
    after another: one fold's masked sort is (53, T, P), and all folds at
    once would be several GB on the 64x64 configs.
    Returns targets (F, 2, T, *S) and labels (F, T, *S)."""
    targets, labels = [], []
    for pm in train_masks:
        e, p = terciles.rolling_edges(y, weeks, pm, wm)
        targets.append(terciles.elr_targets(y, weeks, e, p))
        labels.append(terciles.label_terciles(y, weeks, e, p, True))
    return torch.stack(targets), torch.stack(labels)


def run_elr_branch(cfg: PipelineConfig, bundles, log=print,
                   device=None) -> ElrResult:
    """The ELR baseline of a tune run on `device` (None: the card):
    year-bootstrap splits, per-fold labels, the pixel-parallel GLM of
    every model (blended for MME), and RPSS maps (train / test) per
    fold."""
    device = devices.resolve(device)
    names = list(bundles)
    first = bundles[names[0]]
    y_shared = np.mean(np.stack([bundles[n].y for n in names]), axis=0) \
        if cfg.is_mme else first.y
    fm = splits.bootstrap_masks_elr(first.years, cfg.n_bootstraps,
                                    frac_test=cfg.elr_frac_test)
    wm = timeutils.week_window_matrix(1)
    y_dev = torch.as_tensor(y_shared, device=device)
    targets, labels = _elr_fit_folds(y_dev, first.weeks, fm.train, wm)

    per_model_probs = []
    for n in names:
        xm = torch.as_tensor(bundles[n].ensemble_mean(), device=device)
        probs = elr_ops.elr_folds(xm, targets, fm.train, fm.test, y_dev)
        per_model_probs.append(probs)
        log(f"[elr] model {n}: fitted {tuple(probs.shape)}")
    probs = (elr_ops.blend_probabilities(per_model_probs) if cfg.is_mme
             else per_model_probs[0])

    # climo reference from the last-iterated model's predictor, matching
    # the reference's loop-variable quirk (training.py:636-640)
    climo = metrics.climo_forecast(
        torch.as_tensor(bundles[names[-1]].ensemble_mean(), device=device))
    fld = _rpss_fields(climo, probs, labels,
                       {"Y": first.lats, "X": first.lons})
    return ElrResult(rpss_train=fld(fm.train), rpss_test=fld(fm.test),
                     test_probs=probs, labels=labels.cpu().numpy(), masks=fm)


# --------------------------------------------------------------- NN branch
@dataclass
class NNResult:
    rpss_train: Field
    rpss_val: Field
    rpss_test: Field
    predictions: torch.Tensor       # (F, T, Y, X, 3) blended winner preds
    labels: np.ndarray              # (F, T, Y, X)
    masks: splits.FoldMasks
    sweeps: Dict[str, SweepResult]
    best_hparams: list
    fixed_winners: Dict[str, tuple] = field(default_factory=dict)
    # per model: (state_dicts, val losses (F,), UNetConfig | None) of a
    # fixed (non-grid) training: cnn/mlp, and unet training_type='train'
    train_steps: int = 0            # optimizer steps executed, all models
    epochs_run: int = 0             # epochs executed, summed over lanes


def _nn_setup(cfg: PipelineConfig, bundles, log, device=None):
    """NN-branch preamble: fillna (and the stacked predictor's member
    tiling), year-bootstrap splits, per-fold rolling tercile labels fit on
    each fold's train years only (preprocessing.py:415), on the
    cross-model mean obs for MME.

    Returns (names, filled, first, fold masks, labels (F,T,Y,X) numpy,
    one-hot (F,T,Y,X,3) tensor with NaN -> 0, (edges, present) per fold).
    """
    device = devices.resolve(device)
    names = list(bundles)
    filled = {n: b.fillna(0.0) for n, b in bundles.items()}
    if cfg.predictor == "stacked" and cfg.is_mme:
        raise ValueError(
            "predictor='stacked' is not supported for MME configs: each "
            "model tiles T by its own member count, so the cross-model "
            "obs mean is undefined (no reference script combines them "
            "either, training.py:146-238 vs tune_MME.py)")
    if cfg.predictor == "stacked":
        # members become extra batch rows; labels, splits and metrics all
        # run on the tiled M*T axis (preprocessing.py:29-35,
        # training.py:146-238)
        filled = {n: b.stacked() for n, b in filled.items()}
    first = filled[names[0]]
    y_shared = np.mean(np.stack([filled[n].y for n in names]), axis=0) \
        if cfg.is_mme else first.y
    fm = splits.bootstrap_masks(first.years, cfg.n_bootstraps,
                                frac_valid=cfg.nn_frac_valid,
                                frac_test=cfg.nn_frac_test)
    for i in range(fm.n_folds):
        log(f"[nn] fold {i + 1}: train={sorted(fm.train_years[i])} "
            f"val={sorted(fm.val_years[i])} test={sorted(fm.test_years[i])}")

    wm = timeutils.week_window_matrix(1)
    y = torch.as_tensor(y_shared, device=device)
    fits = [terciles.fit_and_label(y, first.weeks, fm.train[f], wm, None)
            for f in range(fm.n_folds)]
    lab = torch.stack([f[0] for f in fits])
    edges = torch.stack([f[1] for f in fits])
    present = torch.stack([f[2] for f in fits])
    y_oh = torch.nan_to_num(terciles.one_hot_labels(lab), nan=0.0)
    return (names, filled, first, fm, lab.cpu().numpy(), y_oh,
            (edges, present))


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


def _deterministic_to_probs(preds, weeks, edges_pr):
    """Categorize deterministic precip predictions (F, T, H, W, 1) with
    each fold's rolling tercile edges, yielding one-hot (F, T, H, W, 3)
    'probabilities' (NaN where the label is), so deterministic runs score
    through the same RPSS/MME path as the proba head. (The reference's
    deterministic head, deep_nn_models.py:104-105, dead-ends before any
    scoring.)"""
    edges, present = edges_pr
    return terciles.one_hot_labels(torch.stack([
        terciles.label_terciles(p[..., 0], weeks, e, pr)
        for p, e, pr in zip(preds, edges, present)]))


def _make_architecture(arch: str, x_shape, device=None):
    """factory(generator) of the cnn or mlp for predictor images of
    x_shape (T, H, W, C)."""
    if arch not in ("cnn", "mlp"):
        raise ValueError(f"unknown architecture {arch!r}")
    return checkpoint.model_factory(arch, (1, *x_shape[1:]), device=device)


def _unet_from_grid(cfg: PipelineConfig, in_channels=1, device=None):
    """The training_type='train' U-Net: a SINGLE configuration, the first
    tuning-grid entry, standing in for the reference's
    architecture_params dict (training.py:54-60,119-125; the scripts set
    architecture_params from the same values their grids lead with).
    Returns (factory(generator), UNetConfig)."""
    t0 = enumerate_trials(cfg.tuning)[0]
    ucfg = UNetConfig(filters=t0.filters, n_blocks=t0.n_blocks,
                      ct_kernel=t0.ct_kernel, output=cfg.output)
    return checkpoint.model_factory("unet", (1, 1, 1, in_channels), ucfg,
                                    device), ucfg


def _nn_result(cfg, filled, names, first, fm, labels, per_model_preds,
               device, **kw) -> NNResult:
    """Blend (MME), then RPSS (train / val / test) per fold vs the
    constant-1/3 climatology of the last-iterated model's predictor
    (performance_metrics.py:11-23)."""
    preds = (elr_ops.blend_probabilities(per_model_preds) if cfg.is_mme
             else per_model_preds[0])
    climo = metrics.climo_forecast(
        torch.as_tensor(filled[names[-1]].ensemble_mean(), device=device))
    fld = _rpss_fields(climo, preds, labels,
                       {"Y": first.lats, "X": first.lons})
    return NNResult(rpss_train=fld(fm.train), rpss_val=fld(fm.val),
                    rpss_test=fld(fm.test), predictions=preds,
                    labels=labels, masks=fm, **kw)


def run_nn_branch(cfg: PipelineConfig, bundles, log=print, timer=None,
                  training_type="tune", device=None) -> NNResult:
    """The NN branch of a tune run on `device` (None: the card): splits,
    labels, then for every model (blended for MME) the U-Net sweep
    (training_type 'tune') or the fixed training of one configuration
    (cnn/mlp, or 'train'), and RPSS maps (train / val / test) per fold.
    `timer` (a StageTimer) counts the optimizer steps."""
    device = devices.resolve(device)
    names, filled, first, fm, labels, y_oh, edges_pr = \
        _nn_setup(cfg, bundles, log, device)
    det = cfg.output == "deterministic"
    if det and cfg.architecture != "unet":
        raise ValueError(
            "output='deterministic' is only available for the U-Net "
            "(deep_nn_models.py:104-105); cnn/mlp have softmax heads")
    if det and cfg.predictor == "stacked":
        raise ValueError(
            "output='deterministic' does not compose with "
            "predictor='stacked': stacking tiles the batch axis by member "
            "count while the regression target keeps the raw T axis")
    y_tgt = y_oh
    if det:
        # deterministic head (deep_nn_models.py:104-105): regress RAW
        # precipitation from the un-filled bundles, so the ocean stays NaN
        # and masked_mse excludes it (a fillna(0) target would train the
        # model on ocean zeros). Fold-independent, broadcast per fold.
        y_raw = (np.nanmean(np.stack([bundles[m].y for m in names]), 0)
                 if cfg.is_mme else bundles[names[0]].y)
        y_tgt = torch.as_tensor(y_raw, device=device)[None, ..., None] \
            .expand((fm.n_folds,) + y_raw.shape + (1,))

    sweeps: Dict[str, SweepResult] = {}
    hparams_by_model: Dict[str, list] = {}
    fixed_winners: Dict[str, tuple] = {}
    per_model_preds = []
    steps = epochs = 0
    for n in names:
        x = filled[n].predictor_images(cfg.predictor)
        if cfg.architecture == "unet":
            try:
                check_divisible(x.shape[1], x.shape[2],
                                max(cfg.tuning.n_blocks))
            except ValueError as e:
                raise ValueError(f"model {n}: {e} — choose a domain/step "
                                 f"that yields a divisible grid or pad via "
                                 f"DataBundle.pad_to_grid") from None
        t0 = time.time()
        grid_n = resolve_batch_sizes(cfg.tuning, int(x.shape[0]))
        if cfg.architecture == "unet" and training_type == "tune":
            res = run_unet_sweep(x, y_tgt, fm.train, fm.val, grid_n,
                                 epochs=cfg.epochs, output=cfg.output,
                                 device=device)
            if det:
                res = replace(res, predictions=_deterministic_to_probs(
                    res.predictions, filled[n].weeks, edges_pr))
            log(f"[nn] model {n}: sweep of {res.val_loss_table.shape[1]} "
                f"trials x {fm.n_folds} folds in {time.time() - t0:.1f}s "
                f"{res.timings}; "
                f"winners={[t.hparams() for t in res.best_trial]}")
            sweeps[n] = res
            preds_n = res.predictions
            hparams_by_model[n] = [t.hparams() for t in res.best_trial]
            n_steps, n_epochs, counted = (res.train_steps, res.epochs_run,
                                          res.train_steps)
        else:
            # fixed single-configuration training, one lane per fold: the
            # cnn/mlp branch (training.py:53-64; the reference's tuning
            # loop only ever rebuilds the U-Net) and training_type='train'
            # for any architecture (training.py:119-125: the first grid
            # entry, no EarlyStopping, the best-val weights of all epochs)
            if cfg.architecture == "unet":
                factory, ucfg = _unet_from_grid(cfg, x.shape[-1], device)
            else:
                factory = _make_architecture(cfg.architecture, x.shape,
                                             device)
                ucfg = None
            lr, bs = grid_n.learning_rates[0], grid_n.batch_sizes[0]
            fr = run_fixed_training(
                factory, x, y_tgt, fm.train, fm.val, lr=lr, batch_size=bs,
                epochs=cfg.epochs, patience=grid_n.patience,
                early_exit=(training_type != "train"), output=cfg.output,
                device=device)
            preds_n = fr.predictions
            if det:
                preds_n = _deterministic_to_probs(preds_n, filled[n].weeks,
                                                  edges_pr)
            fixed_winners[n] = (fr.winner_variables, fr.val_loss, ucfg)
            log(f"[nn] model {n}: {cfg.architecture} ({training_type}) x "
                f"{fm.n_folds} folds in {time.time() - t0:.1f}s; "
                f"val_loss={fr.val_loss.round(4)}")
            hp = {"architecture": cfg.architecture, "lr": lr,
                  "batch_size": bs}
            if ucfg is not None:
                hp.update(ct_kernel=ucfg.ct_kernel, filters=ucfg.filters,
                          blocks=ucfg.n_blocks)
            hparams_by_model[n] = [hp] * fm.n_folds
            # the profile keeps JAX's counter for this branch (folds x
            # epochs x batches of T, tune.py:418-420), not the steps run
            n_steps, n_epochs = fr.train_steps, fr.epochs_run
            counted = fm.n_folds * cfg.epochs * (-(-x.shape[0] // bs))
        per_model_preds.append(preds_n)
        steps += n_steps
        epochs += n_epochs
        if timer is not None:
            timer.count("train_steps", counted)
            timer.count("epochs_run", n_epochs)

    return _nn_result(
        cfg, filled, names, first, fm, labels, per_model_preds, device,
        sweeps=sweeps, fixed_winners=fixed_winners,
        best_hparams=[{n: hparams_by_model[n][f] for n in names}
                      for f in range(fm.n_folds)],
        train_steps=steps, epochs_run=epochs)


def run_nn_branch_load(cfg: PipelineConfig, bundles, out_root=".",
                       log=print, fingerprint=None,
                       device=None) -> NNResult:
    """The reference's training_type='load' (training.py:127-131) on
    `device` (None: the card): rebuild each fold's saved winner from a
    prior run's models/{dir}{model}_{obs}/{week} tree and predict, with no
    training. The winners are rebuilt and predicted as the run that saved
    them did (checkpoint.model_factory, engine.predict), so the replay is
    bit-equal to it on the same device. A manifest saved under another
    `fingerprint` is refused."""
    device = devices.resolve(device)
    names, filled, first, fm, labels, _, edges_pr = \
        _nn_setup(cfg, bundles, log, device)
    per_model_preds = []
    hparams_by_model: Dict[str, list] = {}
    for n in names:
        mdir = os.path.join(out_root, "models", cfg.out_dir,
                            f"{n}_{cfg.obs}", cfg.week)
        mpath = os.path.join(mdir, f"winners_{cfg.week}.json")
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"no winner manifest at {mpath} — run the tune pipeline "
                f"first; training_type='load' replays persisted winners")
        with open(mpath) as fh:
            manifest = {e["fold"]: e for e in json.load(fh)}
        if fingerprint is not None:
            saved_fp = next(iter(manifest.values())).get("fingerprint")
            if saved_fp is not None and saved_fp != fingerprint:
                diffs = {k: (saved_fp.get(k), fingerprint.get(k))
                         for k in set(saved_fp) | set(fingerprint)
                         if saved_fp.get(k) != fingerprint.get(k)}
                raise ValueError(
                    f"winner manifest {mpath} was tuned under different "
                    f"settings than this load run (tune vs load): {diffs} "
                    f"— replay with matching flags or re-tune")
        missing = [f for f in range(fm.n_folds) if f not in manifest]
        if missing:
            raise ValueError(
                f"manifest {mpath} lacks folds {missing} "
                f"(has {sorted(manifest)}); rerun tuning with "
                f"n_bootstraps={cfg.n_bootstraps}")
        x = torch.as_tensor(filled[n].predictor_images(cfg.predictor),
                            device=device)
        t0 = time.time()
        preds_n = torch.stack([
            predict(checkpoint.load_winner(
                mdir, cfg.week, f, architecture=cfg.architecture,
                device=device)[0], None, x)
            for f in range(fm.n_folds)])
        log(f"[nn] model {n}: loaded {fm.n_folds} winners from {mdir} in "
            f"{time.time() - t0:.1f}s")
        if cfg.output == "deterministic":
            preds_n = _deterministic_to_probs(preds_n, filled[n].weeks,
                                              edges_pr)
        per_model_preds.append(preds_n)
        hparams_by_model[n] = [manifest[f]["hparams"]
                               for f in range(fm.n_folds)]

    return _nn_result(
        cfg, filled, names, first, fm, labels, per_model_preds, device,
        sweeps={}, best_hparams=[{n: hparams_by_model[n][f] for n in names}
                                 for f in range(fm.n_folds)])


def settings_fingerprint(cfg: PipelineConfig, source, seed,
                         synthetic_step) -> dict:
    """Everything outside the winner weights that changes predictions:
    preprocessing flags + data provenance. Persisted into the winner
    manifest, so a replay under other flags can be refused."""
    return {"standardize": bool(cfg.standardize),
            "predictor": cfg.predictor,
            "output": cfg.output,
            "source": source, "seed": seed,
            "synthetic_step": synthetic_step,
            "n_bootstraps": cfg.n_bootstraps,
            "week": cfg.week}


# ------------------------------------------------------------- skill mask
def skill_mask(nn: NNResult, y_raw: np.ndarray) -> np.ndarray:
    """Reference end-of-run mask (tune_ECMWF_com.py:123-133): pixels whose
    fold-0 test labels have < 3 unique classes, or any NaN in raw y."""
    lab0 = nn.labels[0]
    test0 = nn.masks.test[0]
    sel = lab0[test0]
    uniq = np.zeros(lab0.shape[1:], np.int32)
    for k in range(3):
        uniq += (sel == k).any(axis=0)
    mask1 = uniq < 3
    mask2 = np.isnan(y_raw).any(axis=0)
    return mask1 | mask2


# ------------------------------------------------------------------ driver
@dataclass
class TuneOutputs:
    config: PipelineConfig
    elr: ElrResult
    nn: NNResult
    mask: np.ndarray
    paths: Dict[str, str] = field(default_factory=dict)
    figures: Dict[str, str] = field(default_factory=dict)
    elapsed_s: float = 0.0


def run_pipeline(cfg: PipelineConfig, source="synthetic", out_root=".",
                 make_plots=False, seed=0,
                 synthetic_step=None, log=print, profile_dir=None,
                 training_type="tune", device=None) -> TuneOutputs:
    """A whole tune run on `device` (None: the card): data, ELR branch, NN
    branch (training_type 'tune' | 'train' | 'load'), skill mask, and
    under `out_root` the JAX CLI's outputs tree:
    outputs/{out_dir}{result_name}_{obs}/ with ELR_rpss_{train,test}_{week}.nc,
    {arch}_rpss_{train,val,test}_{week}.nc, best_hparams_{week}.json and
    profile_{week}.json; models/{out_dir}{model}_{obs}/{week}/ with the
    winners manifest and weights (none written by 'load', which replays
    them).

    make_plots draws the ELR and NN RPSS panels and the per-category
    NN-vs-ELR reliability diagrams under figures/ (needs matplotlib).
    profile_dir traces the ELR stage into profile_dir and the NN stage
    into profile_dir/nn (torch.profiler Chrome traces; a 'load' traces
    only the ELR stage)."""
    if training_type not in ("tune", "train", "load"):
        raise ValueError(f"training_type must be 'tune', 'train' or "
                         f"'load', got {training_type!r}")
    device = devices.resolve(device)
    timer = StageTimer()
    t_start = time.time()
    log(f"####### TUNING {'+'.join(cfg.models)} for {cfg.obs} "
        f"{cfg.week} ({cfg.name}) on {device} #######")
    with timer.stage("data"):
        bundles = load_bundles(cfg, source, seed=seed,
                               synthetic_step=synthetic_step)
        bundles = {n: _apply_pad(cfg, b) for n, b in bundles.items()}
        if cfg.standardize:
            # bootstrap_splits(standardize=True) (preprocessing.py:338-343,
            # 452-456): per-pixel affine over full T, before any fillna,
            # applied once so both branches see the same tensors
            bundles = {n: b.standardize() for n, b in bundles.items()}
    first = bundles[list(bundles)[0]]

    # MME blends write under MME_IMD / 2MME_IMD (tune_MME.py:47,92-93,
    # 135-137); single-model configs keep {model}_{obs}
    out_dir = os.path.join(out_root, "outputs", cfg.out_dir,
                           f"{cfg.result_name}_{cfg.obs}")
    paths = {}
    fingerprint = settings_fingerprint(cfg, source, seed, synthetic_step)

    log("########### ELR ###########")
    # each branch ends by copying its RPSS maps to the host, so the stage
    # timers include the device work
    with trace(profile_dir, log, device), timer.stage("elr"):
        elr_res = run_elr_branch(cfg, bundles, log, device=device)
    # on disk before the long NN stage, which may fail
    for tag, fld in [("train", elr_res.rpss_train),
                     ("test", elr_res.rpss_test)]:
        p = os.path.join(out_dir, f"ELR_rpss_{tag}_{cfg.week}.nc")
        paths[f"elr_{tag}"] = write_netcdf(fld, p)
    if training_type == "load":
        log("########### Neural Network (load) ###########")
        with timer.stage("nn"):
            nn_res = run_nn_branch_load(cfg, bundles, out_root=out_root,
                                        log=log, fingerprint=fingerprint,
                                        device=device)
    else:
        log("########### Neural Network ###########")
        with trace(profile_dir and os.path.join(profile_dir, "nn"), log,
                   device), timer.stage("nn"):
            nn_res = run_nn_branch(cfg, bundles, log, timer=timer,
                                   training_type=training_type,
                                   device=device)
    arch = cfg.architecture

    # per-fold winner models (the reference deletes its checkpoints,
    # tune_ECMWF_com.py:183-186; they are kept here for replay), under
    # models/{dir}{model}_{obs}/{week} (tune_ECMWF_com.py:37)
    for n in bundles:
        mdir = os.path.join(out_root, "models", cfg.out_dir,
                            f"{n}_{cfg.obs}", cfg.week)
        c_in = bundles[n].n_m if cfg.predictor == "multi_predictor" else 1
        shape = (1, *bundles[n].shape_yx, c_in)
        if n in nn_res.sweeps:
            paths[f"winners_{n}"] = checkpoint.save_sweep_winners(
                nn_res.sweeps[n], mdir, cfg.week, architecture=arch,
                input_shape=shape, fingerprint=fingerprint)
        elif n in nn_res.fixed_winners:
            var_list, vloss, ucfg = nn_res.fixed_winners[n]
            # the hparams actually trained with: resolve_batch_sizes has
            # replaced a `full` sentinel with T there
            paths[f"winners_{n}"] = checkpoint.save_fixed_winners(
                var_list, vloss, mdir, cfg.week, architecture=arch,
                input_shape=shape, hparams=dict(nn_res.best_hparams[0][n]),
                fingerprint=fingerprint, config=ucfg)
    for tag, fld in [("train", nn_res.rpss_train),
                     ("val", nn_res.rpss_val),
                     ("test", nn_res.rpss_test)]:
        p = os.path.join(out_dir, f"{arch}_rpss_{tag}_{cfg.week}.nc")
        paths[f"nn_{tag}"] = write_netcdf(fld, p)
    paths["hparams"] = os.path.join(out_dir, f"best_hparams_{cfg.week}.json")
    with open(paths["hparams"], "w") as fh:
        json.dump(nn_res.best_hparams, fh, indent=1, default=str)

    y_raw = np.mean(np.stack([bundles[n].y for n in bundles]), 0) \
        if cfg.is_mme else first.y
    mask = skill_mask(nn_res, y_raw)

    out = TuneOutputs(config=cfg, elr=elr_res, nn=nn_res, mask=mask,
                      paths=paths, elapsed_s=time.time() - t_start)
    paths["profile"] = timer.dump(
        os.path.join(out_dir, f"profile_{cfg.week}.json"))
    log(f"[profile] {json.dumps(timer.summary())}")

    if make_plots:
        from ..viz import maps, reliability
        figdir = os.path.join(out_root, "figures", cfg.out_dir,
                              f"{cfg.result_name}_{cfg.obs}")
        # the reference overlays shapes/ borders on every RPSS map
        # (plots.py:417-420,477-480)
        shapes_dir = maps.default_shapes_dir(out_root)
        wk = cfg.week.replace("-", "")
        out.figures.update(maps.plot_rpss_panels(
            {"Train": elr_res.rpss_train, "Test": elr_res.rpss_test},
            first.lats, first.lons, figdir, f"{wk}_RPSS_ELR",
            shapes_dir=shapes_dir))
        out.figures.update(maps.plot_rpss_panels(
            {"Train": nn_res.rpss_train, "Validation": nn_res.rpss_val,
             "Test": nn_res.rpss_test},
            first.lats, first.lons, figdir, f"{wk}_RPSS_{arch.upper()}",
            mask=mask, shapes_dir=shapes_dir))
        out.figures.update(reliability.compare_categories(
            nn_res, elr_res, mask, cfg, figdir, device=device))

    hh = time.strftime("%H:%M:%S", time.gmtime(out.elapsed_s))
    log(f"####### DONE {cfg.name} in {hh} #######")
    return out

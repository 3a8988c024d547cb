"""Checkpointing: persist per-fold winner models (port of
s2s_ismr_tpu/train/checkpoint.py).

The reference saves full Keras models per trial and DELETES them at the
end of the run (training.py:98-115, tune_ECMWF_com.py:183-186); only RPSS
netcdfs survive. Here each fold's winner is kept as a state dict
(`torch.save`, loaded with `weights_only=True`) beside a JSON manifest of
the same schema as the JAX package's (fold, file, architecture, config,
hparams, val_loss, input_shape, fingerprint), so a later load replays the
winner without retraining. The fixed-training winners (cnn/mlp, U-Net
`training_type='train'`) come with ROADMAP queue A item 13.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from ..models import UNetConfig
from .sweep import build_winner


def save_variables(state_dict, path):
    """Write a state dict (tensors are moved to the CPU first)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    return path


def load_variables(path, device="cpu"):
    return torch.load(path, map_location=device, weights_only=True)


def save_sweep_winners(sweep_result, out_dir, week, architecture="unet",
                       input_shape=None, fingerprint=None):
    """Persist each fold's winning model (the reference's
    best_model_{arch}_{i}_tuned naming, training.py:115) and the manifest
    winners_{week}.json.

    fingerprint: dict of run settings (standardize/predictor/source/seed/…)
    recorded per entry, so a later replay can refuse a flag mismatch."""
    os.makedirs(out_dir, exist_ok=True)
    manifest = []
    for i, (variables, trial, cfg) in enumerate(zip(
            sweep_result.winner_variables, sweep_result.best_trial,
            sweep_result.winner_configs)):
        fname = f"best_model_{architecture}_{i}_tuned.pt"
        save_variables(variables, os.path.join(out_dir, fname))
        manifest.append({
            "fold": i, "file": fname,
            "architecture": architecture,
            "config": dataclasses.asdict(cfg),
            "hparams": trial.hparams(),
            "val_loss": float(sweep_result.best_val_loss[i]),
            "input_shape": list(input_shape) if input_shape else None,
            "fingerprint": dict(fingerprint) if fingerprint else None,
        })
    mpath = os.path.join(out_dir, f"winners_{week}.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1, default=str)
    return mpath


def _build_model(entry, architecture, state, device):
    arch = entry.get("architecture", architecture)
    if arch in ("cnn", "mlp"):
        raise NotImplementedError(
            f"architecture={arch!r} is not ported yet: it comes with the "
            "cnn/mlp models (ROADMAP queue A item 13)")
    shape = entry["input_shape"] or [1, 32, 32, 1]
    cfg_d = dict(entry["config"])
    cfg_d["ct_kernel"] = tuple(cfg_d["ct_kernel"])
    cfg_d["ct_stride"] = tuple(cfg_d["ct_stride"])
    return build_winner(UNetConfig(**cfg_d), state, shape[-1], device), shape


def load_winner(out_dir, week, fold, architecture="unet", device="cpu"):
    """Rebuild a fold's winning model from the manifest in `out_dir` on
    `device`. Returns (model holding the winner's state, state dict)."""
    with open(os.path.join(out_dir, f"winners_{week}.json")) as f:
        manifest = json.load(f)
    entry = next(e for e in manifest if e["fold"] == fold)
    variables = load_variables(os.path.join(out_dir, entry["file"]), device)
    model, _ = _build_model(entry, architecture, variables, device)
    return model, variables

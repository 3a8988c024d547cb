"""Checkpointing: persist per-fold winner models (port of
s2s_ismr_tpu/train/checkpoint.py).

The reference saves full Keras models per trial and DELETES them at the
end of the run (training.py:98-115, tune_ECMWF_com.py:183-186); only RPSS
netcdfs survive. Here each fold's winner is kept as a state dict
(`torch.save`, loaded with `weights_only=True`) beside a JSON manifest of
the same schema as the JAX package's (fold, file, architecture, config,
hparams, val_loss, input_shape, fingerprint), so a later load replays the
winner without retraining: the sweep's winners (`*_tuned.pt`) and those of
a fixed training (`*_trained.pt`: cnn/mlp, U-Net `training_type='train'`).
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from .. import device as devices
from ..models import CNN, MLP, UNet, UNetConfig
from .sweep import rebuild


def save_variables(state_dict, path):
    """Write a state dict (tensors are moved to the CPU first)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    return path


def load_variables(path, device=None):
    """A state dict from `path`, on `device` (None: the card)."""
    return torch.load(path, map_location=devices.resolve(device),
                      weights_only=True)


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


def save_fixed_winners(var_list, val_losses, out_dir, week, architecture,
                       input_shape=None, hparams=None, fingerprint=None,
                       config=None):
    """Persist the per-fold winners of a fixed (non-tuned) training run:
    the cnn/mlp branch (training.py:53-64) and the U-Net
    training_type='train' (training.py:119-125), whose `config` (the
    UNetConfig; null for cnn/mlp) lets a load rebuild it."""
    os.makedirs(out_dir, exist_ok=True)
    cfg_dict = dataclasses.asdict(config) if config is not None else None
    manifest = []
    for i, variables in enumerate(var_list):
        fname = f"best_model_{architecture}_{i}_trained.pt"
        save_variables(variables, os.path.join(out_dir, fname))
        manifest.append({
            "fold": i, "file": fname,
            "architecture": architecture,
            "config": cfg_dict,
            "hparams": dict(hparams or {}),
            "val_loss": float(val_losses[i]),
            "input_shape": list(input_shape) if input_shape else None,
            "fingerprint": dict(fingerprint) if fingerprint else None,
        })
    mpath = os.path.join(out_dir, f"winners_{week}.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1, default=str)
    return mpath


def model_factory(architecture, input_shape, config=None, device=None):
    """factory(generator) -> a fresh model of a manifest's architecture
    for inputs of `input_shape` (1, H, W, C), on `device` (None: the
    card). The fixed training builds its models with the same factory, so
    a reloaded winner is the model that was trained."""
    device = devices.resolve(device)
    c_in = input_shape[-1]
    if architecture == "cnn":
        return lambda g: CNN(in_channels=c_in, generator=g, device=device)
    if architecture == "mlp":
        return lambda g: MLP(spatial_shape=tuple(input_shape[1:3]),
                             in_channels=c_in, generator=g, device=device)
    if architecture != "unet":
        raise ValueError(f"unknown architecture {architecture!r}")
    return lambda g: UNet(config, c_in, generator=g, device=device)


def _build_model(entry, architecture, state, device):
    arch = entry.get("architecture", architecture)
    shape = entry["input_shape"] or [1, 32, 32, 1]
    cfg = None
    if arch == "unet":
        cfg_d = dict(entry["config"])
        cfg_d["ct_kernel"] = tuple(cfg_d["ct_kernel"])
        cfg_d["ct_stride"] = tuple(cfg_d["ct_stride"])
        cfg = UNetConfig(**cfg_d)
    return rebuild(model_factory(arch, shape, cfg, device), state), shape


def load_winner(out_dir, week, fold, architecture="unet", device=None):
    """Rebuild a fold's winning model (unet, cnn or mlp, as the manifest
    in `out_dir` says) on `device` (None: the card). Returns (model
    holding the winner's state, state dict)."""
    device = devices.resolve(device)
    with open(os.path.join(out_dir, f"winners_{week}.json")) as f:
        manifest = json.load(f)
    entry = next(e for e in manifest if e["fold"] == fold)
    variables = load_variables(os.path.join(out_dir, entry["file"]), device)
    model, _ = _build_model(entry, architecture, variables, device)
    return model, variables

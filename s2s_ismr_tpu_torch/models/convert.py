"""flax variables <-> port parameters and buffers.

A flax U-Net's variables are nested dicts, {'params': {...},
'batch_stats': {...}}; the port's modules carry the same names, and conv
kernels are HWIO on both sides, so conversion is a renaming: the nested
path joined with '.' is the port's state_dict key ('down1_conv1' /
'conv' / 'kernel' -> 'down1_conv1.conv.kernel'; the BatchNorm's
'batch_stats' 'mean'/'var' are the module's buffers of those names).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if hasattr(v, "items"):          # dict or flax FrozenDict
            yield from _flatten(v, key + ".")
        else:
            yield key, v


def from_flax(variables, device=None) -> dict:
    """flax variables (nested dicts of arrays) -> port state_dict."""
    out = {}
    for collection in ("params", "batch_stats"):
        for k, v in _flatten(variables.get(collection, {})):
            out[k] = torch.tensor(np.asarray(v), dtype=torch.float32,
                                  device=device)
    return out


def load_flax(model: nn.Module, variables) -> nn.Module:
    """Copy flax variables into `model` (strict: every name must match)."""
    model.load_state_dict(from_flax(variables))
    return model


def to_flax(model: nn.Module) -> dict:
    """The model's state -> flax variables as nested dicts of numpy
    arrays."""
    state = model.state_dict()
    buffers = {k for k, _ in model.named_buffers()}
    out: dict = {"params": {}, "batch_stats": {}}
    for k, v in state.items():
        node = out["batch_stats" if k in buffers else "params"]
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy()
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out

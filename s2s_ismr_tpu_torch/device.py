"""The device of the port's library entry points.

Every entry point (`run_pipeline`, the branches, the sweep, the fixed
training, checkpoint loading) takes `device=None`, which means the card.
There is no CPU fallback: without a card, None raises and the caller
passes `device="cpu"` to run on the CPU.
"""

from __future__ import annotations

import subprocess

import torch


def resolve(device=None):
    """`device` as given, or 'cuda' for None; raises RuntimeError when None
    is given and no CUDA device is present."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU by "
                           "default; pass device='cpu' to run on the CPU")
    return "cuda"


def card_line():
    """The first card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them; printed
    beside every device time, since a card set below its 700 W limit runs
    slower under load. Raises RuntimeError when nvidia-smi fails."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]

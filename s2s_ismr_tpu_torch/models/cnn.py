"""Plain 3-layer CNN baseline (port of s2s_ismr_tpu/models/cnn.py;
reference deep_nn_models.py:188-203).

Conv3x3 ReLU at widths f, 2f, 4f, then a Conv3x3 head and a softmax over
channels. `output_channels` defaults to 3 terciles, JAX's repair of the
reference's degenerate single-channel softmax (see the JAX docstring).

JAX computes these convs with XLA. Here every one of them is exactly the
function the hand-written kernel computes (SAME 3x3 + bias, act 'none'),
so with conv_backend 'auto' / 'kernel' they run it, the ReLU as a torch
op after it; 'torch' is Conv2D. The parameter tree is Conv2D's in both
cases (`conv1.conv.kernel`, ...), so flax weights convert by name.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers
from .layers import Conv2D, FusedConv3x3


class CNN(nn.Module):
    def __init__(self, num_filters=16, output_channels=3, in_channels=1,
                 conv_backend="auto",
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        use_kernel = layers.conv_backend(conv_backend) == "kernel"
        widths = (num_filters, num_filters * 2, num_filters * 4,
                  output_channels)
        c = in_channels
        for name, w in zip(("conv1", "conv2", "conv3", "head"), widths):
            mod = (FusedConv3x3(c, w, generator, device, act="none")
                   if use_kernel else
                   Conv2D(c, w, generator=generator, device=device))
            self.add_module(name, mod)
            c = w

    def forward(self, x, train: bool = False, sample_weight=None,
                dropout_generator=None):
        """x (N, H, W, C) -> (N, H, W, output_channels) probabilities. The
        CNN has no BatchNorm and no dropout: train, sample_weight and
        dropout_generator are accepted and ignored."""
        h = torch.relu(self.conv1(x))
        h = torch.relu(self.conv2(h))
        h = torch.relu(self.conv3(h))
        return torch.softmax(self.head(h), dim=-1)

"""MLP baseline (port of s2s_ismr_tpu/models/mlp.py; reference
deep_nn_models.py:166-186).

Flatten -> Dense2048(he_normal, relu) + BN + Dropout(0.3)
        -> Dense512(he_normal, relu)  + BN + Dropout(0.3)
        -> Dense(lat*lon*3, linear) -> reshape (lat, lon, 3) -> softmax.

The flatten is of the NHWC image, as JAX's `x.reshape(n, -1)`, so
converted `fc1` weights compute the same function. The products are
torch.matmul: JAX leaves them to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from .layers import BatchNorm, Dense, Dropout, he_normal_


class MLP(nn.Module):
    def __init__(self, spatial_shape: Tuple[int, int], in_channels=1,
                 num_classes=3, dropout_rate=0.3,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.spatial_shape = tuple(spatial_shape)
        self.num_classes = num_classes
        kw = dict(generator=generator, device=device)
        n_in = math.prod(self.spatial_shape) * in_channels
        self.fc1 = Dense(n_in, 2048, he_normal_, **kw)
        self.bn1 = BatchNorm(2048, device=device)
        self.fc2 = Dense(2048, 512, he_normal_, **kw)
        self.bn2 = BatchNorm(512, device=device)
        self.fc_out = Dense(512, math.prod(self.spatial_shape) * num_classes,
                            **kw)
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, train: bool = False, sample_weight=None,
                dropout_generator: torch.Generator | None = None):
        """x (N, H, W, C) -> (N, H, W, num_classes) probabilities; in
        training the two dropouts draw from `dropout_generator`."""
        n = x.shape[0]
        h = x.reshape(n, -1)
        h = torch.relu(self.fc1(h))
        h = self.bn1(h, train=train, sample_weight=sample_weight)
        h = self.dropout(h, train, dropout_generator)
        h = torch.relu(self.fc2(h))
        h = self.bn2(h, train=train, sample_weight=sample_weight)
        h = self.dropout(h, train, dropout_generator)
        out = self.fc_out(h).reshape(
            (n,) + self.spatial_shape + (self.num_classes,))
        return torch.softmax(out, dim=-1)

"""U-Net for tercile-probability post-processing (port of
s2s_ismr_tpu/models/unet.py).

Topology (reference Keras model, after Horat & Lerch 2023):
  encoder   : n_blocks x [Conv3x3 ELU, Dropout, Conv3x3 ELU, BN, AvgPool2]
              widths filters*4 * 2^k, skip connections taken pre-pool
  bottleneck: 2 x Conv3x3 ELU (width filters*4 * 2^n_blocks) + BN
  decoder   : n_blocks x [ConvT(ct_kernel, stride 2), Concat skip,
              Conv3x3 ELU, Dropout, Conv3x3 ELU, BN]; the LAST up block has
              no BN before the softmax
  head      : Conv1x1 softmax (proba) or Conv1x1 ReLU (deterministic)

Images are NHWC at the interface and inside, so the conv kernel reads them
as they are. Module and parameter names are the flax ones.

compute_dtype='bfloat16' follows JAX's rules: the 'torch'-backend 3x3
convs and every transposed conv compute in bf16 and return float32
(parameters, BatchNorm and the head stay float32); under the 'kernel'
backend the fused 3x3 convs stay float32, as JAX's Pallas path ignores the
dtype. 'auto' is float32 (JAX means bf16 only on a TPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from .layers import (BatchNorm, Conv2D, Conv2DTranspose, Dropout,
                     FusedConv3x3, avg_pool2, conv_backend, elu, max_pool2)


@dataclass(frozen=True)
class UNetConfig:
    """Static architecture knobs, the reference's tunables."""
    filters: int = 2
    n_blocks: int = 3
    ct_kernel: Tuple[int, int] = (3, 3)
    ct_stride: Tuple[int, int] = (2, 2)
    apool: bool = True
    bn: bool = True
    n_bins: int = 3
    output: str = "proba"          # 'proba' | 'deterministic'
    dropout_rate: float = 0.0
    conv_backend: str = "auto"     # 'auto' | 'kernel' | 'torch'
    compute_dtype: str = "auto"    # 'auto' | 'float32' | 'bfloat16'

    def block_width(self, k):
        """Width of encoder block k (1-based): filters*4 * 2^(k-1)."""
        return self.filters * 4 * (2 ** (k - 1))

    def resolved_backend(self):
        return conv_backend(self.conv_backend)


class _ConvELU(Conv2D):
    """Conv2D + ELU, the 'torch' backend of a conv_elu (JAX's 'xla')."""

    def forward(self, x):
        return elu(super().forward(x))


class UNet(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig(), in_channels=1,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        cfg = self.config = config
        if cfg.compute_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'auto', 'float32' or "
                             f"'bfloat16', got {cfg.compute_dtype!r}")
        cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        use_kernel = cfg.resolved_backend() == "kernel"
        kw = dict(generator=generator, device=device)
        self.dropout = Dropout(cfg.dropout_rate)

        def conv_elu(name, c_in, c_out):
            mod = (FusedConv3x3(c_in, c_out, **kw) if use_kernel
                   else _ConvELU(c_in, c_out, dtype=cdt, **kw))
            self.add_module(name, mod)

        def bn(name, c):
            if cfg.bn:
                self.add_module(name, BatchNorm(c, device=device))

        c = in_channels
        for k in range(1, cfg.n_blocks + 1):
            w = cfg.block_width(k)
            conv_elu(f"down{k}_conv1", c, w)
            conv_elu(f"down{k}_conv2", w, w)
            bn(f"down{k}_bn", w)
            c = w
        wb = cfg.filters * 4 * (2 ** cfg.n_blocks)
        conv_elu("bottleneck_conv1", c, wb)
        conv_elu("bottleneck_conv2", wb, wb)
        bn("bottleneck_bn", wb)
        c = wb
        for k in range(cfg.n_blocks, 0, -1):
            w = cfg.block_width(k)
            self.add_module(f"up{k}_convT", Conv2DTranspose(
                c, w, cfg.ct_kernel, cfg.ct_stride, dtype=cdt, **kw))
            conv_elu(f"up{k}_conv1", 2 * w, w)
            conv_elu(f"up{k}_conv2", w, w)
            if k > 1:
                bn(f"up{k}_bn", w)
            c = w
        n_out = cfg.n_bins if cfg.output == "proba" else 1
        self.head = Conv2D(c, n_out, (1, 1), **kw)

    def dropout_shapes(self, n, height, width):
        """Shapes of the activations the dropout layers see in one forward
        of n rows, in the order it draws their masks."""
        cfg = self.config
        enc = [(n, height >> (k - 1), width >> (k - 1), cfg.block_width(k))
               for k in range(1, cfg.n_blocks + 1)]
        return enc + enc[::-1]

    def forward(self, x, train: bool = False, sample_weight=None,
                dropout_generator: torch.Generator | None = None,
                bottleneck_delta=None, intermediates: dict | None = None,
                dropout_masks=None):
        """x (N, H, W, C) -> (N, H, W, n_bins) probabilities (or (N, H, W,
        1) for the deterministic head). In training, dropout (after conv1
        of every encoder and decoder block) draws its masks from
        `dropout_generator`, a generator on x's device, or takes them in
        order from `dropout_masks` (keep masks of `dropout_shapes`).
        bottleneck_delta is the GradCAM tap added to the bottleneck
        activations; `intermediates`, when given, receives them under
        'bottleneck'."""
        cfg = self.config
        pool = avg_pool2 if cfg.apool else max_pool2
        masks = iter(dropout_masks if dropout_masks is not None else ())

        def drop(v):
            return self.dropout(v, train, dropout_generator,
                                next(masks, None))

        def bn(v, name):
            if not cfg.bn:
                return v
            return getattr(self, name)(v, train=train,
                                       sample_weight=sample_weight)

        skips = []
        h = x
        for k in range(1, cfg.n_blocks + 1):
            c = getattr(self, f"down{k}_conv1")(h)
            c = drop(c)
            c = getattr(self, f"down{k}_conv2")(c)
            c = bn(c, f"down{k}_bn")
            skips.append(c)
            h = pool(c)

        h = self.bottleneck_conv1(h)
        h = self.bottleneck_conv2(h)
        h = bn(h, "bottleneck_bn")
        if bottleneck_delta is not None:
            h = h + bottleneck_delta
        if intermediates is not None:
            intermediates["bottleneck"] = h

        for k in range(cfg.n_blocks, 0, -1):
            u = getattr(self, f"up{k}_convT")(h)
            u = torch.cat([skips[k - 1], u], dim=-1)
            u = getattr(self, f"up{k}_conv1")(u)
            u = drop(u)
            u = getattr(self, f"up{k}_conv2")(u)
            h = bn(u, f"up{k}_bn") if k > 1 else u

        # 1x1 head as one matmul over channels
        head = self.head.conv
        logits = torch.matmul(h, head.kernel[0, 0]) + head.bias
        if cfg.output == "proba":
            return torch.softmax(logits, dim=-1)
        return torch.relu(logits)


def check_input(cfg: UNetConfig, height, width):
    d = 2 ** cfg.n_blocks
    if height % d or width % d:
        raise ValueError(
            f"U-Net with n_blocks={cfg.n_blocks} needs H,W divisible by {d}; "
            f"got {height}x{width} (pad the grid, see grid.make_grid)")

"""Keras-semantics building blocks as torch modules (port of
s2s_ismr_tpu/models/layers.py).

  * Conv2D: glorot-uniform kernel, zero bias, channels-last, 'same' pad;
    optionally computed in bfloat16 (flax `dtype`: input, kernel and bias
    cast, the result returned as float32)
  * Conv2DTranspose: gradient-of-conv (TF/Keras) SAME placement; in
    bfloat16 the transposed conv computes in bf16 and the bias is added in
    float32
  * BatchNorm: momentum 0.99, epsilon 1e-3, biased batch variance, optional
    per-sample weights for padded batches; its running-statistics update
    can be collected instead of written (`functional_batchnorm`), which
    is how lanes batched by torch.func.vmap keep them
  * FusedConv3x3: conv3x3 + bias + ELU (or no activation) through the
    hand-written kernel
  * Dense: glorot-uniform (or he-normal) kernel (in, out), zero bias
  * Dropout: inverted dropout whose mask comes from an explicit generator,
    or is handed in already drawn (batched lanes draw each lane's masks
    outside vmap)

Activations are NHWC and conv kernels HWIO (kh, kw, C, O), as in JAX, so
parameters convert from flax by renaming only (models/convert.py). Every
parameter and every dropout mask is drawn from an explicit
torch.Generator, never from the global RNG.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import batchnorm, conv3x3_bias_act


def glorot_uniform_(t, generator=None):
    """Keras glorot-uniform for an HWIO kernel: U(-l, l), l = sqrt(6 /
    (fan_in + fan_out)) with fans counted over the receptive field."""
    rf = math.prod(t.shape[:-2])
    limit = math.sqrt(6.0 / (rf * t.shape[-2] + rf * t.shape[-1]))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


# flax's variance_scaling truncated normal: a standard normal cut at +-2
# has this std, so the draw is divided by it to keep the requested variance
_TRUNC_STD = 0.87962566103423978


def he_normal_(t, generator=None):
    """flax / Keras he_normal for a kernel (..., in, out): a normal cut at
    +-2 sigma, sigma = sqrt(2 / fan_in) / 0.8796..., fan_in = prod(shape[:-1])
    (not torch's trunc_normal_ defaults, which cut at +-2 absolute)."""
    std = math.sqrt(2.0 / math.prod(t.shape[:-1])) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def _param(shape, init, generator, device):
    t = torch.empty(shape, dtype=torch.float32)
    return nn.Parameter(init(t, generator).to(device))


class KernelBias(nn.Module):
    """The `kernel`/`bias` pair of a conv or a dense layer, in flax's nested
    `conv` / `dense` scope."""

    def __init__(self, shape, generator=None, device=None,
                 init=glorot_uniform_):
        super().__init__()
        self.kernel = _param(shape, init, generator, device)
        self.bias = nn.Parameter(torch.zeros(shape[-1], device=device))


class Conv2D(nn.Module):
    """Keras-default 2D conv, stride 1, SAME padding; x NHWC. With `dtype`
    (torch.bfloat16) it computes as flax's nn.Conv(dtype=...) does: input,
    kernel and bias cast to it, the conv and the bias add in it, and the
    result cast back to float32 (JAX Conv2D); parameters stay float32."""

    def __init__(self, in_features, features, kernel_size=(3, 3),
                 generator=None, device=None, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.conv = KernelBias((*kernel_size, in_features, features),
                               generator, device)

    def forward(self, x):
        k, b = self.conv.kernel.permute(3, 2, 0, 1), self.conv.bias
        if self.dtype is None:
            y = F.conv2d(x.permute(0, 3, 1, 2), k, b, padding="same")
            return y.permute(0, 2, 3, 1)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype), k.to(self.dtype),
                     padding="same")
        return (y.permute(0, 2, 3, 1) + b.to(self.dtype)).to(torch.float32)


class Conv2DTranspose(nn.Module):
    """Transposed conv with TF/Keras gradient-of-conv SAME semantics.

    The kernel is stored HWIO of the *forward* conv (kh, kw, features,
    in_features), as in JAX, so its adjoint maps in_features -> features.
    torch's conv_transpose2d with padding (k - s) // 2 places the output as
    TF does once cropped to s * H (without the crop, odd k gives s*H + 1).
    """

    def __init__(self, in_features, features, kernel_size=(3, 3),
                 strides=(2, 2), generator=None, device=None, dtype=None):
        super().__init__()
        self.dtype = dtype
        if any(k < s for k, s in zip(kernel_size, strides)):
            raise ValueError(f"kernel {kernel_size} smaller than stride "
                             f"{strides}")
        self.strides = tuple(strides)
        self.padding = tuple((k - s) // 2
                             for k, s in zip(kernel_size, strides))
        self.kernel = _param((*kernel_size, features, in_features),
                             glorot_uniform_, generator, device)
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        n, h, w, _ = x.shape
        dt = self.dtype or x.dtype
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dt),
                               self.kernel.permute(3, 2, 0, 1).to(dt),
                               stride=self.strides, padding=self.padding)
        y = y[:, :, :self.strides[0] * h, :self.strides[1] * w]
        return y.permute(0, 2, 3, 1).to(torch.float32) + self.bias


class BatchNorm(nn.Module):
    """Keras-default BatchNormalization with optional per-sample weights.

    Not nn.BatchNorm2d: the statistics are the biased variance, the running
    update is ra = m * ra + (1 - m) * stat with m = 0.99 (the opposite of
    torch's `momentum` convention), eps is 1e-3, the statistics are
    weighted by sample_weight (N,) (0 marks a padded sample), and the
    running averages are left as they are when the weights sum to 0. In
    train mode the running buffers are updated in place, or, inside
    `functional_batchnorm`, the updated values are recorded for the caller
    and the buffers are left alone. The train-mode forward and its
    gradient are kernels/batchnorm.py's: one kernel launch each on a CUDA
    tensor, the plain tensor ops on the CPU and inside
    `functional_batchnorm` (batched lanes).
    """

    def __init__(self, features, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.updates = None     # (dict, name) inside functional_batchnorm

    def forward(self, x, train: bool, sample_weight=None):
        if not train:
            return batchnorm.normalize(x, self.mean, self.var, self.scale,
                                       self.bias)
        if sample_weight is None:
            sample_weight = x.new_ones(x.shape[0])
        if self.updates is None:
            return batchnorm.batchnorm_train(x, sample_weight, self.scale,
                                             self.bias, self.mean, self.var)
        y, new_mean, new_var = batchnorm.batchnorm_train_functional(
            x, sample_weight, self.scale, self.bias, self.mean, self.var)
        updates, name = self.updates
        updates[f"{name}.mean"] = new_mean
        updates[f"{name}.var"] = new_var
        return y


@contextlib.contextmanager
def functional_batchnorm(model: nn.Module):
    """Inside the block the BatchNorm layers of `model` leave their running
    buffers alone: each train-mode forward records the updated statistics
    in the dict this yields, under the buffers' state_dict names. A
    forward under torch.func transforms (functional_call with lane-stacked
    buffers) thus returns them as values instead of writing into them."""
    updates = {}
    bns = [(name, m) for name, m in model.named_modules()
           if isinstance(m, BatchNorm)]
    for name, m in bns:
        m.updates = (updates, name)
    try:
        yield updates
    finally:
        for _, m in bns:
            m.updates = None


class FusedConv3x3(nn.Module):
    """conv3x3(SAME) + bias + act ('elu' or 'none') through the hand-written
    kernel (kernels/conv.py); the counterpart of JAX's PallasConv3x3. Its
    parameters are Conv2D's (`conv.kernel`, `conv.bias`), so checkpoints
    interchange between the 'kernel' and 'torch' backends."""

    def __init__(self, in_features, features, generator=None, device=None,
                 act="elu"):
        super().__init__()
        self.act = act
        self.conv = KernelBias((3, 3, in_features, features), generator,
                               device)

    def forward(self, x):
        return conv3x3_bias_act(x, self.conv.kernel, self.conv.bias,
                                self.act)


def conv_backend(name):
    """'auto' | 'kernel' | 'torch' -> 'kernel' | 'torch'. 'auto' is the
    hand-written kernel, unlike JAX where 'auto' meant XLA's conv (a TPU
    v5e measurement); on the H100 the kernel path takes less device time
    per step than cuDNN but more host time (PERF.md)."""
    if name not in ("auto", "kernel", "torch"):
        raise ValueError(f"conv_backend={name!r}")
    return "kernel" if name == "auto" else name


class Dense(nn.Module):
    """Keras-default Dense, x (..., in) -> (..., out): kernel (in, out)
    from `init` (glorot-uniform by default), zero bias, in flax's nested
    `dense` scope (`dense.kernel`, `dense.bias`)."""

    def __init__(self, in_features, features, init=glorot_uniform_,
                 generator=None, device=None):
        super().__init__()
        self.dense = KernelBias((in_features, features), generator, device,
                                init=init)

    def forward(self, x):
        return torch.matmul(x, self.dense.kernel) + self.dense.bias


class Dropout(nn.Module):
    """Inverted dropout (flax nn.Dropout): in training each element is kept
    with probability 1 - rate and scaled by 1 / (1 - rate), else zeroed.
    The mask is drawn from `generator`, a torch.Generator on x's device
    (F.dropout and nn.Dropout draw from the global RNG), or given as `mask`
    (bool, True = keep), drawn beforehand by `draw_mask` from the same
    generator. In eval mode, or at rate 0, x passes through and nothing is
    drawn."""

    def __init__(self, rate):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = rate

    def draw_mask(self, shape, generator: torch.Generator, device):
        """The keep mask of a float32 activation of `shape`, drawn from
        `generator`."""
        return torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32) < 1.0 - self.rate

    def forward(self, x, train: bool, generator: torch.Generator | None,
                mask=None):
        if not train or self.rate == 0.0:
            return x
        if mask is None:
            if generator is None:
                raise ValueError("Dropout in training needs an explicit "
                                 "torch.Generator on the activations' "
                                 "device")
            mask = self.draw_mask(x.shape, generator, x.device)
        keep = 1.0 - self.rate
        return torch.where(mask, x / keep, torch.zeros_like(x))


def _even(x):
    return x[:, :x.shape[1] // 2 * 2, :x.shape[2] // 2 * 2]


def avg_pool2(x):
    """AveragePooling2D((2,2)) valid, stride 2, NHWC."""
    x = _even(x)
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).mean((2, 4))


def max_pool2(x):
    x = _even(x)
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax((2, 4))


def elu(x):
    return F.elu(x)

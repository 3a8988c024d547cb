"""Fused 3x3 conv + bias + ELU: the hand-written CUDA kernel
(csrc/conv3x3.cu) with its autograd Function and its plain PyTorch version.

Port of s2s_ismr_tpu/kernels/conv.py. Layouts are the JAX ones: x NHWC
(N, H, W, C), w HWIO (3, 3, C, O), b (O,), all float32.

Backward, as the JAX custom VJP: ELU' is recovered from the output
(`g * (out > 0 ? 1 : out + 1)`); dx is the same kernel run on the gradient
with the taps rotated 180 degrees and C<->O transposed, identity act and no
bias; dw (the 3x3 patches contracted with g, one matmul) and db (sum of
g) are plain torch ops, as they were XLA ops in JAX.

Dispatch: on a CPU tensor the inner call is the plain version
(`conv3x3_bias_act_plain`); on a CUDA tensor it is the kernel, or an
exception. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0
MAX_CHANNELS = 384
_MAX_GRID_YZ = 65535
_ACTS = ("elu", "none")


def conv3x3_bias_act_plain(x, w, b, act="elu"):
    """The same function with F.conv2d: SAME conv3x3 + bias + act."""
    # contiguous OIHW: the CPU backward refuses the permuted view when O = 1
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=1)
    y = y.permute(0, 2, 3, 1)
    return F.elu(y) if act == "elu" else y


def _launch(x, w, b, act):
    global LAUNCHES
    n, h, wd, c = x.shape
    o = w.shape[3]
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t is None:
            continue
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"conv3x3 kernel: {name} must be on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"conv3x3 kernel: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"conv3x3 kernel: {name} must be contiguous")
    if w.shape[:3] != (3, 3, c) or (b is not None and b.shape != (o,)):
        raise ValueError(f"conv3x3 kernel: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b "
                         f"{None if b is None else tuple(b.shape)}")
    if c > MAX_CHANNELS or o > MAX_CHANNELS:
        raise ValueError(f"conv3x3 kernel takes C, O <= {MAX_CHANNELS}; "
                         f"got C={c}, O={o}")
    if h > _MAX_GRID_YZ or n > _MAX_GRID_YZ:
        raise ValueError(f"conv3x3 kernel takes N, H <= {_MAX_GRID_YZ}")
    out = torch.empty((n, h, wd, o), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.s2s_conv3x3_bias_act_f32(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), n, h, wd, c, o, int(act == "elu"), stream)
    LAUNCHES += 1
    if rc != 0:
        msg = lib.s2s_cuda_error_string(rc).decode()
        raise RuntimeError(f"conv3x3 kernel launch failed: {msg} ({rc})")
    return out


def _conv_call(x, w, b, act):
    """Kernel for a CUDA tensor, plain version for a CPU tensor."""
    if x.is_cuda:
        return _launch(x, w, b, act)
    if x.device.type != "cpu":
        raise ValueError(f"conv3x3_bias_act: no kernel for {x.device}")
    return conv3x3_bias_act_plain(x, w, b, act)


class Conv3x3BiasAct(torch.autograd.Function):
    """conv3x3_bias_act with the JAX custom VJP's backward."""

    @staticmethod
    def forward(ctx, x, w, b, act):
        out = _conv_call(x, w, b, act)
        ctx.act = act
        ctx.save_for_backward(x, w, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        if ctx.act == "elu":
            # elu'(z) = 1 for z > 0 else exp(z) = elu(z) + 1
            g = g * (out.clamp(max=0.0) + 1.0)
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            w_adj = w.flip((0, 1)).transpose(2, 3).contiguous()
            dx = _conv_call(g, w_adj, None, "none")
        if ctx.needs_input_grad[1]:
            n, h, wd, c = x.shape
            o = w.shape[3]
            # tap-major patches (N*H*W, 9*C): a strided view of the padded
            # input, one copy, then one matmul straight into HWIO order
            # (F.unfold on CUDA launches one im2col kernel per sample)
            xp = F.pad(x, (0, 0, 1, 1, 1, 1))
            taps = xp.unfold(1, 3, 1).unfold(2, 3, 1)     # (N,H,W,C,3,3)
            taps = taps.permute(0, 1, 2, 4, 5, 3).reshape(n * h * wd, 9 * c)
            dw = torch.matmul(taps.t(), g.reshape(n * h * wd, o))
            dw = dw.reshape(3, 3, c, o)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 1, 2))
        return dx, dw, db, None


def conv3x3_bias_act(x, w, b, act="elu"):
    """Fused SAME conv3x3 + bias + activation, differentiable.

    x: (N, H, W, C) float32; w: (3, 3, C, O); b: (O,); act: 'elu' | 'none'.
    Semantics match Keras Conv2D(padding='same') followed by ELU.
    """
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    return Conv3x3BiasAct.apply(x, w, b, act)

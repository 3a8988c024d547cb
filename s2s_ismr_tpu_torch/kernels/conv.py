"""Fused 3x3 conv + bias + ELU: the hand-written CUDA kernel
(csrc/conv3x3.cu) with its autograd Function and its plain PyTorch
versions.

Port of s2s_ismr_tpu/kernels/conv.py. Layouts are the JAX ones: x NHWC
(N, H, W, C), w HWIO (3, 3, C, O), b (O,), all float32.

Backward, as the JAX custom VJP: g' = g * ELU'(out), with ELU' recovered
from the saved output (`out > 0 ? 1 : out + 1`); dx is the adjoint conv of
g' (taps rotated 180 degrees, C<->O transposed); dw (the 3x3 patches
contracted with g', one matmul) and db (sum of g') are plain torch ops, as
they were XLA ops in JAX. On a CUDA tensor dx is the kernel's dx mode: one
launch that reads the forward's taps and the saved output as they are and
also writes g'. A conv whose input needs no gradient (the U-Net's first)
computes g' with torch ops.

Dispatch: on a CPU tensor the inner calls are the plain versions
(`conv3x3_bias_act_plain`, `conv3x3_dx_plain`); on a CUDA tensor they are
the kernel, or an exception. `LAUNCHES` counts kernel launches (a dx
launch counts one).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0
MAX_CHANNELS = 384
_MAX_SIDE = 16384
MAX_PIXELS = 2_000_000      # N*H*W: the kernel's fdiv and 32-bit indices
_ACTS = ("elu", "none")

# The kernel's tile table (csrc/conv3x3.cu, kTiles): (BM, BN, WM, WN), a
# BM x BN output tile per block of 4 warps, WM x WN warps over the tile and
# the remaining 4 / (WM * WN) warps splitting each K chunk.
TILES = ((64, 8, 4, 1), (32, 8, 2, 1), (16, 8, 1, 1), (128, 16, 4, 1),
         (64, 16, 4, 1), (32, 16, 2, 1), (16, 16, 1, 1), (64, 32, 2, 2),
         (32, 32, 2, 1), (16, 32, 1, 1))
_SMS = 132          # H100 SXM
_BK = 64            # k values per chunk (csrc/conv3x3.cu, kBK)
# (fixed us, us per chunk, us per mma of a warp per chunk, us per MB that
# the A gathers read): fitted by `conv_bench fit` to a `conv_bench tiles`
# sweep of every tile at the 22 slice shapes (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md, PR 3)
COST = (3.97, 0.1138, 0.0214, 0.186)


def _cdiv(a, b):
    return -(-a // b)


def tile_cost(tile, m, n, k, a_streams=1, cost=COST):
    """Modelled device us of one launch with `tile` for the (m x k) @
    (k x n) GEMM: a fixed part, plus the K chunks of one block, each a
    fixed part and its warps' mma (3 per m16n8k8 step), stretched by the
    waves of blocks past one per SM, plus the bytes the A gathers read
    (every n tile reads A again; the dx mode of an ELU conv reads g and
    the saved output, a_streams = 2)."""
    fixed, per_chunk, per_mma, per_mb = cost
    bm, bn, wm, wn = tile
    ks = 4 // (wm * wn)
    mma = _cdiv(_BK // 8, ks) * (bm // wm // 16) * (bn // wn // 8) * 3
    blocks = _cdiv(m, bm) * _cdiv(n, bn)
    waves = max(1.0, blocks / _SMS)
    mb = (_cdiv(n, bn) * m * k * a_streams + m * n) * 4 / 1e6
    return (fixed + waves * _cdiv(k, _BK) * (per_chunk + per_mma * mma)
            + per_mb * mb)


def kernel_tiles():
    """The tile table as the built library holds it; equals TILES."""
    lib = _build.library()
    vals = [ctypes.c_int() for _ in range(4)]
    count = lib.s2s_conv3x3_tile(-1, *map(ctypes.byref, vals))
    tiles = []
    for i in range(count):
        lib.s2s_conv3x3_tile(i, *map(ctypes.byref, vals))
        tiles.append(tuple(v.value for v in vals))
    return tuple(tiles)


def kernel_chunk():
    """The K chunk of the built library; equals _BK."""
    return _build.library().s2s_conv3x3_chunk()


@functools.lru_cache(maxsize=None)
def _pick_tile(m, n, k, a_streams=1):
    """The tile of the least modelled time (tile_cost); ties go to the
    earlier tile. Cached: a model has a few shapes and launches each many
    times."""
    costs = [tile_cost(t, m, n, k, a_streams) for t in TILES]
    return costs.index(min(costs))


def conv3x3_bias_act_plain(x, w, b, act="elu"):
    """The same function with F.conv2d: SAME conv3x3 + bias + act."""
    # contiguous OIHW: the CPU backward refuses the permuted view when O = 1
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=1)
    y = y.permute(0, 2, 3, 1)
    return F.elu(y) if act == "elu" else y


def elu_grad(g, out):
    """g * ELU'(z), with ELU' read from the output out = elu(z)."""
    # elu'(z) = 1 for z > 0 else exp(z) = elu(z) + 1
    return g * (out.clamp(max=0.0) + 1.0)


def conv3x3_dx_plain(g, out, w, act="elu"):
    """The backward's dx mode with F.conv2d: returns (dx, g') from the
    upstream gradient g (N, H, W, O), the saved output, the forward's taps
    w (3, 3, C, O) and its act. g' = g * ELU'(out) for 'elu', g for 'none';
    dx is the SAME conv of g' with the taps rotated 180 degrees and C<->O
    transposed."""
    if act == "elu":
        g = elu_grad(g, out)
    w_adj = w.flip((0, 1)).transpose(2, 3)
    return conv3x3_bias_act_plain(g, w_adj, None, "none"), g


def _check(name, t, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"conv3x3 kernel: {name} must be on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"conv3x3 kernel: {name} must be float32, "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"conv3x3 kernel: {name} must be contiguous")


def _check_sizes(n, h, wd, cin, cout):
    if not (1 <= cin <= MAX_CHANNELS and 1 <= cout <= MAX_CHANNELS):
        raise ValueError(f"conv3x3 kernel takes 1 <= C, O <= {MAX_CHANNELS}; "
                         f"got {cin}, {cout}")
    if h > _MAX_SIDE or wd > _MAX_SIDE:
        raise ValueError(f"conv3x3 kernel takes H, W <= {_MAX_SIDE}")
    if n * h * wd > MAX_PIXELS:
        raise ValueError(f"conv3x3 kernel takes N*H*W <= {MAX_PIXELS}")


def _run(a, act_out, w, b, y, gp, dx_mode, elu, tile):
    global LAUNCHES
    n, h, wd, cin = a.shape
    cout = y.shape[3]
    if tile is None:
        tile = _pick_tile(n * h * wd, cout, 9 * cin,
                          2 if dx_mode and elu else 1)
    lib = _build.library()
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.s2s_conv3x3_f32(
            ptr(a), ptr(act_out), ptr(w), ptr(b), ptr(y), ptr(gp),
            n, h, wd, cin, cout, int(dx_mode), int(elu), tile, stream)
    LAUNCHES += 1
    if rc != 0:
        msg = lib.s2s_cuda_error_string(rc).decode()
        raise RuntimeError(f"conv3x3 kernel launch failed: {msg} ({rc})")


def _launch(x, w, b, act, tile=None):
    """The forward: act(conv3x3(x, w) + b) in one launch."""
    n, h, wd, c = x.shape
    o = w.shape[3]
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t is not None:
            _check(name, t, x.device)
    if w.shape[:3] != (3, 3, c) or (b is not None and b.shape != (o,)):
        raise ValueError(f"conv3x3 kernel: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b "
                         f"{None if b is None else tuple(b.shape)}")
    _check_sizes(n, h, wd, c, o)
    out = torch.empty((n, h, wd, o), dtype=torch.float32, device=x.device)
    if out.numel():
        _run(x, None, w, b, out, None, False, act == "elu", tile)
    return out


def _launch_dx(g, out, w, act, tile=None):
    """The dx mode: (dx, g') in one launch, from g (N, H, W, O), the saved
    output (read for 'elu') and the forward's taps w (3, 3, C, O)."""
    n, h, wd, o = g.shape
    c = w.shape[2]
    elu = act == "elu"
    for name, t in (("g", g), ("w", w)) + ((("out", out),) if elu else ()):
        _check(name, t, g.device)
    if w.shape != (3, 3, c, o) or (elu and out.shape != g.shape):
        raise ValueError(f"conv3x3 kernel dx: g {tuple(g.shape)}, w "
                         f"{tuple(w.shape)}, out "
                         f"{None if out is None else tuple(out.shape)}")
    _check_sizes(n, h, wd, o, c)
    dx = torch.empty((n, h, wd, c), dtype=torch.float32, device=g.device)
    gp = torch.empty_like(g) if elu else g
    if dx.numel():
        _run(g, out if elu else None, w, None, dx, gp if elu else None,
             True, elu, tile)
    return dx, gp


def _conv_call(x, w, b, act):
    """Kernel for a CUDA tensor, plain version for a CPU tensor."""
    if x.is_cuda:
        return _launch(x, w, b, act)
    if x.device.type != "cpu":
        raise ValueError(f"conv3x3_bias_act: no kernel for {x.device}")
    return conv3x3_bias_act_plain(x, w, b, act)


def _dx_call(g, out, w, act):
    """(dx, g'): the kernel's dx mode for a CUDA tensor, the plain version
    for a CPU tensor."""
    if g.is_cuda:
        return _launch_dx(g, out, w, act)
    if g.device.type != "cpu":
        raise ValueError(f"conv3x3_bias_act: no kernel for {g.device}")
    return conv3x3_dx_plain(g, out, w, act)


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
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx, g = _dx_call(g.contiguous(), out, w, ctx.act)
        elif ctx.act == "elu":
            g = elu_grad(g, out)
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

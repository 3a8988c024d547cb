"""Train-mode weighted BatchNorm: the hand-written CUDA kernels
(csrc/batchnorm.cu), one launch forward and one backward, with their
autograd Function and the plain PyTorch version.

Replaces no TPU kernel: JAX writes BatchNorm as array algebra and XLA fused
it on the TPU; eager PyTorch launches ~16 forward and ~37 backward ops a
layer instead, which the one-lane training programs paid on every step.

The function (Keras BatchNormalization with per-sample weights, the
port's `models.layers.BatchNorm` in train mode): x (..., C) channel last,
w (N,) weights of the N = x.shape[0] samples (0 marks a padded sample),
    tot  = max(sum(w) * per_sample, 1)
    mean = sum(w x) / tot,  var = sum(w (x - mean)^2) / tot   (biased)
    y    = (x - mean) * rsqrt(var + 1e-3) * scale + bias
and the running statistics r = 0.99 r + 0.01 stat, written in place only
when sum(w) > 0.

Dispatch (`batchnorm_train`): on a CUDA tensor the kernels
(`BatchNormTrain`), or an exception; on a CPU tensor the plain version
(`batchnorm_train_plain`). Batched lanes never reach it: the layer calls
`batchnorm_train_functional`, which returns the running statistics instead
of writing them, inside `functional_batchnorm`, and the Function has no
vmap rule, so an unforeseen torch.func transform raises.
`LAUNCHES` counts kernel launches, a forward and a backward one each, as
`conv.LAUNCHES` counts the conv kernel's: eagerly as the host issues them;
inside a program's warm-up or capture (`tally`) into the program's tally
instead, the warm-up's into `WARMUP_LAUNCHES` and the capture's added again
at each replay of the graph (`replayed`).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from . import _build

MOMENTUM = 0.99
EPSILON = 1e-3
LAUNCHES = 0
WARMUP_LAUNCHES = 0
_COUNT = threading.Lock()   # lanes of a mesh launch from several threads
_TALLIES = {}               # stream handle -> launches issued on it
MAX_CHANNELS = 2048
MAX_ELEMENTS = 2 ** 31 - 1   # the kernel's 32-bit indices


def normalize(x, mean, var, scale, bias):
    """(x - mean) * rsqrt(var + eps) * scale + bias, per channel (last
    dim): the eval-mode forward, and the train-mode one's last step."""
    inv = torch.rsqrt(var + EPSILON)
    return (x - mean) * inv * scale + bias


def batchnorm_train_functional(x, w, scale, bias, run_mean, run_var):
    """The train-mode forward as tensor ops: returns (y, the new running
    mean, the new running var); the running buffers are left alone."""
    axes = tuple(range(x.ndim - 1))
    w = w.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    per_sample = x.numel() // x.shape[0] // x.shape[-1]
    tot = torch.clamp(w.sum() * per_sample, min=1.0)
    mean = (x * w).sum(axes) / tot
    var = (w * (x - mean) ** 2).sum(axes) / tot
    with torch.no_grad():
        m, has_data = MOMENTUM, w.sum() > 0
        new_mean = torch.where(has_data, m * run_mean + (1 - m) * mean,
                               run_mean)
        new_var = torch.where(has_data, m * run_var + (1 - m) * var, run_var)
    return normalize(x, mean, var, scale, bias), new_mean, new_var


def batchnorm_train_plain(x, w, scale, bias, run_mean, run_var):
    """The plain version of batchnorm_train: y, the running statistics
    updated in place."""
    y, new_mean, new_var = batchnorm_train_functional(x, w, scale, bias,
                                                      run_mean, run_var)
    with torch.no_grad():
        run_mean.copy_(new_mean)
        run_var.copy_(new_var)
    return y


def _count(stream):
    """One more launch on `stream` (a stream handle): in the tally of a
    program warming up or capturing there, else in LAUNCHES (under a lock:
    a backward's launches come from autograd's device thread)."""
    global LAUNCHES
    with _COUNT:
        tally = _TALLIES.get(stream)
        if tally is not None:
            tally.append(1)
            return
        LAUNCHES += 1


@contextlib.contextmanager
def tally(stream):
    """Inside the block the launches on `stream` (a torch.cuda.Stream) go
    into the list this yields, not into LAUNCHES."""
    key = stream.cuda_stream
    launches = []
    with _COUNT:
        _TALLIES[key] = launches
    try:
        yield launches
    finally:
        with _COUNT:
            del _TALLIES[key]


def add_warmup(n):
    """n launches of a program's warm-up ran."""
    global WARMUP_LAUNCHES
    with _COUNT:
        WARMUP_LAUNCHES += n


def replayed(n):
    """One replay of a graph that captured n launches."""
    global LAUNCHES
    with _COUNT:
        LAUNCHES += n


def _check(name, t, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"batchnorm kernel: {name} must be on {device}")
    if t.dtype != dtype:
        raise TypeError(f"batchnorm kernel: {name} must be {dtype}, "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"batchnorm kernel: {name} must be contiguous")


def _run(bwd, x, g, w, scale, bias, out, run_mean, run_var, save_mean,
         save_inv, dscale, dbias):
    """One launch of the forward (bwd False) or the backward kernel."""
    c = x.shape[-1]
    rows = x.numel() // c
    n = x.shape[0]
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"batchnorm kernel takes 1 <= C <= {MAX_CHANNELS}; "
                         f"got {c}")
    if x.numel() > MAX_ELEMENTS or rows < 1:
        raise ValueError(f"batchnorm kernel takes 1 <= rows and rows * C <= "
                         f"{MAX_ELEMENTS}; got x {tuple(x.shape)}")
    tensors = {"x": x, "w": w, "scale": scale, "out": out}
    tensors.update({"g": g, "dscale": dscale, "dbias": dbias} if bwd else
                   {"bias": bias, "run_mean": run_mean, "run_var": run_var})
    if tuple(w.shape) != (n,) or any(
            t.shape != (c,) for t in (scale, save_mean, save_inv)
            + (() if bwd else (bias,))):
        raise ValueError(f"batchnorm kernel: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, scale {tuple(scale.shape)}, "
                         f"bias {None if bwd else tuple(bias.shape)}")
    for name, t in tensors.items():
        _check(name, t, x.device)
    _check("save_mean", save_mean, x.device, torch.float64)
    _check("save_inv", save_inv, x.device, torch.float64)
    lib = _build.library()
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.s2s_batchnorm_f32(
            int(bwd), ptr(x), ptr(g), ptr(w), ptr(scale), ptr(bias), ptr(out),
            ptr(run_mean), ptr(run_var), ptr(save_mean), ptr(save_inv),
            ptr(dscale), ptr(dbias), rows, c, n, rows // n, 0, stream)
    _count(stream)
    if rc != 0:
        msg = lib.s2s_cuda_error_string(rc).decode()
        raise RuntimeError(f"batchnorm kernel launch failed: {msg} ({rc})")


def launch_forward(x, w, scale, bias, run_mean, run_var):
    """The forward kernel: returns (y, mean, inv = rsqrt(var + eps)), the
    statistics in float64; the running statistics are updated in place
    when sum(w) > 0."""
    y = torch.empty_like(x)
    mean = torch.empty_like(scale, dtype=torch.float64)
    inv = torch.empty_like(scale, dtype=torch.float64)
    _run(False, x, None, w, scale, bias, y, run_mean, run_var, mean, inv,
         None, None)
    return y, mean, inv


def launch_backward(g, x, w, scale, mean, inv):
    """The backward kernel, from the forward's float64 mean and inv:
    returns (dx, dscale, dbias)."""
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    dbias = torch.empty_like(scale)
    _run(True, x, g, w, scale, None, dx, None, None, mean, inv, dscale,
         dbias)
    return dx, dscale, dbias


class BatchNormTrain(torch.autograd.Function):
    """The train-mode forward kernel, with the backward kernel as its
    gradient (x, scale and bias; the weights and the running statistics
    take none)."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, run_mean, run_var):
        y, mean, inv = launch_forward(x, w, scale, bias, run_mean, run_var)
        ctx.save_for_backward(x, w, scale, mean, inv)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, scale, mean, inv = ctx.saved_tensors
        dx, dscale, dbias = launch_backward(g.contiguous(), x, w, scale, mean,
                                            inv)
        return dx, None, dscale, dbias, None, None


def kernel_applies(device):
    """Whether batchnorm_train launches the kernels for a tensor on
    `device`: a CUDA device."""
    return torch.device(device).type == "cuda"


def batchnorm_train(x, w, scale, bias, run_mean, run_var):
    """The train-mode forward, y; run_mean and run_var are updated in place
    (when sum(w) > 0). The kernels where kernel_applies, else the plain
    version."""
    if kernel_applies(x.device):
        return BatchNormTrain.apply(x.contiguous(),
                                    w.to(x.dtype).contiguous(), scale, bias,
                                    run_mean, run_var)
    return batchnorm_train_plain(x, w, scale, bias, run_mean, run_var)

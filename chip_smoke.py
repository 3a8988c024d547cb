#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (s2s_ismr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each on its own lines; any failure exits non-zero before the last
line is printed:
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles the package's CUDA kernels from csrc/;
  3. kernel vs plain: the conv3x3 kernel against its plain PyTorch version
     run in float64 (TF32 off everywhere) at every conv shape of the
     tune_ECMWF_com U-Nets (filters 2 and 3, n_blocks 3, 32x32, batch 16),
     both acts, forward and the backward's dx / dw / db, rtol 1e-4 /
     atol 1e-5 (f32, sum order only), and at a few edge shapes; then the
     forward time of kernel and plain (float32) at each slice shape;
  4. main path: the NN branch of tune_ECMWF_com (fast variant: 2 folds,
     2 trials, up to 6 epochs) on the synthetic 32x32 grid, T = 349; checks
     finite val losses and RPSS, and that the kernel was launched exactly as
     often as the executed steps imply; checks the kernel's forward at the
     path's other batch sizes (val rows, T); writes and reads back the test
     RPSS map as netcdf;
  5. the kernels JSON line, the card line, then the result line
     {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

RTOL, ATOL = 1e-4, 1e-5
BATCH = 16
# the kernel's edges: 1x1 maps, several 32-column tiles (W up to 64 in the
# 64x64 configs), C and O off the 16/32 chunk sizes, C = O = 384
EDGE_SHAPES = ((2, 1, 1, 3, 5), (3, 64, 64, 17, 33), (1, 33, 65, 2, 1),
               (1, 9, 70, 130, 40), (2, 4, 4, 384, 384))


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def unet_conv_shapes(torch, UNet, UNetConfig, FusedConv3x3, filters,
                     batch):
    """(N, H, W, C, O) of every kernel conv of the tune_ECMWF_com U-Net
    with `filters` on the 32x32 grid, recorded from one forward."""
    shapes = []
    model = UNet(UNetConfig(filters=filters, n_blocks=3), 1,
                 generator=torch.Generator().manual_seed(0), device="cuda")

    def hook(mod, args):
        s = tuple(args[0].shape) + (mod.conv.kernel.shape[-1],)
        if s not in shapes:
            shapes.append(s)
    for m in model.modules():
        if isinstance(m, FusedConv3x3):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        model(torch.zeros(batch, 32, 32, 1, device="cuda"))
    return shapes


def timed(torch, fn, reps=50):
    """(ms per call by CUDA events, host dispatch included; ms of device
    kernel time per call by torch.profiler, or None if it saw none)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages())
    return call_ms, (dev_us / 1e3 / reps if dev_us else None)


def errors(got, want):
    """Max abs / rel error of `got` against `want`, and how far the worst
    element lies past atol + rtol * |want| (<= 0 passes)."""
    diff = (got.double() - want).abs()
    excess = float((diff - (ATOL + RTOL * want.abs())).max())
    return (float(diff.max()),
            float((diff / want.abs().clamp_min(1e-30)).max()), excess)


def run_both(fn, x, k, b, g, act, dtype):
    """Forward and the backward's (dx, dw, db) of fn in `dtype`."""
    xs, ks, bs = (t.detach().to(dtype, copy=True).requires_grad_()
                  for t in (x, k, b))
    out = fn(xs, ks, bs, act)
    (out * g.to(dtype)).sum().backward()
    return out.detach(), xs.grad, ks.grad, bs.grad


def kernel_vs_plain(torch, conv, shapes, backward=True,
                    acts=("elu", "none")):
    """The kernel's forward (and backward: dx, dw, db) against the plain
    version at each shape; returns the largest abs error.

    The yardstick is the plain version in float64 on the same inputs: the
    plain float32 version goes through cuDNN, whose weight-gradient
    algorithms round more than a float32 sum does, so its error is printed
    beside the kernel's but not used as the reference."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs = 0.0
    for (n, h, w, c, o) in shapes:
        x = torch.randn(n, h, w, c, device="cuda", generator=gen)
        k = torch.randn(3, 3, c, o, device="cuda", generator=gen) \
            * (1.0 / (9 * c)) ** 0.5
        b = 0.1 * torch.randn(o, device="cuda", generator=gen)
        # upstream gradient at the scale of a mean loss over the map
        g = torch.randn(n, h, w, o, device="cuda", generator=gen) \
            / (n * h * w) ** 0.5
        for act in acts:
            if backward:
                runs = [run_both(fn, x, k, b, g, act, dt) for fn, dt in (
                    (conv.conv3x3_bias_act_plain, torch.float64),
                    (conv.conv3x3_bias_act, torch.float32),
                    (conv.conv3x3_bias_act_plain, torch.float32))]
            else:
                with torch.no_grad():
                    runs = [(conv.conv3x3_bias_act_plain(
                                x.double(), k.double(), b.double(), act),),
                            (conv.conv3x3_bias_act(x, k, b, act),),
                            (conv.conv3x3_bias_act_plain(x, k, b, act),)]
            ref, got, plain = runs
            tag = f"{(n, h, w, c, o)} {act}"
            parts = []
            for name, a, p, r in zip(("fwd", "dx", "dw", "db"), got, plain,
                                     ref):
                ea, er, ex = errors(a, r)
                pa = errors(p, r)[0]
                check(ex <= 0, f"{name} {tag}: kernel max abs err {ea:.3e} "
                      f"vs float64 exceeds rtol {RTOL} / atol {ATOL}")
                max_abs = max(max_abs, ea)
                parts.append(f"{name} {ea:.1e}/{er:.1e} (plain {pa:.1e})")
            print(f"  {tag:<28} kernel abs/rel err vs f64: "
                  + "  ".join(parts))
    return max_abs


def kernel_times(torch, conv, shapes):
    """Forward (ELU) time per call of kernel and plain at each shape;
    returns the device times summed over the shapes (ms)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    ms, plain_ms = 0.0, 0.0

    def fmt(v):
        return "n/a" if v is None else f"{v * 1e3:.2f} us"
    for (n, h, w, c, o) in shapes:
        x = torch.randn(n, h, w, c, device="cuda", generator=gen)
        k = torch.randn(3, 3, c, o, device="cuda", generator=gen)
        b = torch.randn(o, device="cuda", generator=gen)
        with torch.no_grad():
            t_k = timed(torch, lambda: conv.conv3x3_bias_act(x, k, b))
            t_p = timed(torch, lambda: conv.conv3x3_bias_act_plain(x, k, b))
        ms += t_k[1] if t_k[1] is not None else t_k[0]
        plain_ms += t_p[1] if t_p[1] is not None else t_p[0]
        print(f"  {str((n, h, w, c, o)):<28} forward (elu) per call: kernel "
              f"{t_k[0] * 1e3:.1f} us (device {fmt(t_k[1])})  plain "
              f"{t_p[0] * 1e3:.1f} us (device {fmt(t_p[1])})")
    return ms, plain_ms


def main_path(torch, conv, card, unet_mods):
    import numpy as np
    from s2s_ismr_tpu.field import Field
    from s2s_ismr_tpu.io import read_netcdf, write_netcdf
    from s2s_ismr_tpu_torch.pipelines import get_config
    from s2s_ismr_tpu_torch.pipelines.tune import load_bundles, run_nn_branch

    cfg = get_config("tune_ECMWF_com").fast_variant()
    bundles = load_bundles(cfg, source="synthetic", seed=0)
    b = bundles[cfg.models[0]]
    check(b.x.shape[0] == 349 and b.y.shape == (349, 32, 32),
          f"unexpected bundle shapes x {b.x.shape} y {b.y.shape}")

    conv.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_nn_branch(cfg, bundles, log=lambda s: print("  " + s),
                        device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = conv.LAUNCHES

    sw = res.sweeps[cfg.models[0]]
    n_folds = res.masks.n_folds
    n_conv = 4 * max(cfg.tuning.n_blocks) + 2      # conv_elu per forward
    # per step: forward + dx of every conv but the first (its input, the
    # image, needs no gradient); per epoch: one val forward; per fold: the
    # winner forward
    expected = (sw.train_steps * (2 * n_conv - 1) + sw.epochs_run * n_conv
                + n_folds * n_conv)
    print(f"  kernel launches {launches}, expected {expected} "
          f"({sw.train_steps} steps, {sw.epochs_run} epochs, "
          f"{n_folds} winner forwards, {n_conv} convs per forward)")
    check(launches == expected, "launch count does not match the steps run")
    check(np.isfinite(sw.val_loss_table).all(),
          f"non-finite val loss: {sw.val_loss_table}")
    land = b.valid_pixels()
    for split in ("rpss_train", "rpss_val", "rpss_test"):
        vals = getattr(res, split).values
        check(vals.shape == (n_folds, 32, 32), f"{split} shape {vals.shape}")
        check(np.isfinite(vals[:, land]).all(), f"{split} not finite on land")
    print(f"  val loss table {sw.val_loss_table.tolist()}")
    # the main path's other batch sizes: val rows (per-epoch val forward)
    # and T (winner forward), for the widths it trained
    filters = sorted({t.filters for t in sw.best_trial})
    batches = (int(res.masks.val.sum(1).max()), b.x.shape[0])
    print(f"  kernel vs plain forward at N = {batches}, filters {filters}")
    max_abs = max(kernel_vs_plain(
        torch, conv, unet_conv_shapes(torch, *unet_mods, f, n),
        backward=False, acts=("elu",)) for f in filters for n in batches)
    print(f"  mean test RPSS on land per fold "
          f"{res.rpss_test.values[:, land].mean(1).tolist()}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "rpss_test.nc")
        write_netcdf(res.rpss_test, path, var_name="rpss")
        back = read_netcdf(path, var_name="rpss")
        check(isinstance(back, Field) and back.dims == res.rpss_test.dims
              and np.array_equal(back.values, res.rpss_test.values,
                                 equal_nan=True),
              "netcdf round trip changed the test RPSS map")
    print(f"  netcdf round trip of the test RPSS map: ok")
    print(f"  main path: {sw.train_steps} optimizer steps in "
          f"{seconds:.2f} s = {sw.train_steps / seconds:.1f} steps/s "
          f"on {card}")
    return launches, max_abs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from s2s_ismr_tpu_torch.kernels import _build, conv
    from s2s_ismr_tpu_torch.models.layers import FusedConv3x3
    from s2s_ismr_tpu_torch.models.unet import UNet, UNetConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        print("[1/4] device")
        card = card_line()
        print(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
              f"torch {torch.__version__} cuda {torch.version.cuda}")

        print("[2/4] build")
        info = _build.build()
        _build.library()
        print(f"  built {os.path.relpath(info['path'])} in "
              f"{info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

        print("[3/4] kernel vs plain (TF32 off), batch 16")
        unet_mods = (UNet, UNetConfig, FusedConv3x3)
        shapes = []
        for f in (2, 3):
            shapes += [s for s in unet_conv_shapes(torch, *unet_mods, f, BATCH)
                       if s not in shapes]
        max_abs = kernel_vs_plain(torch, conv, shapes)
        print("  edge shapes")
        max_abs = max(max_abs, kernel_vs_plain(torch, conv, EDGE_SHAPES))
        ms, plain_ms = kernel_times(torch, conv, shapes)
        print(f"  {len(shapes)} shapes: forward device time summed over "
              f"the shapes, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
              f"max abs err {max_abs:.3e}")

        print("[4/4] main path: tune_ECMWF_com NN branch, fast variant")
        launches, main_abs = main_path(torch, conv, card, unet_mods)
        max_abs = max(max_abs, main_abs)
        check("jax" not in sys.modules, "jax was imported")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [{
        "name": "conv3x3_bias_act", "route": "cuda",
        "source": "s2s_ismr_tpu_torch/csrc/conv3x3.cu",
        "replaces": "s2s_ismr_tpu/kernels/conv.py:78",
        "launches": launches, "max_abs_err": max_abs,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (s2s_ismr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each on its own lines; any failure exits non-zero before the last
line is printed:
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles the package's CUDA kernels from csrc/ (the wrapper's
     tile table and K chunk must equal the library's);
  3. kernel vs plain: the conv3x3 kernel against its plain PyTorch version
     run in float64 (TF32 off everywhere) at every conv shape of the
     tune_ECMWF_com U-Nets (filters 2 and 3, n_blocks 3, 32x32, batch 16),
     of the CNN (num_filters 16, act 'none') and of the U-Net's first conv
     under multi_predictor (C = 11 and 24 members), at the realtime path's
     shapes (N = 21 rows: the filters-2 U-Net's convs and the cnn's, whose
     first dx writes C = 1), and at the edge shapes,
     rtol 1e-4 / atol 1e-5 (f32, sum order only): the forward, dx / dw / db
     through the autograd backward, and the dx mode itself (dx and g'),
     every launch twice and bit-equal; then, at each of these shapes, the
     device time of the kernel and of cuDNN's F.conv2d in turns, and of the
     plain version, for the forward and the dx mode, beside the bound and
     the kernel's share of it (FLOP at the float32 rate, and beside it at
     the 3xTF32 rate);
  4. main path: the NN branch of tune_ECMWF_com (fast variant: 2 folds,
     2 trials, up to 6 epochs) on the synthetic 32x32 grid, T = 349; checks
     finite val losses and RPSS, and that the kernel was launched exactly as
     often as the executed steps imply; checks the kernel's forward at the
     path's other batch sizes (val rows, T); writes and reads back the test
     RPSS map as netcdf;
  5. main path of the CLI: `run.main(["tune_ECMWF_com", "--synthetic",
     "--fast", "--out", <dir>])` in-process on cuda (data, ELR, NN, skill
     mask, outputs); checks the exit code, the outputs tree file by file,
     ELR and U-Net test RPSS finite on land in every fold, the launch count
     against the executed steps, and that each fold's winner reloaded from
     disk reproduces the sweep's predictions bit for bit;
  6. the other run modes on cuda, in-process, each with its own --out:
     the CLI's `--training-type train` then `load` on the same out (the
     load's predictions bit-equal to the train run's), `--output
     deterministic`, `--predictor multi_predictor`, `--predictor stacked
     --epochs 2` (11 x 349 rows: the winner forward runs in two row
     chunks), and run_pipeline of the cnn and the mlp (phase 5's and the
     cnn's outputs are kept for phase 8); for each, the exit
     code, the outputs tree, test RPSS finite on land in every fold, the
     kernel launches against what the executed steps, epochs and forwards
     imply (the mlp: none), wall time and steps/s; then the kernel's
     forward against float64 at those runs' other batch sizes;
  7. the ELR branch of the full tune_ECMWF_com and tune_2MME (10 folds) on
     cuda and on the CPU: NaN pattern identical, probabilities within 1e-4,
     test-RPSS means within 1e-5 (the TPU v5e means of
     expected/suite_rpss_v5e.json are printed beside, not compared);
  8. the realtime path on cuda, in-process: (a) `run.main(["realtime",
     "--from-config", "tune_ECMWF_com", "--synthetic", "--out", <phase 5's
     dir>])` (the final year's 21 rows; GradCAM runs the dx mode of the
     U-Net decoder's convs), (b) run_realtime_eval of the cnn winners of
     phase 6 (saliency: the dx mode of every conv, the first at C = 1),
     (c) run_realtime_forecast of two init dates on a fake gateway cache
     (forecasts, obs and RMM / Nino3.4 written with scipy) with phase 5's
     winners; each checked for its outputs tree, probabilities summing to
     1, GradCAM in [0, 1], RPSS finite on land, launches equal to what its
     forwards and dx launches imply, a repeat bit-equal netcdf by netcdf
     and the same run on the CPU within the tests' tolerances; then
     GradCAM's time per chunk;
  9. reporting and profiler traces on cuda, in-process: (a) `run.main(
     ["accs", "--synthetic", "--out", <dir>])` (ECMWF, IITM and GEFS, five
     lead windows each, 16x16, 2003-2018): 15 ccacc netcdfs of (metric=4,
     Y, X), CC and ACC finite on land and in [-1, 1], a repeat bit-equal
     file by file, the same run with --cpu within 1e-5, no conv launch;
     (b) REL / BSS / RES of phase 7's 10-fold ELR test probabilities (per
     category) and CC / ACC of one accs bundle (sample and external
     (53, Y, X) climatology) on cuda against float64 numpy versions of the
     reference's formulas within 1e-5, against the CPU within 1e-6,
     repeats bit-equal; (c) analysis.rpss_records over phase 5's outputs
     (ELR and U-Net, masked by the ELR map): rows per run equal to its
     finite pixels; (d) the CLI's fast tune run at `--epochs 1`, untraced,
     then with `--profile <dir>`: a Chrome trace of the ELR stage and one
     of the NN stage, both parse and hold CUDA kernel events, the conv
     kernel's events in the NN trace equal to the launches the executed
     steps imply; each trace's size and write time, and both runs' walls
     and stages, printed;
then checks that neither jax nor any module of the JAX package
(s2s_ismr_tpu) was loaded; prints the kernels JSON line (launches summed
over phases 4, 5, 6, 8 and 9; times and bounds summed over the shapes of
phase 3, the forward under ms / plain_ms / library_ms / bound_ms /
bound_3xtf32_ms, the dx mode under dx_*), the card line, then the result
line {"ok": true, ...}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

BATCH = 16
# shapes (N, H, W, C, O) the slice's other modes add, with their act: the
# CNN (num_filters 16) and the U-Net's first conv with the members as
# channels (11 for ECMWF and GEFS, 24 for IITM; (16, 32, 32, 24, 12) is
# already a slice shape, up1_conv1 at filters 3)
CNN_SHAPES = ((16, 32, 32, 1, 16), (16, 32, 32, 16, 32),
              (16, 32, 32, 32, 64), (16, 32, 32, 64, 3))
MULTI_SHAPES = ((16, 32, 32, 11, 8), (16, 32, 32, 11, 12),
                (16, 32, 32, 24, 8))
# rows of the realtime period, the final year of tune_ECMWF_com's record
RT_ROWS = 21


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


def errors(got, want):
    """Max abs / rel error of `got` against `want`, and how far the worst
    element lies past atol + rtol * |want| (<= 0 passes)."""
    diff = (got.double() - want).abs()
    excess = float((diff - (bench.ATOL + bench.RTOL * want.abs())).max())
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
    """The kernel's forward (and, through the autograd backward, dx, dw,
    db) against the plain version at each shape; with `backward`, also the
    dx mode itself (dx and g') and bit-equal repeats of every launch.
    Returns the largest abs error.

    The yardstick is the plain version in float64 on the same inputs: the
    plain float32 version goes through cuDNN, whose weight-gradient
    algorithms round more than a float32 sum does, so its error is printed
    beside the kernel's but not used as the reference."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs = 0.0
    for shape in shapes:
        x, k, b, g = bench.inputs(torch, shape, gen)
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
            tag = f"{shape} {act}"
            parts = []
            for name, a, p, r in zip(("fwd", "dx", "dw", "db"), got, plain,
                                     ref):
                ea, er, ex = errors(a, r)
                pa = errors(p, r)[0]
                check(ex <= 0, f"{name} {tag}: kernel max abs err {ea:.3e} "
                      f"vs float64 exceeds rtol {bench.RTOL} / atol "
                      f"{bench.ATOL}")
                max_abs = max(max_abs, ea)
                parts.append(f"{name} {ea:.1e}/{er:.1e} (plain {pa:.1e})")
            print(f"  {tag:<28} kernel abs/rel err vs f64: "
                  + "  ".join(parts))
        if backward:
            # the dx mode itself (dx and g'), both acts, every launch twice
            try:
                errs = bench.check_tile(torch, conv, shape, None, gen)
            except AssertionError as e:
                raise SmokeFailure(str(e)) from None
            max_abs = max(max_abs, *errs.values())
            print(f"  {str(shape):<28} dx mode vs f64 and repeats bit-equal: "
                  + " ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    return max_abs


def kernel_times(torch, conv, shapes, act="elu"):
    """Device time per launch at each shape, by torch.profiler, of the
    kernel and of cuDNN's F.conv2d (the library yardstick, TF32 off), in
    turns (kernel, cuDNN, kernel, cuDNN), and of the plain version once:
    the forward (bias + act) and the dx mode (for ELU: dx and g'). cuDNN's
    dx is one F.conv2d of g with the adjoint taps made beforehand, so for
    ELU it does less than the kernel (no ELU', no g'). Returns the sums
    over the shapes, in ms, with the bound summed the same way."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    keys = ("ms", "library_ms", "plain_ms", "bound_ms", "ops_ms",
            "bytes_ms", "bound_3xtf32_ms")
    tf32x3 = bench.PEAK_TF32_FLOPS / 3
    sums = {m: dict.fromkeys(keys, 0.0) for m in ("fwd", "dx")}
    for shape in shapes:
        x, k, b, g = bench.inputs(torch, shape, gen)
        elu = act == "elu"
        with torch.no_grad():
            out = conv.conv3x3_bias_act(x, k, b, act)
            x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            k_oihw = k.permute(3, 2, 0, 1).contiguous()
            k_adj = k.flip((0, 1)).transpose(2, 3).permute(3, 2, 0, 1) \
                .contiguous()
            calls = {
                "fwd": (lambda: conv.conv3x3_bias_act(x, k, b, act),
                        lambda: F.conv2d(x_nchw, k_oihw, b, padding=1),
                        lambda: conv.conv3x3_bias_act_plain(x, k, b, act)),
                "dx": (lambda: conv._dx_call(g, out, k, act),
                       lambda: F.conv2d(g_nchw, k_adj, None, padding=1),
                       lambda: conv.conv3x3_dx_plain(g, out, k, act))}
            parts = []
            for mode, (kern, lib, plain) in calls.items():
                t = [bench.device_ms(torch, f)
                     for f in (kern, lib, kern, lib, plain)]
                check(None not in t, f"{shape} {mode}: the profiler saw no "
                      f"device time")
                ms, lib_ms = (t[0] + t[2]) / 2, (t[1] + t[3]) / 2
                t_ops, t_bytes = bench.bound_parts(shape, mode == "dx", elu)
                bnd, by = bench.bound(shape, mode == "dx", elu)
                bnd3, by3 = bench.bound(shape, mode == "dx", elu,
                                        flops=tf32x3)
                s = sums[mode]
                for key, v in zip(keys, (ms, lib_ms, t[4], bnd, t_ops,
                                         t_bytes, bnd3)):
                    s[key] += v
                parts.append(
                    f"{mode}: kernel {t[0] * 1e3:.2f}/{t[2] * 1e3:.2f} us, "
                    f"cuDNN {t[1] * 1e3:.2f}/{t[3] * 1e3:.2f} us, plain "
                    f"{t[4] * 1e3:.2f} us, bound {bnd * 1e3:.3f} us "
                    f"({by}), {bnd / ms:.1%} of bound; at 3xTF32 "
                    f"{bnd3 * 1e3:.3f} us ({by3}), {bnd3 / ms:.1%}")
        print(f"  {str(shape):<22} {act:<4} " + "   ".join(parts))
    return sums


def main_path(torch, conv, card):
    import numpy as np
    from s2s_ismr_tpu_torch.field import Field
    from s2s_ismr_tpu_torch.io import read_netcdf, write_netcdf
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
        torch, conv, bench.slice_shapes(torch, (f,), n),
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


def cli_run(torch, conv, argv):
    """run.main(argv) in-process with the kernel's launch count set to 0
    just before; returns (the run's TuneOutputs, wall s, launches)."""
    from s2s_ismr_tpu_torch import run
    from s2s_ismr_tpu_torch.pipelines import tune
    outs = []
    real = tune.run_pipeline

    def recording(*args, **kw):         # keeps the run's in-memory result
        outs.append(real(*args, **kw))
        return outs[-1]

    tune.run_pipeline = recording
    try:
        conv.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = run.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = conv.LAUNCHES
    finally:
        tune.run_pipeline = real
    check(rc == 0 and len(outs) == 1, f"run.main({argv}) returned {rc}")
    return outs[0], seconds, launches


def out_dirs(root, cfg):
    """(outputs dir, models dir) of a single-model run under root."""
    return (os.path.join(root, "outputs", cfg.out_dir,
                         f"{cfg.result_name}_{cfg.obs}"),
            os.path.join(root, "models", cfg.out_dir,
                         f"{cfg.models[0]}_{cfg.obs}", cfg.week))


def check_tree(root, out, suffix):
    """The run's outputs under root are the JAX CLI's tree, file by file:
    the RPSS netcdfs, best_hparams and profile, and the winners manifest
    with best_model_{arch}_{fold}_{suffix}.pt."""
    cfg, wk, arch = out.config, out.config.week, out.config.architecture
    odir, mdir = out_dirs(root, cfg)
    want = ([os.path.join(odir, f"ELR_rpss_{t}_{wk}.nc")
             for t in ("train", "test")]
            + [os.path.join(odir, f"{arch}_rpss_{t}_{wk}.nc")
               for t in ("train", "val", "test")]
            + [os.path.join(odir, f"{s}_{wk}.json")
               for s in ("best_hparams", "profile")]
            + [os.path.join(mdir, f"winners_{wk}.json")]
            + [os.path.join(mdir, f"best_model_{arch}_{i}_{suffix}.pt")
               for i in range(out.nn.masks.n_folds)])
    found = sorted(os.path.join(r, f) for r, _, fs in os.walk(root)
                   for f in fs)
    check(found == sorted(want), f"outputs: missing "
          f"{sorted(set(want) - set(found))}, unexpected "
          f"{sorted(set(found) - set(want))}")
    return len(found)


def check_rpss(root, out, land, tags=None):
    """Each test RPSS netcdf equals the run's map and is finite on land in
    every fold; returns the per-fold means on land."""
    import numpy as np
    from s2s_ismr_tpu_torch.io import read_netcdf
    cfg, wk = out.config, out.config.week
    odir, _ = out_dirs(root, cfg)
    means = {}
    for tag, fld in (tags or {cfg.architecture: out.nn.rpss_test}).items():
        back = read_netcdf(os.path.join(odir, f"{tag}_rpss_test_{wk}.nc"))
        check(np.array_equal(back.values, fld.values, equal_nan=True),
              f"{tag} test RPSS netcdf differs from the run's map")
        n_folds = out.nn.masks.n_folds
        check(back.values.shape == (n_folds,) + land.shape
              and np.isfinite(back.values[:, land]).all(),
              f"{tag} test RPSS not finite on land in every fold")
        means[tag] = back.values[:, land].mean(1).tolist()
    return means


def expected_launches(torch, out, load=False):
    """Kernel launches a run implies: per optimizer step the forward and
    the dx of every kernel conv but the first (its input, the image, needs
    no gradient); per epoch one val forward over the val rows; per fold one
    winner forward over all rows (a load runs only these). Eval forwards
    run in row chunks (engine.row_chunk). Returns (count, its terms)."""
    from s2s_ismr_tpu_torch.train.engine import row_chunk
    cfg = out.config
    n_conv = {"unet": 4 * max(cfg.tuning.n_blocks) + 2, "cnn": 4,
              "mlp": 0}[cfg.architecture]
    F, T = out.nn.labels.shape[:2]
    chunk = row_chunk(torch.empty((1,) + out.nn.labels.shape[2:]))
    val_rows = int(out.nn.masks.val.sum(1).max())
    fwd_chunks = -(-T // chunk)
    count = F * n_conv * fwd_chunks
    if not load and n_conv:
        count += (out.nn.train_steps * (2 * n_conv - 1)
                  + out.nn.epochs_run * n_conv * -(-val_rows // chunk))
    terms = (f"{out.nn.train_steps} steps, {out.nn.epochs_run} epochs, "
             f"{F} winner forwards of {T} rows in {fwd_chunks} chunk(s), "
             f"{n_conv} kernel convs per forward")
    return count, terms


def pipeline_path(torch, conv, card, d):
    """The CLI's whole tune run in-process on cuda, its outputs under d
    (kept for the realtime phase); returns the kernel launches of that
    run."""
    from s2s_ismr_tpu_torch.pipelines import tune
    from s2s_ismr_tpu_torch.train import checkpoint
    from s2s_ismr_tpu_torch.train.engine import predict

    argv = ["tune_ECMWF_com", "--synthetic", "--fast"]
    out, seconds, launches = cli_run(torch, conv, argv + ["--out", d])
    cfg, wk = out.config, out.config.week
    odir, mdir = out_dirs(d, cfg)
    n_folds = out.nn.masks.n_folds
    n = check_tree(d, out, "tuned")
    print(f"  outputs: {n} files, as the JAX CLI writes them")

    bundle = tune.load_bundles(cfg)["ECMWF"]
    means = check_rpss(d, out, bundle.valid_pixels(),
                       {"ELR": out.elr.rpss_test,
                        "unet": out.nn.rpss_test})
    for tag, m in means.items():
        print(f"  {tag} test RPSS on land per fold {m}")

    with open(os.path.join(odir, f"profile_{wk}.json")) as fh:
        prof = json.load(fh)
    sw = out.nn.sweeps["ECMWF"]
    steps, epochs = sw.train_steps, sw.epochs_run
    check(prof["counters"] == {"train_steps": steps,
                               "epochs_run": epochs},
          f"profile counters {prof['counters']}")
    expected, terms = expected_launches(torch, out)
    print(f"  kernel launches {launches}, expected {expected} ({terms})")
    check(launches == expected, "launch count does not match the steps")

    # replay: each fold's winner from disk, the sweep's shapes (all T)
    x = torch.as_tensor(bundle.fillna(0.0).predictor_images("mean"),
                        device="cuda")
    for f in range(n_folds):
        model, _ = checkpoint.load_winner(mdir, wk, f, device="cuda")
        got = predict(model, None, x)
        sweep_preds = out.nn.predictions[f]
        if not torch.equal(got, sweep_preds):
            diff = float((got - sweep_preds).abs().max())
            again = torch.equal(predict(model, None, x), got)
            raise SmokeFailure(
                f"fold {f}: reloaded winner differs from the sweep's "
                f"predictions, max abs diff {diff:.3e} (a second "
                f"forward of the reloaded model is "
                f"{'equal to' if again else 'different from'} its "
                f"first)")
    print(f"  {n_folds} winners reloaded from disk: predictions "
          f"bit-equal to the sweep's")
    st = prof["stages_s"]
    print(f"  pipeline wall {seconds:.2f} s (stages: data {st['data']} s, "
          f"ELR {st['elr']} s, NN {st['nn']} s; {steps} steps) on {card}")
    return launches


def modes_path(torch, conv, card, tmp):
    """The other run modes on cuda, each with its own --out under tmp (the
    cnn's, tmp/cnn, kept for the realtime phase); returns the kernel
    launches summed over them and the largest error of the kernel's
    forward against float64 at their other batch sizes."""
    from dataclasses import replace

    from s2s_ismr_tpu_torch.pipelines import get_config, tune

    base = ["tune_ECMWF_com", "--synthetic", "--fast"]
    fast = get_config("tune_ECMWF_com").fast_variant()
    land = tune.load_bundles(fast)["ECMWF"].valid_pixels()
    total, rows = 0, {}

    def pipeline(cfg, out_root):
        conv.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tune.run_pipeline(cfg, out_root=out_root, log=lambda s: None,
                                device="cuda")
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, conv.LAUNCHES

    def report(name, root, run, suffix, load=False):
        nonlocal total
        out, seconds, launches = run
        n = check_tree(root, out, suffix)
        means = check_rpss(root, out, land)
        expected, terms = expected_launches(torch, out, load)
        steps = out.nn.train_steps
        print(f"  {name}: {n} files as the JAX CLI writes them; test RPSS "
              f"on land per fold {means[out.config.architecture]}; kernel "
              f"launches {launches}, expected {expected} ({terms}); wall "
              f"{seconds:.2f} s, {steps} steps = {steps / seconds:.1f} "
              f"steps/s on {card}")
        check(launches == expected,
              f"{name}: launch count does not match the run")
        total += launches
        rows[name] = out
        return out

    d = os.path.join(tmp, "train")
    trained = report("--training-type train", d, cli_run(
        torch, conv, base + ["--training-type", "train", "--out", d]),
        "trained")
    loaded = report("--training-type load (same --out)", d, cli_run(
        torch, conv, base + ["--training-type", "load", "--out", d]),
        "trained", load=True)
    check(torch.equal(loaded.nn.predictions, trained.nn.predictions),
          "the load's predictions differ from the train run's")
    for split in ("rpss_train", "rpss_val", "rpss_test"):
        check((getattr(loaded.nn, split).values.tobytes()
               == getattr(trained.nn, split).values.tobytes()),
              f"the load's {split} differs from the train run's")
    print("  load: predictions and RPSS maps bit-equal to the train "
          "run's")
    for name, extra in (("deterministic", ["--output", "deterministic"]),
                        ("multi_predictor",
                         ["--predictor", "multi_predictor"]),
                        ("stacked", ["--predictor", "stacked",
                                     "--epochs", "2"])):
        d = os.path.join(tmp, name)
        report(" ".join(extra[:2]), d, cli_run(
            torch, conv, base + extra + ["--out", d]), "tuned")
    for arch in ("cnn", "mlp"):
        d = os.path.join(tmp, arch)
        report(f"run_pipeline {arch}", d, pipeline(
            replace(fast, architecture=arch), d), "trained")

    # the kernel's forward at these runs' other batch sizes: the stacked
    # winner forward's two row chunks, and the val rows and all T of the
    # multi_predictor first conv and of the cnn
    from s2s_ismr_tpu_torch.train.engine import row_chunk
    stacked = rows["--predictor stacked"]
    T2 = stacked.nn.labels.shape[1]
    chunk = row_chunk(torch.empty(1, 32, 32, 1))
    check(T2 == 11 * 349 and -(-T2 // chunk) == 2,
          f"stacked rows {T2}, chunk {chunk}")
    shapes = [s for n in (chunk, T2 - chunk)
              for s in bench.slice_shapes(torch, (2,), n)]
    multi = rows["--predictor multi_predictor"]
    cnn = rows["run_pipeline cnn"]
    ns = (int(multi.nn.masks.val.sum(1).max()), multi.nn.labels.shape[1])
    print(f"  kernel vs plain forward at the stacked chunks {chunk} and "
          f"{T2 - chunk} (filters 2), and at N = {ns} for the "
          f"multi_predictor first conv and the cnn")
    max_abs = kernel_vs_plain(torch, conv, shapes, backward=False,
                              acts=("elu",))
    max_abs = max(max_abs, kernel_vs_plain(
        torch, conv, [(n, 32, 32, 11, 8) for n in ns], backward=False,
        acts=("elu",)))
    max_abs = max(max_abs, kernel_vs_plain(
        torch, conv, [(n,) + s[1:] for n in ns for s in CNN_SHAPES],
        backward=False, acts=("none",)))
    check(rows["run_pipeline mlp"].nn.train_steps > 0 and cnn.nn.epochs_run,
          "the cnn or mlp trained nothing")
    return total, max_abs


RT_DATES = ("2023-06-15", "2023-06-22")


def fake_operational_cache(cache, cfg, lats, lons):
    """The gateway's cache for run_realtime_forecast(download=False): one
    dated forecast per RT_DATES init date on the config's grid, the
    verifying obs at the mid-lead valid times, and the RMM / Nino3.4
    series, written as tests/test_realtime_operational.py and
    tests/test_indices_mjo_enso.py write them."""
    import numpy as np
    from scipy.io import netcdf_file
    epoch = np.datetime64("1999-01-01")

    def days(d):
        return float((np.datetime64(d) - epoch) / np.timedelta64(1, "D"))

    def write(path, var, dims, coords, values):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with netcdf_file(path, "w") as f:
            for dim in dims:
                f.createDimension(dim, len(coords[dim]))
                v = f.createVariable(dim, np.float64, (dim,))
                v[:] = coords[dim]
                if dim in ("S", "T"):
                    v.units = "days since 1999-01-01"
            dv = f.createVariable(var, np.float32, dims)
            dv[:] = np.asarray(values, np.float32)

    rng = np.random.default_rng(0)
    members = 11                      # ECMWF's ensemble
    model = cfg.models[0]
    lead = cfg.lead(model)
    mid = np.timedelta64(int(round((lead[0] + lead[1]) / 2)), "D")
    fdir = os.path.join(cache, cfg.out_dir, f"{model}_{cfg.obs}")
    shape = (len(lats), len(lons))
    for date in RT_DATES:
        d = np.datetime64(date).astype(object)
        write(os.path.join(fdir, f"forecast_{model}_{d.day}_"
                           f"{d.strftime('%b')}_{d.year}_ld{lead[0]}-"
                           f"{lead[1]}.nc"),
              "prcp", ("S", "M", "Y", "X"),
              {"S": np.array([days(date)]),
               "M": np.arange(1.0, members + 1.0), "Y": lats, "X": lons},
              rng.gamma(2, 2, size=(1, members) + shape))
    t_obs = [days(str(np.datetime64(d) + mid)) for d in RT_DATES]
    write(os.path.join(fdir, f"{cfg.obs}_{cfg.week}.nc"), "prcp",
          ("T", "Y", "X"), {"T": np.array(t_obs), "Y": lats, "X": lons},
          rng.gamma(2, 2, size=(len(t_obs),) + shape))
    daily = np.array([days(f"2023-06-{d:02d}") for d in range(1, 31)])
    for name, t, vals in (
            ("RMM1", daily, np.linspace(-2, 2, 30)),
            ("RMM2", daily, np.linspace(2, -2, 30)),
            ("NINO34", np.array([days(f"2023-{m:02d}-16")
                                 for m in range(1, 13)]),
             [1.2, 0.9, 0.4, 0.1, -0.2, -0.6, -0.8, -0.6, -0.3, 0.1, 0.6,
              1.1])):
        write(os.path.join(cache, "indices", f"{name}.nc"), name, ("T",),
              {"T": t}, vals)


def realtime_cli(run, realtime, argv):
    """run.main(argv) in-process with its stdout captured; returns (the
    run_realtime_eval result, the paths JSON it printed)."""
    import contextlib
    import io
    outs, real = [], realtime.run_realtime_eval

    def recording(*args, **kw):
        outs.append(real(*args, **kw))
        return outs[-1]

    realtime.run_realtime_eval = recording
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = run.main(argv)
    finally:
        realtime.run_realtime_eval = real
    text = buf.getvalue()
    check(rc == 0 and len(outs) == 1, f"run.main({argv}) returned {rc}")
    printed = json.loads(text[text.index("{\n"):])
    check(printed == outs[0][1], "the printed paths JSON differs from the "
          "run's paths")
    return outs[0]


def timed(torch, conv, fn):
    """fn() with the kernel's launch count set to 0 just before; returns
    (result, paths, wall s, launches)."""
    conv.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, paths = fn()
    torch.cuda.synchronize()
    return res, paths, time.perf_counter() - t0, conv.LAUNCHES


def realtime_files(res, week, tag=None):
    """The netcdf names a realtime run writes: eval's, or with `tag` the
    operational forecast's."""
    mid = f"{tag}_" if tag else ""
    names = ([f"fcst_{k}_{tag}_{week}.nc" for k in
              ("probs_above", "gradcam", "rpss")] if tag else
             [f"{k}_{week}.nc" for k in
              ("probs_above", "gradcam", "rpss_realtime")])
    return sorted(names + [f"{kind}_{k}_{mid}{week}.nc"
                           for kind, comps in (("mjo", res.mjo_composites),
                                               ("enso", res.enso_composites))
                           for k in comps])


def realtime_case(torch, conv, card, name, model, fn, cpu_fn, land, week,
                  tag=None):
    """One realtime run fn() on cuda of the winner `model`, its launch count set to 0 just before and
    read just after; then the checks: the outputs tree file by file,
    probabilities summing to 1, attribution maps finite (GradCAM in
    [0, 1]), RPSS finite on land, launches equal to what the forwards and
    dx launches imply, a second run bit-equal netcdf by netcdf, and the
    same run on the CPU (the plain versions) within the tests'
    tolerances. Returns (launches, {quantity: max cuda-vs-CPU diff})."""
    import numpy as np
    from s2s_ismr_tpu_torch.io import read_netcdf
    from s2s_ismr_tpu_torch.models import UNet
    from s2s_ismr_tpu_torch.train.engine import row_chunk

    res, paths, seconds, launches = timed(torch, conv, fn)
    odir = os.path.dirname(paths["probs"])
    on_disk = sorted(os.listdir(odir))
    check(on_disk == realtime_files(res, week, tag)
          and sorted(os.path.basename(p) for p in paths.values()) == on_disk,
          f"{name}: outputs {on_disk} against "
          f"{realtime_files(res, week, tag)}")
    n = res.probs.shape[0]
    check(np.allclose(res.probs.sum(-1), 1.0, atol=1e-5),
          f"{name}: probabilities do not sum to 1")
    maps = res.gradcam_maps
    check(maps.shape == res.probs.shape[:-1] and np.isfinite(maps).all(),
          f"{name}: attribution maps not finite")
    check(res.rpss_map is not None and np.isfinite(res.rpss_map[land]).all(),
          f"{name}: RPSS not finite on land")

    # launches: per row chunk the predict forward (every kernel conv) and
    # the attribution: GradCAM's forward + the dx mode of the decoder's
    # 2 * n_blocks convs (its gradient starts at the bottleneck tap), or
    # saliency's forward + the dx mode of every conv (the image's gradient)
    chunks = -(-n // row_chunk(torch.empty((1,) + maps.shape[1:])))
    if isinstance(model, UNet):
        check(maps.min() >= 0.0 and maps.max() <= 1.0 + 1e-6,
              f"{name}: GradCAM outside [0, 1]")
        n_conv, n_dx = 4 * model.config.n_blocks + 2, 2 * model.config.n_blocks
        formula = (f"{chunks} chunk(s) x (predict {n_conv} + GradCAM "
                   f"{n_conv} forward + {n_dx} dx)")
    else:
        check(maps.min() >= 0.0, f"{name}: saliency negative")
        n_conv = n_dx = 4
        formula = (f"{chunks} chunk(s) x (predict {n_conv} + saliency "
                   f"{n_conv} forward + {n_dx} dx, the first at C = 1)")
    expected = chunks * (2 * n_conv + n_dx)
    print(f"  {name}: {n} rows, wall {seconds:.3f} s on {card}; kernel "
          f"launches {launches}, expected {expected} = {formula}")
    check(launches == expected, f"{name}: launch count does not match")

    first = {k: read_netcdf(p) for k, p in paths.items()}
    res2, paths2, seconds2, launches2 = timed(torch, conv, fn)
    check(paths2 == paths and launches2 == launches,
          f"{name}: the repeat wrote other files or launched otherwise")
    for k, p in paths2.items():
        a, b = first[k], read_netcdf(p)
        check(a.dims == b.dims and a.values.tobytes() == b.values.tobytes()
              and all(np.array_equal(a.coords[d], b.coords[d])
                      for d in a.coords),
              f"{name}: the repeat's {os.path.basename(p)} differs")

    cpu = cpu_fn()
    diffs = {"probs": np.abs(cpu.probs - res.probs).max()}
    check(np.array_equal(np.isnan(cpu.labels), np.isnan(res.labels))
          and np.array_equal(cpu.labels[np.isfinite(cpu.labels)],
                             res.labels[np.isfinite(res.labels)]),
          f"{name}: labels differ between cuda and the CPU")
    for key in ("rps_map", "rpss_map"):
        a, b = getattr(cpu, key), getattr(res, key)
        check(np.array_equal(np.isnan(a), np.isnan(b)),
              f"{name}: {key} NaN pattern differs between cuda and the CPU")
        diffs[key] = np.nanmax(np.abs(a - b))
    for kind in ("mjo_composites", "enso_composites"):
        a, b = getattr(cpu, kind), getattr(res, kind)
        check(sorted(a) == sorted(b), f"{name}: {kind} groups differ")
        diffs[kind] = max(np.nanmax(np.abs(a[k] - b[k])) for k in a)
    attr = np.abs(cpu.gradcam_maps - maps)
    diffs["attribution"] = attr.max()
    tol = {"probs": 1e-5, "rps_map": 1e-5, "rpss_map": 1e-5,
           "mjo_composites": 1e-5, "enso_composites": 1e-5}
    for key, t in tol.items():
        check(diffs[key] <= t, f"{name}: {key} cuda vs CPU {diffs[key]:.3e}"
              f" > {t}")
    if isinstance(model, UNet):
        check(diffs["attribution"] <= 1e-5,
              f"{name}: GradCAM cuda vs CPU {diffs['attribution']:.3e} > 1e-5")
    else:
        excess = (attr - (1e-6 + 1e-4 * np.abs(cpu.gradcam_maps))).max()
        check(excess <= 0, f"{name}: saliency cuda vs CPU beyond rtol 1e-4 "
              f"/ atol 1e-6 (max abs {diffs['attribution']:.3e})")
    print(f"  {name}: repeat bit-equal ({len(paths2)} netcdfs, wall "
          f"{seconds2:.3f} s); cuda vs CPU max abs diff "
          + ", ".join(f"{k} {float(v):.3e}" for k, v in diffs.items()))
    return launches, diffs


def realtime_path(torch, conv, card, unet_root, cnn_root, tmp):
    """The realtime path on cuda: (a) the CLI's `realtime` on phase 5's
    U-Net winners (GradCAM: the dx mode of the decoder's convs), (b)
    run_realtime_eval on phase 6's cnn winners (saliency: the dx mode of
    every conv, the first at C = 1), (c) run_realtime_forecast of two init
    dates on a fake gateway cache with the U-Net winners; then GradCAM's
    device time per chunk. Returns the launches of the three runs."""
    import shutil
    from dataclasses import replace

    import numpy as np
    from s2s_ismr_tpu_torch import attrib, run
    from s2s_ismr_tpu_torch.pipelines import get_config, realtime, tune

    cfg = get_config("tune_ECMWF_com")
    wk = cfg.week
    bundle = tune.load_bundles(cfg)["ECMWF"]
    land = bundle.valid_pixels()
    mdir = os.path.join(unet_root, "models", cfg.out_dir, "ECMWF_IMD", wk)

    def copy_winners(src, dst):
        shutil.copytree(os.path.join(src, "models"),
                        os.path.join(dst, "models"))
        return dst

    def quiet(*a):
        pass

    launches, worst = 0, {}
    unet, unet_state = realtime.load_winner_for_realtime(mdir, wk,
                                                         device="cuda")
    argv = ["realtime", "--from-config", "tune_ECMWF_com", "--synthetic",
            "--out", unet_root]
    cpu_root = copy_winners(unet_root, os.path.join(tmp, "rt_cpu"))
    t0 = time.perf_counter()
    n, diffs = realtime_case(
        torch, conv, card, "(a) CLI realtime, U-Net", unet,
        lambda: realtime_cli(run, realtime, argv),
        lambda: realtime.run_realtime_eval(cfg, out_root=cpu_root,
                                           log=quiet, device="cpu")[0],
        land, wk)
    launches += n
    worst["(a)"] = diffs

    cnn_cfg = replace(cfg, architecture="cnn")
    cnn_dir = os.path.join(cnn_root, "models", cfg.out_dir, "ECMWF_IMD", wk)
    cnn, _ = realtime.load_winner_for_realtime(cnn_dir, wk, "cnn", "cuda")
    cnn_cpu = copy_winners(cnn_root, os.path.join(tmp, "rt_cnn_cpu"))
    n, worst["(b)"] = realtime_case(
        torch, conv, card, "(b) run_realtime_eval, cnn", cnn,
        lambda: realtime.run_realtime_eval(
            cnn_cfg, out_root=cnn_root, log=quiet, device="cuda"),
        lambda: realtime.run_realtime_eval(cnn_cfg, out_root=cnn_cpu,
                                           log=quiet, device="cpu")[0],
        land, wk)
    launches += n

    cache = os.path.join(tmp, "rt_cache")
    fake_operational_cache(cache, cfg, bundle.lats, bundle.lons)
    op_root = copy_winners(unet_root, os.path.join(tmp, "rt_op"))
    op_cpu = copy_winners(unet_root, os.path.join(tmp, "rt_op_cpu"))
    kw = dict(download=False, cache_dir=cache, hindcast_source="synthetic",
              log=quiet)
    n, worst["(c)"] = realtime_case(
        torch, conv, card, "(c) run_realtime_forecast of 2 init dates, "
        "fake cache, U-Net", unet,
        lambda: realtime.run_realtime_forecast(
            cfg, list(RT_DATES), out_root=op_root, device="cuda", **kw),
        lambda: realtime.run_realtime_forecast(
            cfg, list(RT_DATES), out_root=op_cpu, device="cpu", **kw)[0],
        land, wk, tag=f"{RT_DATES[0]}_{RT_DATES[1]}")
    launches += n
    wall = time.perf_counter() - t0

    # GradCAM alone, the 21 realtime rows in one chunk, after the counted
    # runs: wall per call and device time per call
    years = bundle.years
    x = torch.as_tensor(bundle.fillna(0.0).predictor_images("mean")[
        years == years.max()], device="cuda")
    check(x.shape[0] == RT_ROWS, f"realtime rows {x.shape[0]}, expected "
          f"{RT_ROWS}")
    secs = []
    for _ in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        attrib.gradcam(unet, unet_state, x)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    dev = bench.device_ms(torch, lambda: attrib.gradcam(unet, unet_state, x),
                          reps=10)
    print(f"  GradCAM of {x.shape[0]} rows (one chunk): wall "
          f"{np.median(secs[1:]) * 1e3:.3f} ms median of 5 (first "
          f"{secs[0] * 1e3:.3f} ms), device {dev:.4f} ms per call on {card}")
    print(f"  realtime phase: launches {launches}; wall of the three cases "
          f"with their repeats and CPU runs {wall:.2f} s; max cuda-vs-CPU "
          f"diffs " + "; ".join(
              f"{c} probs {float(d['probs']):.3e} attribution "
              f"{float(d['attribution']):.3e} rpss {float(d['rpss_map']):.3e}"
              for c, d in worst.items()))
    return launches


ACC_WEEKS = ("wk1", "wk2", "wk3", "wk4", "wk3-4")


def stdout_json(fn):
    """fn() with its standard output captured; returns (its return code,
    the JSON object it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    text = buf.getvalue()
    return rc, json.loads(text[text.index("{"):])


def np_bins(p, num_bins=10):
    """The reference's binning in float64: np.digitize(p, linspace(0, 1,
    n + 1), right=True) - 1, clipped (plots.py:36-39)."""
    import numpy as np
    edges = np.linspace(0, 1, num_bins + 1)
    return np.clip(np.digitize(p, edges, right=True) - 1, 0, num_bins - 1)


def np_scores(p, t):
    """REL, BSS and RES of plots.py:13-139 in float64 numpy over the
    entries where both p and t are finite: reliability on the raw
    probabilities, BSS against the base rate 1/3 and resolution against the
    observed mean on probabilities scaled by 0.9999999999999."""
    import numpy as np
    ok = np.isfinite(p) & np.isfinite(t)
    p, t = p[ok].astype(np.float64), t[ok].astype(np.float64)
    out = {}
    idx = np_bins(p)
    c = np.bincount(idx, minlength=10).astype(np.float64)
    sp = np.bincount(idx, weights=p, minlength=10) / np.maximum(c, 1)
    st = np.bincount(idx, weights=t, minlength=10) / np.maximum(c, 1)
    out["rel"] = float(((sp - st) ** 2 * c).sum() / c.sum())
    ps = p * 0.9999999999999
    out["bss"] = float(1 - np.mean((ps - t) ** 2) / np.mean((1 / 3 - t) ** 2))
    idx = np_bins(ps)
    c = np.bincount(idx, minlength=10).astype(np.float64)
    st = np.bincount(idx, weights=t, minlength=10) / np.maximum(c, 1)
    out["res"] = float((c * (st - t.mean()) ** 2).sum() / c.sum())
    return out


def np_corr(a, b):
    """Pearson correlation over axis 0 in float64, skipping samples where
    either is NaN; NaN with fewer than 2 samples or a zero variance."""
    import numpy as np
    a, b = a.astype(np.float64), b.astype(np.float64)
    ok = np.isfinite(a) & np.isfinite(b)
    n = ok.sum(0)
    ma = np.where(ok, a, 0).sum(0) / np.maximum(n, 1)
    mb = np.where(ok, b, 0).sum(0) / np.maximum(n, 1)
    da, db = np.where(ok, a - ma, 0), np.where(ok, b - mb, 0)
    var = np.sqrt((da * da).sum(0) * (db * db).sum(0))
    with np.errstate(all="ignore"):
        r = (da * db).sum(0) / np.where(var > 0, var, np.nan)
    return np.where(n > 1, r, np.nan)


def np_weekly(v, weeks):
    """(53, *S) per-ISO-week means in float64, NaN for empty weeks."""
    import numpy as np
    v = v.astype(np.float64)
    out = np.full((53,) + v.shape[1:], np.nan)
    for w in range(1, 54):
        sel = v[weeks == w]
        if len(sel):
            with np.errstate(all="ignore"):
                ok = np.isfinite(sel)
                n = ok.sum(0)
                out[w - 1] = np.where(n > 0, np.where(ok, sel, 0).sum(0)
                                      / np.maximum(n, 1), np.nan)
    return out


def accs_runs(torch, conv, card, work):
    """(a) of phase 9: the CLI's accs on cuda, a repeat, the same on the
    CPU."""
    import numpy as np
    from s2s_ismr_tpu_torch import run
    from s2s_ismr_tpu_torch.io import read_netcdf

    def accs(d, *extra):
        conv.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, paths = stdout_json(lambda: run.main(
            ["accs", "--synthetic", "--out", d, *extra]))
        torch.cuda.synchronize()
        check(rc == 0, f"accs {extra} returned {rc}")
        return paths, time.perf_counter() - t0, conv.LAUNCHES

    d = os.path.join(work, "accs")
    paths, seconds, launches = accs(d)
    check(launches == 0, f"accs launched the conv kernel {launches} times")
    check(sorted(paths) == ["ECMWF", "GEFS", "IITM"]
          and all(sorted(v) == sorted(ACC_WEEKS) for v in paths.values()),
          f"accs paths {paths}")
    want = sorted(os.path.join(d, "outputs", "ACC", f"{m}_IMD",
                               f"ccacc_{wk}.nc")
                  for m in paths for wk in ACC_WEEKS)
    found = sorted(os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs)
    check(found == want and sorted(p for v in paths.values()
                                   for p in v.values()) == want,
          f"accs files {found}")
    first = {}
    for p in want:
        f = read_netcdf(p)
        cc, acc, clim = f.values[0], f.values[1], f.values[2]
        land = np.isfinite(clim)
        check(f.dims == ("metric", "Y", "X") and f.values.shape[0] == 4
              and land.any(), f"{p}: dims {f.dims} shape {f.values.shape}")
        for name, m in (("CC", cc), ("ACC", acc)):
            check(np.isfinite(m[land]).all()
                  and np.abs(m[land]).max() <= 1 + 1e-6,
                  f"{p}: {name} not finite in [-1, 1] on land")
        first[p] = f.values
    ymx = f.values.shape[1:]
    print(f"  (a) accs: {len(want)} ccacc netcdfs of (4, {ymx[0]}, "
          f"{ymx[1]}), CC/ACC finite in [-1, 1] on land, conv launches 0; "
          f"wall {seconds:.2f} s on {card}")
    _, seconds2, _ = accs(d)
    for p in want:
        check(read_netcdf(p).values.tobytes() == first[p].tobytes(),
              f"the accs repeat's {p} differs")
    dc = os.path.join(work, "accs_cpu")
    cpu_paths, cpu_s, _ = accs(dc, "--cpu")
    worst = 0.0
    for p in want:
        a, b = first[p], read_netcdf(os.path.join(
            dc, os.path.relpath(p, d))).values
        check(np.array_equal(np.isnan(a), np.isnan(b)),
              f"{p}: NaN pattern differs between cuda and the CPU")
        worst = max(worst, float(np.nanmax(np.abs(a - b))))
    check(worst <= 1e-5, f"accs cuda vs CPU {worst:.3e} > 1e-5")
    print(f"  (a) repeat bit-equal file by file (wall {seconds2:.2f} s); "
          f"--cpu run {cpu_s:.2f} s, cuda vs CPU max abs diff {worst:.3e}")
    return launches


def metrics_vs_float64(torch, elr):
    """(b) of phase 9: the port's REL / BSS / RES and CC / ACC on cuda
    against float64 numpy versions of the reference's formulas, against
    the CPU, and repeated."""
    import numpy as np
    from s2s_ismr_tpu_torch.data import synthetic
    from s2s_ismr_tpu_torch.ops import metrics
    from s2s_ismr_tpu_torch.ops.terciles import one_hot_labels
    from s2s_ismr_tpu_torch.pipelines.notebooks import ACC_LEADS_ECMWF

    def same(a, b):
        return a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()

    worst_o, worst_c = 0.0, 0.0
    for name, res in elr.items():
        cfg_o, cfg_c = 0.0, 0.0
        probs = res.test_probs
        sel = torch.as_tensor(res.masks.test, device=probs.device)
        p = torch.cat([probs[f][sel[f]] for f in range(len(sel))])
        t = one_hot_labels(torch.as_tensor(np.concatenate(
            [res.labels[f][res.masks.test[f]] for f in range(len(sel))]),
            device=probs.device))
        line = []
        for k in range(3):
            pk, tk = p[..., k].contiguous(), t[..., k].contiguous()
            ok = torch.isfinite(pk) & torch.isfinite(tk)
            want = np_scores(pk.cpu().numpy().ravel(),
                             tk.cpu().numpy().ravel())
            for key, fn in (("rel", metrics.reliability_score),
                            ("bss", metrics.brier_skill_score),
                            ("res", metrics.resolution_score)):
                got = fn(pk, tk, ok)
                check(same(got, fn(pk, tk, ok)),
                      f"{name} {key}[{k}]: repeat differs")
                cpu = float(fn(pk.cpu(), tk.cpu(), ok.cpu()))
                d_o, d_c = abs(float(got) - want[key]), abs(float(got) - cpu)
                check(d_o <= 1e-5, f"{name} {key}[{k}]: {float(got)!r} vs "
                      f"float64 {want[key]!r}")
                check(d_c <= 1e-6, f"{name} {key}[{k}]: cuda {float(got)!r} "
                      f"vs CPU {cpu!r}")
                cfg_o, cfg_c = max(cfg_o, d_o), max(cfg_c, d_c)
                line.append(f"{key}{k} {float(got):.5f}")
        worst_o, worst_c = max(worst_o, cfg_o), max(worst_c, cfg_c)
        print(f"  (b) {name} ELR test probabilities, {p.shape[0]} rows of "
              f"{tuple(p.shape[1:3])}: " + " ".join(line)
              + f"; max abs diff vs float64 {cfg_o:.3e}, vs CPU {cfg_c:.3e}")
    lead = ACC_LEADS_ECMWF["wk3-4"]
    b = synthetic.synthetic_hindcast(model="ECMWF", step=2.0, lead=lead)
    b1 = synthetic.synthetic_hindcast(model="ECMWF", step=2.0,
                                      lead=ACC_LEADS_ECMWF["wk1"])
    xm, y, weeks = b.ensemble_mean(), b.y, b.weeks
    ext = np_weekly(b1.ensemble_mean(), b1.weeks).astype(np.float32)
    xd, yd = (torch.as_tensor(v, device="cuda") for v in (xm, y))
    cases = (
        ("CC", lambda dev: metrics.masked_corr(xd.to(dev), yd.to(dev)),
         np_corr(xm, y)),
        ("ACC sample clim", lambda dev: metrics.anomaly_cc(
            xd.to(dev), yd.to(dev), weeks),
         np_corr(xm - np_weekly(xm, weeks)[weeks - 1],
                 y - np_weekly(y, weeks)[weeks - 1])),
        ("ACC external (53, Y, X) clim", lambda dev: metrics.anomaly_cc(
            xd.to(dev), yd.to(dev), weeks, x_clim=ext),
         np_corr(xm - ext.astype(np.float64)[weeks - 1],
                 y - np_weekly(y, weeks)[weeks - 1])))
    for label, fn, want in cases:
        got = fn("cuda")
        check(same(got, fn("cuda")), f"{label}: repeat differs")
        g, c = got.cpu().numpy(), fn("cpu").numpy()
        check(np.array_equal(np.isnan(g), np.isnan(want))
              and np.array_equal(np.isnan(g), np.isnan(c)),
              f"{label}: NaN pattern differs from float64 or the CPU")
        d_o = float(np.nanmax(np.abs(g - want)))
        d_c = float(np.nanmax(np.abs(g - c)))
        check(d_o <= 1e-5, f"{label}: {d_o:.3e} off float64")
        check(d_c <= 1e-6, f"{label}: cuda vs CPU {d_c:.3e}")
        worst_o, worst_c = max(worst_o, d_o), max(worst_c, d_c)
        print(f"  (b) {label} of the accs ECMWF wk3-4 bundle "
              f"{tuple(y.shape)}: max abs diff vs float64 {d_o:.3e}, vs "
              f"CPU {d_c:.3e}, land mean {np.nanmean(g):.4f}")
    print(f"  (b) repeats bit-equal; max abs diff vs float64 {worst_o:.3e} "
          f"(<= 1e-5), cuda vs CPU {worst_c:.3e} (<= 1e-6)")


def rpss_rows(unet_root):
    """(c) of phase 9: analysis.rpss_records over phase 5's outputs tree,
    each run's rows against its finite pixels after the ELR mask."""
    import warnings

    import numpy as np
    from s2s_ismr_tpu_torch import analysis
    from s2s_ismr_tpu_torch.io import read_netcdf
    runs = [{"period_dir": "Common Period/", "model": "ECMWF", "obs": "IMD",
             "arch": a, "week": "wk3-4", "label": "week 3-4"}
            for a in ("ELR", "unet")]
    table = analysis.rpss_records(runs, unet_root)
    odir = os.path.join(unet_root, "outputs", "Common Period", "ECMWF_IMD")

    def bmean(arch):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return np.nanmean(read_netcdf(os.path.join(
                odir, f"{arch}_rpss_test_wk3-4.nc")).values, axis=0)
    mask = np.isnan(bmean("ELR"))
    counts = {}
    for run in runs:
        v = np.where(mask, np.nan, bmean(run["arch"]))
        want = int(np.isfinite(v).sum())
        got = table.subset(arch=run["arch"])
        counts[run["arch"]] = got.values.size
        check(got.values.size == want and np.isfinite(got.values).all()
              and set(got.lead) == {"week 3-4"},
              f"rpss_records {run['arch']}: {got.values.size} rows, "
              f"{want} finite pixels after the ELR mask")
    print(f"  (c) rpss_records over phase 5's outputs: rows {counts}, each "
          f"equal to its finite pixels after the ELR mask")


def traced_run(torch, conv, card, work):
    """(d) of phase 9: the CLI's fast tune run with --epochs 1, first
    without, then with --profile; returns the conv launches of both."""
    import contextlib
    from s2s_ismr_tpu_torch.pipelines import tune

    argv = ["tune_ECMWF_com", "--synthetic", "--fast", "--epochs", "1"]
    plain, plain_s, plain_n = cli_run(
        torch, conv, argv + ["--out", os.path.join(work, "untraced")])
    check(plain_n == expected_launches(torch, plain)[0],
          f"untraced run: launches {plain_n}")
    p, o = os.path.join(work, "trace"), os.path.join(work, "traced")
    records, real = [], tune.trace

    @contextlib.contextmanager
    def recording(*args, **kw):
        with real(*args, **kw) as rec:
            yield rec
        if rec is not None:
            records.append(rec)

    tune.trace = recording
    try:
        out, seconds, launches = cli_run(torch, conv, argv + [
            "--profile", p, "--out", o])
    finally:
        tune.trace = real
    check([r.path for r in records] == [os.path.join(p, "trace.json"),
                                        os.path.join(p, "nn", "trace.json")],
          f"traces written: {[r.path for r in records]}")
    expected, terms = expected_launches(torch, out)
    check(launches == expected, f"traced run: launches {launches}, "
          f"expected {expected}")
    for rec, stage in zip(records, ("ELR", "NN")):
        t0 = time.perf_counter()
        with open(rec.path) as fh:
            events = json.load(fh)["traceEvents"]
        parse_s = time.perf_counter() - t0
        kernels = [e for e in events
                   if str(e.get("cat", "")).lower() == "kernel"]
        n_conv = sum("conv3x3_mma_kernel" in e.get("name", "")
                     for e in kernels)
        print(f"  (d) {stage} trace {os.path.relpath(rec.path, work)}: "
              f"{rec.bytes} bytes, written in {rec.write_s:.3f} s, parsed "
              f"in {parse_s:.3f} s; {len(events)} events, {len(kernels)} "
              f"CUDA kernel events, {n_conv} of the conv kernel")
        check(kernels, f"the {stage} trace holds no CUDA kernel event")
        want = expected if stage == "NN" else 0
        check(n_conv == want, f"{stage} trace: {n_conv} conv kernel "
              f"events, expected {want} ({terms})")
    stages = {}
    for name, run_out in (("untraced", plain), ("traced", out)):
        with open(run_out.paths["profile"]) as fh:
            stages[name] = json.load(fh)["stages_s"]
    print(f"  (d) traced run: wall {seconds:.2f} s (untraced {plain_s:.2f} "
          f"s), stages {stages['traced']} (untraced {stages['untraced']}; "
          f"trace writing excluded) on {card}; conv launches {launches} = "
          f"counted in the NN trace = expected ({terms})")
    return launches + plain_n


def reporting_path(torch, conv, card, unet_root, elr, work):
    """Phase 9; returns the conv launches of its runs."""
    t0 = time.perf_counter()
    launches = accs_runs(torch, conv, card, work)
    metrics_vs_float64(torch, elr)
    rpss_rows(unet_root)
    launches += traced_run(torch, conv, card, work)
    print(f"  reporting phase: wall {time.perf_counter() - t0:.2f} s")
    return launches


def elr_cuda_vs_cpu(torch):
    """The ELR branch of the full tune_ECMWF_com and tune_2MME configs
    (10 folds) on cuda and on the CPU in this process; returns the cuda
    results by config name."""
    import numpy as np
    from s2s_ismr_tpu_torch.pipelines import get_config
    from s2s_ismr_tpu_torch.pipelines.tune import load_bundles, run_elr_branch
    v5e = {}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "expected", "suite_rpss_v5e.json")
    if os.path.exists(path):
        with open(path) as fh:
            v5e = json.load(fh)["configs"]
    out = {}
    for name in ("tune_ECMWF_com", "tune_2MME"):
        cfg = get_config(name)
        bundles = load_bundles(cfg)
        res, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res[dev] = run_elr_branch(cfg, bundles, log=lambda s: None,
                                      device=dev)
            secs[dev] = time.perf_counter() - t0
        g, c = res["cuda"], res["cpu"]
        pg, pc = g.test_probs.cpu().numpy(), c.test_probs.numpy()
        nan_g, nan_c = np.isnan(pg).any(-1), np.isnan(pc).any(-1)
        flipped = np.argwhere((nan_g != nan_c).any(1))     # (fold, y, x)
        check(len(flipped) == 0, f"{name}: NaN pattern differs at (fold, y, "
              f"x) {flipped[:20].tolist()}")
        dp = float(np.nanmax(np.abs(pg - pc)))
        n_lab = int((~((g.labels == c.labels)
                       | (np.isnan(g.labels) & np.isnan(c.labels)))).sum())
        means = {d: float(np.nanmean(r.rpss_test.values))
                 for d, r in res.items()}
        dm = abs(means["cuda"] - means["cpu"])
        print(f"  {name} ({pg.shape[0]} folds, {pg.shape[2]}x{pg.shape[3]}):"
              f" cuda {secs['cuda']:.2f} s, cpu {secs['cpu']:.2f} s; labels "
              f"differing {n_lab}; max prob diff {dp:.3e}; test RPSS mean "
              f"cuda {means['cuda']!r} cpu {means['cpu']!r} (diff {dm:.3e}); "
              f"TPU v5e value, for information: "
              f"{v5e.get(name, {}).get('elr_rpss_test_mean')}")
        check(dp <= 1e-4, f"{name}: probabilities differ by {dp:.3e} > 1e-4")
        check(dm <= 1e-5, f"{name}: test RPSS means differ by {dm:.3e}")
        out[name] = g
    return out


def main():
    global bench
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from s2s_ismr_tpu_torch.kernels import _build, conv
    from s2s_ismr_tpu_torch.kernels import conv_bench as bench

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        print("[1/9] device")
        card = card_line()
        print(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
              f"torch {torch.__version__} cuda {torch.version.cuda}")

        print("[2/9] build")
        info = _build.build()
        _build.library()
        print(f"  built {os.path.relpath(info['path'])} in "
              f"{info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
        check(conv.kernel_tiles() == conv.TILES
              and conv.kernel_chunk() == conv._BK,
              f"tile table / K chunk of the library {conv.kernel_tiles()} / "
              f"{conv.kernel_chunk()} differ from the wrapper's "
              f"{conv.TILES} / {conv._BK}")

        print("[3/9] kernel vs plain (TF32 off), batch 16")
        shapes = bench.slice_shapes(torch, (2, 3), BATCH)
        max_abs = kernel_vs_plain(torch, conv, shapes)
        print("  the cnn's shapes (act none) and the multi_predictor first "
              "convs")
        max_abs = max(max_abs, kernel_vs_plain(torch, conv, CNN_SHAPES,
                                               acts=("none",)))
        max_abs = max(max_abs, kernel_vs_plain(torch, conv, MULTI_SHAPES))
        print("  edge shapes")
        max_abs = max(max_abs, kernel_vs_plain(torch, conv,
                                               bench.EDGE_SHAPES))
        rt_shapes = bench.slice_shapes(torch, (2,), RT_ROWS)
        rt_cnn = [(RT_ROWS,) + s[1:] for s in CNN_SHAPES]
        print(f"  the realtime path's shapes at N = {RT_ROWS} (the final "
              f"year's rows): the U-Net winner's convs (filters 2; GradCAM "
              f"runs the decoder's in dx mode) and the cnn's (saliency runs "
              f"every dx, the first at C = 1)")
        max_abs = max(max_abs, kernel_vs_plain(torch, conv, rt_shapes))
        max_abs = max(max_abs, kernel_vs_plain(torch, conv, rt_cnn,
                                               acts=("none",)))
        groups = (("U-Net slice", shapes, "elu"), ("cnn", CNN_SHAPES, "none"),
                  ("multi_predictor", MULTI_SHAPES, "elu"),
                  (f"realtime U-Net N={RT_ROWS}", rt_shapes, "elu"),
                  (f"realtime cnn N={RT_ROWS}", rt_cnn, "none"))
        times = {m: {} for m in ("fwd", "dx")}
        for name, group, act in groups:
            print(f"  device time per launch at the {len(group)} {name} "
                  f"shapes (kernel and cuDNN in turns; on {card})")
            for mode, s in kernel_times(torch, conv, group, act).items():
                print(f"  {name} {mode} summed over {len(group)} shapes: "
                      f"kernel {s['ms']:.4f} ms, cuDNN "
                      f"{s['library_ms']:.4f} ms, plain "
                      f"{s['plain_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
                      f"({s['bound_ms'] / s['ms']:.1%} of it; FLOP "
                      f"{s['ops_ms']:.4f} ms, bytes {s['bytes_ms']:.4f} ms); "
                      f"bound at 3xTF32 {s['bound_3xtf32_ms']:.4f} ms "
                      f"({s['bound_3xtf32_ms'] / s['ms']:.1%} of it)")
                for key, v in s.items():
                    times[mode][key] = times[mode].get(key, 0.0) + v
        print(f"  max abs err {max_abs:.3e}")

        print("[4/9] main path: tune_ECMWF_com NN branch, fast variant")
        launches, main_abs = main_path(torch, conv, card)
        max_abs = max(max_abs, main_abs)

        with tempfile.TemporaryDirectory() as work:
            unet_root = os.path.join(work, "tune")
            print("[5/9] main path: `python -m s2s_ismr_tpu_torch.run "
                  "tune_ECMWF_com --synthetic --fast` in-process on cuda")
            launches += pipeline_path(torch, conv, card, unet_root)

            print("[6/9] the other run modes of tune_ECMWF_com (fast "
                  "variant) in-process on cuda")
            modes_launches, modes_abs = modes_path(torch, conv, card,
                                                   os.path.join(work, "modes"))
            launches += modes_launches
            max_abs = max(max_abs, modes_abs)

            print("[7/9] ELR branch of the full tune_ECMWF_com and tune_2MME "
                  "(10 folds), cuda vs CPU")
            elr = elr_cuda_vs_cpu(torch)

            print("[8/9] realtime path on cuda: the CLI's `realtime` on "
                  "phase 5's winners, the cnn's of phase 6, and the "
                  "operational forecast on a fake cache")
            launches += realtime_path(
                torch, conv, card, unet_root,
                os.path.join(work, "modes", "cnn"), work)

            print("[9/9] reporting and profiler traces on cuda: the CLI's "
                  "`accs`, REL/BSS/RES and CC/ACC against float64, RPSS "
                  "records, and a traced fast tune run")
            launches += reporting_path(torch, conv, card, unet_root, elr,
                                       work)
        check("jax" not in sys.modules, "jax was imported")
        jax_pkg = [m for m in sys.modules
                   if m == "s2s_ismr_tpu" or m.startswith("s2s_ismr_tpu.")]
        check(not jax_pkg, f"modules of the JAX package were loaded: "
              f"{jax_pkg}")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    fwd, dx = times["fwd"], times["dx"]
    print(json.dumps({"kernels": [{
        "name": "conv3x3_bias_act", "route": "cuda",
        "source": "s2s_ismr_tpu_torch/csrc/conv3x3.cu",
        "replaces": "s2s_ismr_tpu/kernels/conv.py:78",
        "launches": launches, "max_abs_err": max_abs,
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": ("operations" if fwd["ops_ms"] >= fwd["bytes_ms"]
                     else "bytes"),
        "library_ms": fwd["library_ms"],
        "dx_ms": dx["ms"], "dx_plain_ms": dx["plain_ms"],
        "dx_bound_ms": dx["bound_ms"], "dx_library_ms": dx["library_ms"],
        "bound_3xtf32_ms": fwd["bound_3xtf32_ms"],
        "dx_bound_3xtf32_ms": dx["bound_3xtf32_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

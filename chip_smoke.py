#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (s2s_ismr_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each on its own lines; any failure exits non-zero before the last
line is printed:
  1. device: needs CUDA; prints the card's name and power limit;
  2. build: compiles the package's CUDA kernels from csrc/ (the wrapper's
     tile table and K chunk must equal the library's); the library's SASS
     (`cuobjdump -sass`) must hold the halo tiles' wgmma (HGMMA) and TMA
     loads (UTMALDG);
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
     the 3xTF32 rate), each shape's tile and family, the family counts
     and every case where cuDNN is faster, with its ratio;
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
  10. batched lanes, the mesh and bf16 on cuda, TF32 off: (a) the conv
     kernel's lane mode (one launch for L lanes, each with its own
     weights) at the fast sweep's 11 filters-2 shapes for L = 4 and 20,
     forward and dx mode, both acts, against the float64 plain lane
     version (rtol 1e-4 / atol 1e-5), one case with x shared by the lanes,
     and every lane bit-equal to a one-lane launch of it with the same
     tile; (b) the device time of the lane mode, of L one-lane launches
     and of cuDNN's grouped conv (groups = L) in turns, beside L times
     the one-lane bound, the family counts and every case where cuDNN's
     grouped conv is faster; (c) run_unet_sweep of the fast tune_ECMWF_com
     with learning rates (1e-3, 1e-4) (4 lanes per bucket), 3 epochs,
     lane_dispatch 'vmap' then 'serial': launches exact (27 lane-mode
     launches per batched step, 14 per batched val epoch, 14 one-lane per
     winner), val tables within 2e-4 and the same winners, steps/s of
     each, and each mode's device idle share over one profiled epoch; (d) run_pipeline(use_mesh=True) on a
     one-card mesh bit-equal to use_mesh=False (RPSS netcdfs, winner
     states; --epochs 2, cuDNN deterministic in both); (e) one-epoch sweeps with
     compute_dtype 'bfloat16' under the kernel and torch backends: finite
     val losses within 2e-2 of float32;
  11. the eight configs' tuning grids at full width on cuda, TF32 off:
     (a) the conv kernel at every kernel-conv shape of every trial of the
     eight configs at its batch size on the config's grid (n_blocks 3-5,
     filters 2-3, 24/32/64 grids, batch 16 and 32: 134 shapes, C and O up
     to 384, maps down to 1x1 and the 24x24 grid's 3x3) as phase 3 checks
     its shapes, every launch twice and bit-equal, the C = O = 384 and 3x3
     shapes named; the eval shapes (val rows and T in row chunks) forward
     only; the device times of the 134 shapes in turns with cuDNN, summed
     per grid family, the family counts and every case where cuDNN
     wins, with its ratio; (b) `run.main(
     ["suite", "--synthetic", "--folds", "1", "--epochs", "1", "--out",
     <dir>, "--check", <s2s_ismr_tpu_torch/expected/
     suite_rpss_h100_cut.json>])` in-process with cuDNN deterministic: all
     eight configs with every trial of their grids; exit code 0, every
     config ok and `[check] ok`, the outputs tree file by file, ELR and
     U-Net test RPSS finite on land in every fold, each config's launches
     equal to the per-trial count, its wall, NN lane steps/s and peak
     device memory;
  12. (run between phase 11's (a) and (b): after the suite's millions of
     launches torch.profiler loses device events) IITM's 24 members at
     64x64 and the weeks on cuda, TF32 off, cuDNN deterministic: (a) the
     conv kernel at the multi_predictor first conv of every tune_IITM_full
     trial (C = 24: (16, 64, 64, 24, 8) and (16, 64, 64, 24, 12)) as
     phase 3 checks its shapes, and forward only at its val-row and T eval
     shapes and at the stacked predictor's eval chunks (488 rows, and the
     val rows' and T rows' last chunks of 160 and 240) of every conv of
     n_blocks 3 / filters 2 and n_blocks 5 / filters 3; their device
     times in turns with cuDNN, each shape's kernel / cuDNN ratio, the
     family counts and every case where cuDNN wins; (b) `run.main(["tune_IITM_full", "--synthetic",
     "--predictor", "multi_predictor", "--folds", "2", "--epochs", "1",
     ...])`: all 18 trials, the manifest's input shape (1, 64, 64, 24),
     launches exact, RPSS finite on land, the winners reloaded bit-equal,
     a CPU forward of the first 64 rows within 1e-5; (c) the same config
     with `--predictor stacked --training-type train`, then `load` on its
     --out: predictions (2, 10488, 64, 64, 3), 22 row chunks per winner
     forward, launches exact, the load bit-equal, a CPU forward of the
     last 64 rows within 1e-5; (d) the peak device memory of (b) and (c)
     by stage (data, labels, ELR, NN training, winner eval, scores); (e)
     `run.main(["suite", "--configs", "tune_ECMWF_com,tune_2MME",
     "--week", "wk1,wk2", "--fast", "--folds", "2", "--epochs", "1",
     ...])`: every (config, week)'s tree file by file, the week's leads,
     launches exact; the same with --resume runs nothing; a wk1 `load`
     bit-equal to the suite's wk1 run; wk1 winners copied under wk2
     refused with a ValueError naming the week; rpss_records rows for
     both weeks;
  13. (last: nothing is timed by torch.profiler after its millions of
     launches; its rates are host-clock numbers) the sweep at the
     reference's depth on cuda, TF32 off, cuDNN deterministic: (a)
     run_pipeline of tune_ECMWF_com (synthetic 32x32, T = 349) on its fast
     grid's 2 trials but at 10 folds, 100 epochs and the published
     patience 15 (20 lanes, each stopping on patience): every lane's
     epochs (at least one stopped before 100) and their histogram, launches
     exact per lane's depth, RPSS finite on land, a `load` replay of the
     written winners bit-equal, the shortest lane retrained on the CPU to
     the same stop epoch with its best val loss within 1e-4 relative, the
     winners, stop epochs and per-fold RPSS against s2s_ismr_tpu_torch/
     expected/depth_rpss_h100.json, wall, lane steps/s and peak device
     memory by stage; (b) the first 4 folds' sweep with
     lane_dispatch='vmap': stop epochs equal to (a)'s lane by lane, val
     losses within 1e-4 relative, the same winners, each bucket run to
     its last lane's stop (batched epochs and steps printed), launches
     exact;
  14. (run between phase 12 and phase 11's suite, which it must precede
     for torch.profiler) the engine's programs, each lane's epoch and each
     eval forward a memoized CUDA graph, against the uncaptured seam: (a)
     bit for bit; (b) one profiled replayed epoch: the conv kernel's
     device events equal to the launch counter's delta, and the kernel's
     share of the epoch's device time; (c) graph and seam in turns, lane
     steps/s, idle share and device ops per lane step;
  15. (last) the port's measurement programs, each a subprocess with a
     fresh CUDA context that loads the kernel library itself: (a) `python
     -m s2s_ismr_tpu_torch.bench` at full size (the JAX bench's workload:
     20 lanes x 10 epochs on 32x32; sequential, serial-async and vmapped,
     the kernel and cuDNN backends, in turns): its last line has the JAX
     bench's four keys, the sequential lanes equal the serial-async ones
     bit for bit, every round of the kernel backend repeats, vmapped
     within 1e-5 of serial-async; (b) `python -m
     s2s_ismr_tpu_torch.probes.roofline`: the conv census per lane step
     equals step_launches(3) (14 forward, 13 dx), the profiled replay's
     conv events equal the launches its program captured; per-op latencies
     and the ceiling printed; (c) `python -m
     s2s_ismr_tpu_torch.probes.lane_regime --turns 1`: serial against
     vmapped lanes at L = 2-20 (32x32) and 2-10 (64x64, n_blocks 4), the
     stop epochs equal and the best val losses within 1e-4 at the full
     lane counts; (d) the flag-matrix legs `tune_GEFS_com --standardize`
     and `tune_IITM_com --batch-size full` at `--folds 1 --epochs 1`
     in-process: test RPSS finite on land, launches exact; then the kernel
     against float64 at the full-batch training shapes (N = T), each
     within the wrapper's N*H*W limit;
  16. (run after phase 3) the train-mode BatchNorm kernels
     (kernels/batchnorm.py, csrc/batchnorm.cu): (a) at every BatchNorm
     shape of tune_ECMWF_com's (n_blocks 3, filters 2, 32x32) and
     tune_IITM_full's (n_blocks 5, filters 3, 64x64) U-Nets at batch 16,
     of every U-Net the eight configs' grids train (n_blocks 3-5, filters
     2 and 3, batch 16 and 32, on 24x24, 32x32 and 64x64) and at the
     MLP's (16, 2048) and (16, 512), weights with three padded rows and
     all zero: y, the running statistics, dx, dscale and dbias of the
     kernel path against the float64 plain version, each at most twice
     the float32 plain version's error, a repeat bit-equal; (b) at the
     benchmark's U-Nets' and the MLP's shapes, us per call in a CUDA-graph
     chain of the kernel and the plain version, forward and backward,
     beside the bound (x read and y written, or g and x read and dx
     written, at 3.35 TB/s) and the launch floor (a one-element add in the
     same chain), and the sums per model (each BatchNorm of a step once);
and in every run of phases 4-6, 8-13 and 15 (d) (each CLI run, each
suite config, each sweep, the realtime forwards) the BatchNorm kernels'
launches equal a forward and a backward per train-mode BatchNorm of
every one-lane training step (none for batched lanes, loads and eval
forwards), and in phase 9's traced run the NN trace's BatchNorm kernel
events equal those plus the warm-ups of the programs built in its window;
then checks that neither jax nor any module of the JAX package
(s2s_ismr_tpu) was loaded; prints the kernels JSON line (launches summed
over phases 4, 5, 6, 8, 9, 10, 11, 12, 13 and 15; times and bounds summed
over the shapes of phase 3, the forward under ms / plain_ms / library_ms /
bound_ms / bound_3xtf32_ms, the dx mode under dx_*; phase 10's lane mode
at L = 4 under lanes_* (lanes_serial_ms: L one-lane launches,
lanes_library_ms: cuDNN grouped), at L = 20 under lanes20_*,
lanes_launches: the lane-mode launches of (c)'s vmap sweep, and
both modes' idle shares; phase 11's sums over its training shapes under
grids_*, its shape counts and suite_launches; phase 12's forward sums over
its eval shapes under iitm_*, over the first convs under iitm_first_* and
iitm_first_dx_*, its shape count and launches; phase 13's launches
under depth_launches; phase 14's numbers under programs_*, with
programs_kernel_share the conv kernel's share of a replayed epoch's
device time; phase 15's launches per program under bench_launches,
roofline_launches, lane_regime_launches and flags_launches, the bench's
value, vs_baseline and each mode's steps/s under bench_*, the roofline's
per-op latencies under roofline_*; the tile family counts per phase and
mode under families; and a second entry, batchnorm_train, with the
BatchNorm kernels' launches summed over the runs checked, their number,
the programs' warm-up launches, phase 16's sums per model under
<model>_{kernel,plain,bound}[_bwd]_us and the launch floor),
the card line, then the result line {"ok": true, ...}.

    python3 chip_smoke.py --batchnorm

runs phases 1-2 and phase 16 alone.

    python3 chip_smoke.py --epoch-chunks

runs phases 1-2 and phase 17 alone (it is not part of the full run,
which it would take past its time limit): the stacked predictor's 64x64
epoch (24 members x 437 dates as rows, n_blocks 5, filters 3, batch 16)
in the engine's chunk graphs: (a) at 458 batches under each chunk of
CHUNK_SIZES, the capture seconds, each segment graph's launch (host ms
on an idle device) and device ms, the launches queued behind a chunk
graph and the launches an epoch takes; (b) the whole epoch
against itself with cuDNN free, printed, and with cuDNN deterministic
the committed chunk (engine.EPOCH_CHUNK) against the whole-epoch capture
at 458 and 461 batches, bit for bit; (c) in every run, the conv and
BatchNorm kernel launches against the shapes' count; (d) a 32x32 lane
with dropout in chunks of 5 against the uncaptured seam, bit for bit.
It prints the card line and {"epoch_chunks": ...} last.

    python3 chip_smoke.py --shapes-json PATH

runs phases 1-2 and writes the shapes phases 3, 10, 11 and 12 time,
with their act and modes, to PATH (for `python -m
s2s_ismr_tpu_torch.kernels.conv_bench tiles --shapes PATH`, whose sweep
`conv_bench fit` fits the wrapper's tile cost model to).

    python3 chip_smoke.py --write-expected PATH

runs phases 1-2, then phase 11's suite twice (without --check), and
writes the port's expectations file to PATH: the first run's means, the
tolerance the larger of 1e-5 and ten times the two runs' largest drift.

    python3 chip_smoke.py --write-depth PATH

runs phases 1-2, then phase 13's (a) twice, and writes its expectations
file to PATH: the first run's winners, stop epochs and per-fold RPSS
(the two runs must agree on the first two), the tolerance the larger of
1e-5 and ten times the two runs' largest RPSS drift.
"""

from __future__ import annotations

import contextlib
import json
import math
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
# shapes timed in one profiler window by kernel_times
WINDOW_SHAPES = 8


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    from s2s_ismr_tpu_torch.device import card_line as line
    try:
        return line()
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from None


def errors(got, want):
    """Max abs / rel error of `got` against `want`, and how far the worst
    element lies past atol + rtol * |want| (<= 0 passes)."""
    diff = (got.double() - want).abs()
    excess = float((diff - (bench.ATOL + bench.RTOL * want.abs())).max())
    return (float(diff.max()),
            float((diff / want.abs().clamp_min(1e-30)).max()), excess)


# tiles taken per phase, mode and family at the shapes each phase times
# (printed with the phase, and in the kernels line)
FAMILY_COUNTS = {}


def count_families(conv, phase, shapes, act="elu", modes=("fwd", "dx"),
                   lanes=1):
    """The wrapper's tile family at each shape and mode, tallied under
    FAMILY_COUNTS[phase] and printed."""
    tally = FAMILY_COUNTS.setdefault(phase, {})
    for shape in shapes:
        for mode in modes:
            t = conv.launch_tile(shape, mode == "dx", act == "elu", lanes)
            fam = conv.FAMILIES[conv.TILES[t][0]]
            tally.setdefault(mode, {})
            tally[mode][fam] = tally[mode].get(fam, 0) + 1
    print(f"  tile families (phase {phase} so far): "
          + "; ".join(f"{m} {dict(sorted(f.items()))}"
                      for m, f in tally.items()))


def print_wins(per_shape, n_cases=None):
    """Every (shape, mode) of kernel_times' per-shape numbers where cuDNN
    is faster than the kernel, with the kernel / cuDNN ratio."""
    wins = [(t, m, r["ms"] / r["library_ms"])
            for t, modes in per_shape.items() for m, r in modes.items()
            if r["library_ms"] < r["ms"]]
    n = n_cases or sum(len(m) for m in per_shape.values())
    print(f"  cuDNN faster at {len(wins)} of {n} (shape, mode) cases"
          + (": " + "; ".join(f"{t} {m} {f:.2f}x" for t, m, f in wins)
             if wins else ""))
    return wins


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
    db) against the plain version at each shape, and a repeat of every
    launch bit-equal to the first; with `backward`, also the dx mode itself
    (dx and g'). Returns the largest abs error.

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
                    check(torch.equal(runs[1][0],
                                      conv.conv3x3_bias_act(x, k, b, act)),
                          f"{shape} {act}: a repeat of the forward differs")
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


def kernel_times(torch, conv, shapes, act="elu", modes=("fwd", "dx"),
                 phase=None):
    """Device time per launch at each shape, by torch.profiler, of the
    kernel and of cuDNN's F.conv2d (the library yardstick, TF32 off), in
    turns (kernel, cuDNN, kernel, cuDNN), and of the plain version once:
    the forward (bias + act) and the dx mode (for ELU: dx and g'), or the
    `modes` of these that the path runs at these shapes. cuDNN's
    dx is one F.conv2d of g with the adjoint taps made beforehand, so for
    ELU it does less than the kernel (no ELU', no g'). The timings of
    WINDOW_SHAPES shapes at a time come from one profiler window
    (bench.device_ms_many, each call's events up to its marker; at phase
    3's 22 U-Net shapes one window per shape gave sums within 5% of one
    window per timing, PERF.md §6, and a window's fixed cost is paid once
    per group). Returns the sums
    over the shapes, in ms, with the bound summed the same way, and the
    same numbers per shape: {shape: {mode: {key: ms}}}. Each shape's line
    names the tile and family the wrapper took; with `phase`, the family
    counts are tallied under it and printed, and every case where cuDNN
    is faster."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(1)
    keys = ("ms", "library_ms", "plain_ms", "bound_ms", "ops_ms",
            "bytes_ms", "bound_3xtf32_ms")
    tf32x3 = bench.PEAK_TF32_FLOPS / 3
    sums = {m: dict.fromkeys(keys, 0.0) for m in modes}
    per_shape = {}
    elu = act == "elu"

    @torch.no_grad()
    def shape_calls(shape):
        x, k, b, g = bench.inputs(torch, shape, gen)
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
        return {m: calls[m] for m in modes}

    for i in range(0, len(shapes), WINDOW_SHAPES):
        group = shapes[i:i + WINDOW_SHAPES]
        calls = [shape_calls(shape) for shape in group]
        order = [f for c in calls for kern, lib, plain in c.values()
                 for f in (kern, lib, kern, lib, plain)]
        with torch.no_grad():
            ts = bench.device_ms_many(torch, order)
        check(ts is not None, f"{group}: the profiler saw no device time")
        for j, shape in enumerate(group):
            parts = []
            for m, mode in enumerate(modes):
                t = ts[5 * (j * len(modes) + m):][:5]
                ms, lib_ms = (t[0] + t[2]) / 2, (t[1] + t[3]) / 2
                t_ops, t_bytes = bench.bound_parts(shape, mode == "dx", elu)
                bnd, by = bench.bound(shape, mode == "dx", elu)
                bnd3, by3 = bench.bound(shape, mode == "dx", elu,
                                        flops=tf32x3)
                row = dict(zip(keys, (ms, lib_ms, t[4], bnd, t_ops, t_bytes,
                                      bnd3)))
                per_shape.setdefault(shape, {})[mode] = row
                for key, v in row.items():
                    sums[mode][key] += v
                tile = conv.launch_tile(shape, mode == "dx", elu)
                parts.append(
                    f"{mode} (tile {tile} "
                    f"{conv.FAMILIES[conv.TILES[tile][0]]}): "
                    f"kernel {t[0] * 1e3:.2f}/{t[2] * 1e3:.2f} us, "
                    f"cuDNN {t[1] * 1e3:.2f}/{t[3] * 1e3:.2f} us, plain "
                    f"{t[4] * 1e3:.2f} us, bound {bnd * 1e3:.3f} us "
                    f"({by}), {bnd / ms:.1%} of bound; at 3xTF32 "
                    f"{bnd3 * 1e3:.3f} us ({by3}), {bnd3 / ms:.1%}")
            print(f"  {str(shape):<22} {act:<4} " + "   ".join(parts))
    if phase is not None:
        count_families(conv, phase, shapes, act, modes)
        print_wins(per_shape)
    return sums, per_shape


def print_sums(name, n, sums):
    """One line per mode of kernel_times' sums over n shapes."""
    for mode, s in sums.items():
        print(f"  {name} {mode} summed over {n} shapes: "
              f"kernel {s['ms']:.4f} ms, cuDNN "
              f"{s['library_ms']:.4f} ms, plain "
              f"{s['plain_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
              f"({s['bound_ms'] / s['ms']:.1%} of it; FLOP "
              f"{s['ops_ms']:.4f} ms, bytes {s['bytes_ms']:.4f} ms); "
              f"bound at 3xTF32 {s['bound_3xtf32_ms']:.4f} ms "
              f"({s['bound_3xtf32_ms'] / s['ms']:.1%} of it)")


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

    reset_launches(conv)
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
    per_step = bn_step_launches("unet", max(cfg.tuning.n_blocks))
    n_bn = check_bn_launches("main path", sw.train_steps * per_step)
    print(f"  BatchNorm kernel launches {n_bn} = {sw.train_steps} steps x "
          f"{per_step}")
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


CLI_PROGRAMS = {}        # programs.STATS just before the last cli_run


def cli_run(torch, conv, argv):
    """run.main(argv) in-process with the kernels' launch counts set to 0
    (and the programs' counts noted in CLI_PROGRAMS) just before; checks
    the BatchNorm kernel's launches against the run's steps; returns (the
    run's TuneOutputs, wall s, conv launches)."""
    from s2s_ismr_tpu_torch import programs, run
    from s2s_ismr_tpu_torch.pipelines import tune
    outs = []
    real = tune.run_pipeline

    def recording(*args, **kw):         # keeps the run's in-memory result
        outs.append(real(*args, **kw))
        return outs[-1]

    tune.run_pipeline = recording
    global CLI_PROGRAMS
    CLI_PROGRAMS = dict(programs.STATS)
    try:
        reset_launches(conv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = run.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = conv.LAUNCHES
    finally:
        tune.run_pipeline = real
    check(rc == 0 and len(outs) == 1, f"run.main({argv}) returned {rc}")
    check_bn_launches(" ".join(argv), expected_bn_launches(torch, outs[0]))
    return outs[0], seconds, launches


def out_dirs(root, cfg):
    """(outputs dir, [models dir of each member]) of a run under root."""
    return (os.path.join(root, "outputs", cfg.out_dir,
                         f"{cfg.result_name}_{cfg.obs}"),
            [os.path.join(root, "models", cfg.out_dir, f"{m}_{cfg.obs}",
                          cfg.week) for m in cfg.models])


def tree_files(root, out, suffix):
    """The files of the JAX CLI's tree that a run writes under root: the
    RPSS netcdfs, best_hparams and profile, and per member the winners
    manifest with best_model_{arch}_{fold}_{suffix}.pt."""
    cfg, wk, arch = out.config, out.config.week, out.config.architecture
    odir, mdirs = out_dirs(root, cfg)
    return ([os.path.join(odir, f"ELR_rpss_{t}_{wk}.nc")
             for t in ("train", "test")]
            + [os.path.join(odir, f"{arch}_rpss_{t}_{wk}.nc")
               for t in ("train", "val", "test")]
            + [os.path.join(odir, f"{s}_{wk}.json")
               for s in ("best_hparams", "profile")]
            + [os.path.join(mdir, f) for mdir in mdirs for f in
               [f"winners_{wk}.json"]
               + [f"best_model_{arch}_{i}_{suffix}.pt"
                  for i in range(out.nn.masks.n_folds)]])


def check_tree(root, outs, suffix, extra=()):
    """The files under root are exactly the trees of the runs `outs` (and
    the `extra` paths), file by file; returns their count."""
    want = sorted([f for out in outs for f in tree_files(root, out, suffix)]
                  + list(extra))
    found = sorted(os.path.join(r, f) for r, _, fs in os.walk(root)
                   for f in fs)
    check(found == want, f"outputs: missing "
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


def step_launches(n_blocks):
    """(forward, dx) conv kernel launches of one U-Net optimizer step: the
    forward of each of its 4 n_blocks + 2 kernel convs and the dx mode of
    all but the first (its input, the image, needs no gradient)."""
    return 4 * n_blocks + 2, 4 * n_blocks + 1


def expected_launches(torch, out, load=False):
    """Kernel launches a run implies: per optimizer step the forward and
    the dx of every kernel conv but the first (its input, the image, needs
    no gradient); per epoch one val forward over the val rows; per fold one
    winner forward over all rows (a load runs only these). Eval forwards
    run in row chunks (engine.row_chunk). A U-Net has 4 n_blocks + 2
    kernel convs: a sweep counts each lane (fold x trial) at its own
    trial's depth, from its epochs in the sweep's epochs_table, and each
    fold's winner forward at its winner's depth, summed over the models of
    an MME; a fixed training (or its load) runs the grid's first trial.
    Returns (count, its terms)."""
    from s2s_ismr_tpu_torch.pipelines.tune import resolve_batch_sizes
    from s2s_ismr_tpu_torch.train.engine import row_chunk, train_batches
    from s2s_ismr_tpu_torch.train.sweep import enumerate_trials
    cfg, nn = out.config, out.nn
    F, T = nn.labels.shape[:2]
    chunk = row_chunk(torch.empty((1,) + nn.labels.shape[2:]))
    val_chunks = -(-int(nn.masks.val.sum(1).max()) // chunk)
    fwd_chunks = -(-T // chunk)
    trials = enumerate_trials(resolve_batch_sizes(cfg.tuning, T))

    def depth(t):
        return 4 * t.n_blocks + 2
    if cfg.architecture == "unet" and nn.sweeps and not load:
        count = steps = epochs = 0
        for sw in nn.sweeps.values():
            for f in range(F):
                n_train = int(nn.masks.train[f].sum())
                for t in trials:
                    e = int(sw.epochs_table[f, t.index])
                    s = e * train_batches(n_train, t.batch_size)
                    count += (s * sum(step_launches(t.n_blocks))
                              + e * depth(t) * val_chunks)
                    steps, epochs = steps + s, epochs + e
            count += sum(depth(t) for t in sw.best_trial) * fwd_chunks
        check(steps == nn.train_steps and epochs == nn.epochs_run,
              f"per-lane steps {steps} / epochs {epochs} differ from the "
              f"run's {nn.train_steps} / {nn.epochs_run}")
        winners = [t.n_blocks for sw in nn.sweeps.values()
                   for t in sw.best_trial]
        terms = (f"{steps} steps and {epochs} epochs over "
                 f"{len(nn.sweeps)} x {F} x {len(trials)} lanes at n_blocks "
                 f"{sorted({t.n_blocks for t in trials})}, "
                 f"{len(winners)} winner forwards of {T} rows in "
                 f"{fwd_chunks} chunk(s) at n_blocks {winners}")
        return count, terms
    n_conv = {"unet": depth(trials[0]), "cnn": 4,
              "mlp": 0}[cfg.architecture]
    count = F * n_conv * fwd_chunks
    if not load and n_conv:
        count += (nn.train_steps * (2 * n_conv - 1)
                  + nn.epochs_run * n_conv * val_chunks)
    terms = (f"{nn.train_steps} steps, {nn.epochs_run} epochs, "
             f"{F} winner forwards of {T} rows in {fwd_chunks} chunk(s), "
             f"{n_conv} kernel convs per forward")
    return count, terms


def bn_step_launches(arch, n_blocks=0):
    """BatchNorm kernel launches of one one-lane optimizer step: a forward
    and a backward per train-mode BatchNorm, 2 n_blocks of them in a U-Net
    (bn_shapes), 2 in the MLP, none in the cnn."""
    return 2 * {"unet": 2 * n_blocks, "mlp": 2, "cnn": 0}[arch]


def expected_bn_launches(torch, out):
    """BatchNorm kernel launches a run implies: bn_step_launches per
    one-lane optimizer step, each lane of a sweep at its own trial's depth
    (its epochs from the sweep's epochs_table, summed over the models of an
    MME), a fixed training at the grid's first trial; none in a sweep of
    batched lanes ('vmap': their BatchNorms are the plain ops), a load or
    an eval forward (eval mode normalizes with the plain ops)."""
    from s2s_ismr_tpu_torch.pipelines.tune import resolve_batch_sizes
    from s2s_ismr_tpu_torch.train.engine import train_batches
    from s2s_ismr_tpu_torch.train.sweep import enumerate_trials
    cfg, nn = out.config, out.nn
    if not nn.train_steps:
        return 0
    F, T = nn.labels.shape[:2]
    trials = enumerate_trials(resolve_batch_sizes(cfg.tuning, T))
    if cfg.architecture == "unet" and nn.sweeps:
        return sum(
            int(sw.epochs_table[f, t.index])
            * train_batches(int(nn.masks.train[f].sum()), t.batch_size)
            * bn_step_launches("unet", t.n_blocks)
            for sw in nn.sweeps.values()
            if sw.timings["lane_dispatch"] != "vmap"
            for f in range(F) for t in trials)
    return nn.train_steps * bn_step_launches(cfg.architecture,
                                             trials[0].n_blocks)


BN_RUNS = {}    # what -> BatchNorm kernel launches of the runs checked


def check_bn_launches(what, want):
    """batchnorm.LAUNCHES, set to 0 with conv.LAUNCHES just before the run
    `what`, equals `want`: the kernels ran forward and backward at every
    train-mode BatchNorm of every one-lane training step. Noted in
    BN_RUNS; returns the count."""
    from s2s_ismr_tpu_torch.kernels import batchnorm
    got = batchnorm.LAUNCHES
    check(got == want, f"{what}: BatchNorm kernel launches {got}, expected "
          f"{want}")
    BN_RUNS[what] = got
    return got


def reset_launches(conv):
    """The conv and BatchNorm kernels' launch counts set to 0."""
    from s2s_ismr_tpu_torch.kernels import batchnorm
    conv.LAUNCHES = batchnorm.LAUNCHES = 0


def check_programs(what, since, epochs, forwards):
    """Every training epoch and eval forward since the programs' counts
    were `since` (a copy of programs.STATS) ran as a replay of a memoized
    program: `epochs` epoch replays (lane epochs, or batched epochs),
    `forwards` forward replays, nothing uncaptured."""
    from s2s_ismr_tpu_torch import programs
    s = {k: v - since[k] for k, v in programs.STATS.items()}
    check(s["uncaptured_cuda_runs"] == 0 and s["train_replays"] == epochs
          and s["predict_replays"] == forwards,
          f"{what}: programs {s}; expected {epochs} epoch replays, "
          f"{forwards} forward replays, none uncaptured")
    print(f"  {what}: {s['train_replays']} epoch replays = the epochs run, "
          f"{s['predict_replays']} forward replays, 0 uncaptured; "
          f"{s['captures']} captures in {s['capture_s']:.2f} s (builds "
          f"with their warm-ups {s['build_s']:.2f} s), memo hits "
          f"{s['hits']}, misses {s['misses']}")


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
    odir, (mdir,) = out_dirs(d, cfg)
    n_folds = out.nn.masks.n_folds
    n = check_tree(d, [out], "tuned")
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
    check_programs("programs of the run", CLI_PROGRAMS, epochs, n_folds)

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
        reset_launches(conv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tune.run_pipeline(cfg, out_root=out_root, log=lambda s: None,
                                device="cuda")
        torch.cuda.synchronize()
        check_bn_launches(f"run_pipeline {cfg.architecture}",
                          expected_bn_launches(torch, out))
        return out, time.perf_counter() - t0, conv.LAUNCHES

    def report(name, root, run, suffix, load=False):
        nonlocal total
        out, seconds, launches = run
        n = check_tree(root, [out], suffix)
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
    """fn() with the kernels' launch counts set to 0 just before (its
    forwards are eval mode: no BatchNorm kernel launch); returns (result,
    paths, wall s, conv launches)."""
    reset_launches(conv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, paths = fn()
    torch.cuda.synchronize()
    check_bn_launches("realtime forwards", 0)
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
    dev = bench.device_ms_many(
        torch, [lambda: attrib.gradcam(unet, unet_state, x)], reps=10)
    check(dev is not None, "GradCAM: the profiler saw no device time")
    dev = dev[0]
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
    from s2s_ismr_tpu_torch.kernels import batchnorm
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
    warm, bn_warm = conv.WARMUP_LAUNCHES, batchnorm.WARMUP_LAUNCHES
    try:
        out, seconds, launches = cli_run(torch, conv, argv + [
            "--profile", p, "--out", o])
    finally:
        tune.trace = real
    # a program built inside the traced window adds its warm-up's launches
    warm = conv.WARMUP_LAUNCHES - warm
    bn_warm = batchnorm.WARMUP_LAUNCHES - bn_warm
    bn_want = expected_bn_launches(torch, out)
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
        n_conv = sum(conv.is_kernel_event(e.get("name", ""))
                     for e in kernels)
        n_bn = sum(any(k in e.get("name", "") for k in BN_KERNELS)
                   for e in kernels)
        print(f"  (d) {stage} trace {os.path.relpath(rec.path, work)}: "
              f"{rec.bytes} bytes, written in {rec.write_s:.3f} s, parsed "
              f"in {parse_s:.3f} s; {len(events)} events, {len(kernels)} "
              f"CUDA kernel events, {n_conv} of the conv kernel, {n_bn} of "
              f"the BatchNorm kernels")
        check(kernels, f"the {stage} trace holds no CUDA kernel event")
        want = expected + warm if stage == "NN" else 0
        check(n_conv == want, f"{stage} trace: {n_conv} conv kernel "
              f"events, expected {want} ({terms}; {warm} warm-up)")
        want = bn_want + bn_warm if stage == "NN" else 0
        check(n_bn == want, f"{stage} trace: {n_bn} BatchNorm kernel "
              f"events, expected {want} ({bn_want} from the steps, "
              f"{bn_warm} warm-up)")
    stages = {}
    for name, run_out in (("untraced", plain), ("traced", out)):
        with open(run_out.paths["profile"]) as fh:
            stages[name] = json.load(fh)["stages_s"]
    print(f"  (d) traced run: wall {seconds:.2f} s (untraced {plain_s:.2f} "
          f"s), stages {stages['traced']} (untraced {stages['untraced']}; "
          f"trace writing excluded) on {card}; conv launches {launches} = "
          f"expected ({terms}); the NN trace's conv events = those + {warm} "
          f"warm-up launches of programs built in the traced window, its "
          f"BatchNorm kernel events {bn_want} + {bn_warm} likewise")
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


LANES = (4, 20)          # phase 10 (c)'s lanes per bucket; 20-lane configs


def lane_kernel_checks(torch, conv, shapes):
    """(a) of phase 10: the lane mode (forward and dx mode, ELU and none)
    against the float64 plain lane version at each shape for L in LANES,
    each lane its own weights, and one case with x shared by the lanes
    (lane stride 0); with the tile forced equal, every lane of a lane-mode
    launch bit-equal to a one-lane launch of that lane. Returns the
    largest abs error."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0

    def held(name, got, want):
        nonlocal worst
        ea, ex = bench.excess(got, want)
        check(ex <= 0, f"{name}: lane mode max abs err {ea:.3e} vs float64 "
              f"exceeds rtol {bench.RTOL} / atol {bench.ATOL}")
        worst = max(worst, ea)

    for lanes in LANES:
        for shape in shapes:
            x, w, b, g = bench.lane_inputs(torch, shape, lanes, gen)
            n, h, wd, c, o = shape
            for act in ("elu", "none"):
                tag = f"L={lanes} {shape} {act}"
                out = conv._launch_lanes(x, w, b, act)
                held(f"fwd {tag}", out, conv.conv3x3_bias_act_lanes_plain(
                    x.double(), w.double(), b.double(), act))
                dx, gp = conv._launch_dx_lanes(g, out, w, act)
                dx_w, gp_w = conv.conv3x3_dx_lanes_plain(
                    g.double(), out.double(), w.double(), act)
                held(f"dx {tag}", dx, dx_w)
                held(f"g' {tag}", gp, gp_w)
                # lane i = the one-lane launch of lane i, same tile
                tf = conv.launch_tile(shape, lanes=lanes)
                td = conv.launch_tile(shape, True, act == "elu", lanes)
                out_t = conv._launch_lanes(x, w, b, act, tile=tf)
                dx_t, gp_t = conv._launch_dx_lanes(g, out_t, w, act, tile=td)
                for i in range(lanes):
                    one = conv._launch(x[i], w[i], b[i], act, tile=tf)
                    d1, g1 = conv._launch_dx(g[i], out_t[i], w[i], act,
                                             tile=td)
                    check(torch.equal(out_t[i], one)
                          and torch.equal(dx_t[i], d1)
                          and torch.equal(gp_t[i], g1),
                          f"{tag}: lane {i} differs from its one-lane "
                          f"launch with the same tile")
        print(f"  L = {lanes}: forward, dx and g' at {len(shapes)} shapes x "
              f"2 acts within rtol {bench.RTOL} / atol {bench.ATOL} of "
              f"float64; every lane bit-equal to its one-lane launch")
    shape = shapes[len(shapes) // 2]
    x, w, b, _ = bench.lane_inputs(torch, shape, LANES[0], gen)
    shared = conv._launch_lanes(x[0], w, b, "elu")
    held(f"shared x {shape}", shared, conv.conv3x3_bias_act_lanes_plain(
        x[0].double(), w.double(), b.double(), "elu"))
    print(f"  x shared by {LANES[0]} lanes (lane stride 0) at {shape}: "
          f"within tolerance; max abs err {worst:.3e}")
    return worst


def lane_kernel_times(torch, conv, shapes, card):
    """(b) of phase 10: device time per call, by torch.profiler (one
    window per shape and mode), of the lane mode, of L one-lane launches
    and of cuDNN's grouped F.conv2d (groups = L, TF32 off), in turns
    (lane mode, one-lane launches, cuDNN, lane mode), forward and dx mode (ELU; cuDNN's dx a grouped conv
    of g with the adjoint taps), summed over the shapes, with the bound
    (L times the one-lane bound). Returns {L: {mode: {key: ms}}}."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(3)
    res = {}
    for lanes in LANES:
        sums = {m: dict.fromkeys(("ms", "serial_ms", "library_ms",
                                  "bound_ms"), 0.0) for m in ("fwd", "dx")}
        wins = []
        for shape in shapes:
            x, w, b, g = bench.lane_inputs(torch, shape, lanes, gen)
            xg, wg, bg, gg, wa = bench.grouped_layouts(x, w, b, g)
            with torch.no_grad():
                out = conv._launch_lanes(x, w, b, "elu")
                calls = {
                    "fwd": (lambda: conv._launch_lanes(x, w, b, "elu"),
                            lambda: [conv._launch(x[i], w[i], b[i], "elu")
                                     for i in range(lanes)],
                            lambda: F.conv2d(xg, wg, bg, padding=1,
                                             groups=lanes)),
                    "dx": (lambda: conv._launch_dx_lanes(g, out, w, "elu"),
                           lambda: [conv._launch_dx(g[i], out[i], w[i],
                                                    "elu")
                                    for i in range(lanes)],
                           lambda: F.conv2d(gg, wa, None, padding=1,
                                            groups=lanes))}
                for mode, (lane, serial, lib) in calls.items():
                    t = bench.device_ms_many(torch, (lane, serial, lib, lane))
                    check(t is not None, f"L={lanes} {shape} {mode}: the "
                          f"profiler saw no device time")
                    s = sums[mode]
                    if t[2] < (t[0] + t[3]) / 2:
                        wins.append((shape, mode,
                                     (t[0] + t[3]) / 2 / t[2]))
                    s["ms"] += (t[0] + t[3]) / 2
                    s["serial_ms"] += t[1]
                    s["library_ms"] += t[2]
                    s["bound_ms"] += lanes * bench.bound(shape,
                                                         mode == "dx")[0]
        count_families(conv, f"10 L={lanes}", shapes, lanes=lanes)
        print(f"  L = {lanes}: cuDNN grouped faster at {len(wins)} of "
              f"{2 * len(shapes)} (shape, mode) cases"
              + (": " + "; ".join(f"{t} {m} {f:.2f}x" for t, m, f in wins)
                 if wins else ""))
        for mode, s in sums.items():
            print(f"  L = {lanes} {mode} summed over {len(shapes)} shapes: "
                  f"lane mode {s['ms']:.4f} ms, {lanes} one-lane launches "
                  f"{s['serial_ms']:.4f} ms, cuDNN grouped "
                  f"{s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms "
                  f"({s['bound_ms'] / s['ms']:.1%} of it) on {card}")
        res[lanes] = sums
    return res


def device_busy(torch, fn):
    """(fn's result, wall s, device busy s) of one run of fn under
    torch.profiler: busy is the sum of the device events' durations."""
    from s2s_ismr_tpu_torch.bench import device_profile
    out, wall, events = device_profile(fn)
    return out, wall, sum(e.time_range.elapsed_us() for e in events) / 1e6


def lanes_path(torch, conv, card, work):
    """Phase 10: batched lanes, the one-card mesh and bf16 on cuda.
    Returns (launches of the sweeps and runs, max abs err, the kernel
    times of (b), lane-mode launches of (c)'s first vmap run)."""
    from dataclasses import replace

    import numpy as np
    from s2s_ismr_tpu_torch.io import read_netcdf
    from s2s_ismr_tpu_torch.pipelines import get_config, tune
    from s2s_ismr_tpu_torch.train.engine import deterministic_cudnn
    from s2s_ismr_tpu_torch.train.sweep import run_unet_sweep

    t0 = time.perf_counter()

    def took(part):
        print(f"  ({part}) took {time.perf_counter() - t0:.1f} s of phase 10 "
              f"so far")

    shapes = bench.slice_shapes(torch, (2,), BATCH)
    print(f"  (a) the lane mode vs float64 at the {len(shapes)} shapes of "
          f"the fast sweep's U-Net (filters 2, batch {BATCH}), L in {LANES}")
    max_abs = lane_kernel_checks(torch, conv, shapes)
    took("a")
    print(f"  (b) device time per call at those shapes (in turns)")
    times = lane_kernel_times(torch, conv, shapes, card)
    took("b")

    cfg = get_config("tune_ECMWF_com").fast_variant()
    grid = replace(cfg.tuning, learning_rates=(1e-3, 1e-4))
    bundles = tune.load_bundles(cfg)
    _, filled, first, fm, _, y_oh, _ = tune._nn_setup(cfg, bundles,
                                                      lambda s: None, "cuda")
    x = first.predictor_images("mean")
    grid = tune.resolve_batch_sizes(grid, x.shape[0])
    n_conv = 4 * max(grid.n_blocks) + 2
    launches = 0

    # 3 of the fast variant's 6 epochs: the checks below read launches per
    # step and epoch and the val tables, not depth, and the script must
    # keep within its time with phase 12
    def sweep(mode, epochs=3, **kw):
        nonlocal launches
        reset_launches(conv)
        conv.LANE_LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_unet_sweep(x, y_oh, fm.train, fm.val, grid, epochs=epochs,
                             device="cuda", lane_dispatch=mode, **kw)
        torch.cuda.synchronize()
        # batched lanes' BatchNorms are the plain ops
        check_bn_launches(f"phase 10 {mode} sweep {kw}", 0 if mode == "vmap"
                          else res.train_steps * bn_step_launches(
                              "unet", max(grid.n_blocks)))
        launches += conv.LAUNCHES
        return res, time.perf_counter() - t0, conv.LAUNCHES, \
            conv.LANE_LAUNCHES

    print(f"  (c) run_unet_sweep of the fast tune_ECMWF_com ({x.shape[0]} "
          f"rows of 32x32, {fm.n_folds} folds, learning rates "
          f"{grid.learning_rates}: {fm.n_folds * len(grid.learning_rates)} "
          f"lanes per bucket), 'vmap' then 'serial'")
    runs = {}
    for mode in ("vmap", "serial"):
        res, secs, n_launch, n_lane = sweep(mode)
        F = fm.n_folds
        if mode == "vmap":
            bs = res.timings["batched_steps"]
            be = res.timings["batched_epochs"]
            want_lane = bs * (2 * n_conv - 1) + be * n_conv
            check(n_lane == want_lane and n_launch - n_lane == F * n_conv,
                  f"vmap sweep: {n_lane} lane-mode launches (expected "
                  f"{want_lane} = {bs} batched steps x {2 * n_conv - 1} + "
                  f"{be} batched epochs x {n_conv}), {n_launch - n_lane} "
                  f"one-lane launches (expected {F * n_conv})")
            lane_launches = n_lane
            terms = (f"{n_lane} lane-mode launches = {bs} batched steps x "
                     f"{2 * n_conv - 1} + {be} batched epochs x {n_conv}, "
                     f"{n_launch - n_lane} one-lane (winner forwards)")
        else:
            want = (res.train_steps * (2 * n_conv - 1)
                    + res.epochs_run * n_conv + F * n_conv)
            check(n_launch == want and n_lane == 0,
                  f"serial sweep: {n_launch} launches, expected {want}")
            terms = f"{n_launch} launches, as its steps imply"
        check(np.isfinite(res.val_loss_table).all(),
              f"{mode}: non-finite val loss")
        runs[mode] = res
        print(f"  {mode}: {res.train_steps} steps of {res.epochs_run} lane "
              f"epochs in {secs:.2f} s = {res.train_steps / secs:.1f} "
              f"steps/s ({res.timings['execute_s']:.2f} s training); {terms}"
              f" on {card}")
    rv, rs = runs["vmap"], runs["serial"]
    dv = float(np.abs(rv.val_loss_table - rs.val_loss_table).max())
    check(dv <= 2e-4, f"vmap vs serial val tables differ by {dv:.3e}")
    check([t.index for t in rv.best_trial] == [t.index for t in rs.best_trial],
          "vmap and serial sweeps pick other winners")
    print(f"  vmap vs serial: val tables within {dv:.3e}, the same winners "
          f"{[t.index for t in rv.best_trial]}")
    idle = {}
    for mode in ("vmap", "serial"):
        (res, _, _, _), wall, busy = device_busy(
            torch, lambda: sweep(mode, epochs=1))
        idle[mode] = 1 - busy / wall
        print(f"  {mode}, one epoch under torch.profiler: {res.train_steps} "
              f"steps, wall {wall:.2f} s, device busy {busy:.3f} s "
              f"({busy / res.train_steps * 1e3:.3f} ms per lane step), idle "
              f"share {idle[mode]:.3f}")

    took("c")
    print("  (d) run_pipeline(use_mesh=True) of the fast tune_ECMWF_com at "
          "--epochs 2 on a one-card mesh vs use_mesh=False (cuDNN held "
          "deterministic in both)")
    outs = {}
    for use in (False, True):
        logs = []
        root = os.path.join(work, f"mesh_{use}")
        reset_launches(conv)
        t1 = time.perf_counter()
        with deterministic_cudnn():
            outs[use] = tune.run_pipeline(
                replace(cfg, epochs=2), out_root=root, log=logs.append,
                device="cuda", use_mesh=use)
        check_bn_launches(f"use_mesh={use}",
                          expected_bn_launches(torch, outs[use]))
        launches += conv.LAUNCHES
        secs = time.perf_counter() - t1
        meshed = [s for s in logs if s.startswith("[mesh]")]
        check(meshed == (["[mesh] sweep lanes sharded over 1 devices"]
                         if use else []), f"mesh log lines {meshed}")
        print(f"  use_mesh={use}: wall {secs:.2f} s; {meshed}")
    a, b = outs[False], outs[True]
    check(b.nn.sweeps["ECMWF"].timings["lane_dispatch"] == "mesh",
          "the mesh run did not shard its lanes")
    for key in a.paths:
        if key.endswith(("_train", "_val", "_test")):
            va = read_netcdf(a.paths[key]).values
            vb = read_netcdf(b.paths[key]).values
            check(va.tobytes() == vb.tobytes(),
                  f"one-card mesh: {key} netcdf differs from the serial run")
    for f, (sa, sb) in enumerate(zip(a.nn.sweeps["ECMWF"].winner_variables,
                                     b.nn.sweeps["ECMWF"].winner_variables)):
        check(all(torch.equal(sa[k], sb[k]) for k in sa),
              f"one-card mesh: fold {f} winner state differs")
    print("  one-card mesh: RPSS netcdfs and winner states bit-equal to the "
          "serial run")

    took("d")
    print("  (e) compute_dtype='bfloat16' under both backends, one epoch "
          "(first-epoch val losses) against float32")
    for backend in ("kernel", "torch"):
        tables = {}
        for dt in ("float32", "bfloat16"):
            res, secs, _, _ = sweep("serial", epochs=1, conv_backend=backend,
                                    compute_dtype=dt)
            tables[dt] = res.val_loss_table
        d16 = float(np.abs(tables["bfloat16"] - tables["float32"]).max())
        check(np.isfinite(tables["bfloat16"]).all() and d16 <= 2e-2,
              f"bf16 {backend}: val losses {tables['bfloat16']} vs float32 "
              f"{tables['float32']}")
        print(f"  {backend}: bf16 first-epoch val losses within {d16:.3e} "
              f"of float32 ({tables['bfloat16'].ravel().tolist()})")
    took("e")
    return launches, max_abs, times, lane_launches, idle


# phase 14: the engine's programs (each lane's epoch and each eval forward
# a memoized CUDA graph) against the uncaptured seam
PROG_CONFIG = "tune_ECMWF_com"
PROG_EPOCHS = 6
PROG_TURN_EPOCHS = 3     # (c)'s: fewer, so the script fits its time limit
PROG_TURNS = 3
PROG_DEVICE = "cuda"     # "cpu" rehearses the phase (not its device numbers)


def program_data(torch, name, fast=True):
    """(x (T, H, W, C), one-hot labels (F, T, H, W, 3), fold masks) of
    config `name` on cuda (its fast variant's folds)."""
    from s2s_ismr_tpu_torch.pipelines import get_config, tune
    cfg = get_config(name)
    cfg = cfg.fast_variant() if fast else cfg
    bundles = tune.load_bundles(cfg)
    _, _, first, fm, _, y_oh, _ = tune._nn_setup(cfg, bundles,
                                                 lambda s: None, PROG_DEVICE)
    x = torch.as_tensor(first.predictor_images("mean"), device=PROG_DEVICE)
    return x, y_oh, fm


def gen_states(gens):
    return [None if g is None else g.get_state() for g in gens]


def fold_lane(torch, data, make, f, lr, seed, settings, uncaptured):
    """train_fold of fold f on the model make(generator) with lane seed
    `seed`: (best, best vloss, hist, Adam count, generator states after)."""
    from s2s_ismr_tpu_torch import programs
    from s2s_ismr_tpu_torch.train.engine import train_fold
    x, y, fm = data
    g = torch.Generator().manual_seed(seed)
    d = torch.Generator(device=PROG_DEVICE).manual_seed(seed + 1)
    best, v, h = train_fold(make(g), x, y[f], fm.train[f], fm.val[f], lr, g,
                            settings, dropout_generator=d,
                            _uncaptured=uncaptured)
    count = programs.last().lane.opt_state[0].clone()
    return best, v, h, count, gen_states([g, d])


def lanes_run(torch, data, make, lrs, seed, settings, uncaptured, drop):
    """train_lanes of folds (0, 0, 1, 1) x lrs: (best list, best vlosses,
    hist, Adam counts, generator states after, batched steps)."""
    from s2s_ismr_tpu_torch import programs
    from s2s_ismr_tpu_torch.train.engine import train_lanes
    x, y, fm = data
    fs = [0, 0, 1, 1]
    gens = [torch.Generator().manual_seed(seed + i) for i in range(4)]
    models = [make(g) for g in gens]
    drops = ([torch.Generator(device=PROG_DEVICE).manual_seed(seed + 10 + i)
              for i in range(4)] if drop else None)
    res = train_lanes(models, x, y[fs], fm.train[fs], fm.val[fs], lrs, gens,
                      settings, dropout_generators=drops,
                      _uncaptured=uncaptured)
    count = programs.last().opt_state[0].clone()
    return (res.best, res.best_vloss, res.hist, count,
            gen_states(gens + (drops or [])), res.batched_steps)


def same_run(torch, a, b):
    """The fields of two runs that differ (a run: best state or list of
    them, best vloss, hist, Adam count, generator states, ...)."""
    def states_equal(x, y):
        if isinstance(x, list):
            return len(x) == len(y) and all(states_equal(u, v)
                                            for u, v in zip(x, y))
        return list(x) == list(y) and all(torch.equal(x[k], y[k]) for k in x)

    diff = []
    if not states_equal(a[0], b[0]):
        diff.append("best state")
    if not torch.equal(a[1], b[1]):
        diff.append("best val loss")
    if not torch.equal(torch.nan_to_num(a[2], nan=-1.0),
                       torch.nan_to_num(b[2], nan=-1.0)):
        diff.append("history / stop epoch")
    if not torch.equal(a[3], b[3]):
        diff.append("Adam count")
    if not all((s is None and t is None) or torch.equal(s, t)
               for s, t in zip(a[4], b[4])):
        diff.append("generator states")
    if a[5:] != b[5:]:
        diff.append("batched steps")
    return diff


def programs_bits(torch, conv, card):
    """(a) of phase 14: graph against the uncaptured seam, bit for bit."""
    from s2s_ismr_tpu_torch import programs
    from s2s_ismr_tpu_torch.models import UNet, UNetConfig
    from s2s_ismr_tpu_torch.models.mlp import MLP
    from s2s_ismr_tpu_torch.pipelines import get_config
    from s2s_ismr_tpu_torch.train.engine import TrainSettings

    data = program_data(torch, PROG_CONFIG)
    x = data[0]
    vrows = int(data[2].val.sum(1).max())

    def unet(rate=0.0, filters=2, n_blocks=3, ct=(2, 2)):
        cfg = UNetConfig(filters=filters, n_blocks=n_blocks, ct_kernel=ct,
                         dropout_rate=rate)
        return lambda g: UNet(cfg, x.shape[-1], generator=g, device=PROG_DEVICE)

    def st(epochs=PROG_EPOCHS, patience=15):
        return TrainSettings(epochs=epochs, batch_size=BATCH,
                             patience=patience, val_rows=vrows,
                             early_exit=True)

    def pair(name, run):
        t0 = time.perf_counter()
        graph, seam = run(False), run(True)
        diff = same_run(torch, graph, seam)
        check(not diff, f"(a) {name}: graph and seam differ in {diff}")
        print(f"  (a) {name}: graph == seam bit for bit (best state, best "
              f"val loss, history, stop epoch {int(torch.isfinite(graph[2]).sum(-1).max())}"
              f", Adam count {graph[3].tolist()}, generator states); "
              f"{time.perf_counter() - t0:.2f} s")
        return graph

    for rate in (0.0, 0.2):
        pair(f"train_fold, fast U-Net (32x32, T = {x.shape[0]}, n_blocks "
             f"3, filters 2, batch {BATCH}), {PROG_EPOCHS} epochs, dropout "
             f"{rate}", lambda u: fold_lane(torch, data, unet(rate), 0, 1e-3,
                                            7, st(), u))
    pair("train_fold, the mlp (dropout 0.3)", lambda u: fold_lane(
        torch, data, lambda g: MLP(tuple(x.shape[1:3]), x.shape[-1],
                                   generator=g, device=PROG_DEVICE),
        0, 1e-3, 8, st(), u))
    for rate in (0.0, 0.2):
        graph = pair(f"train_lanes, L = 4 (folds 0, 0, 1, 1; lr 1.0, 1e-3), "
                     f"patience 2, dropout {rate}",
                     lambda u: lanes_run(torch, data, unet(rate), [1.0, 1e-3,
                                                                   1.0, 1e-3],
                                         9, st(patience=2), u, rate > 0))
        stops = torch.isfinite(graph[2]).sum(1).tolist()
        check(len(set(stops)) > 1, f"(a) lanes all stopped at {stops}")
        print(f"  lanes stopped at epochs {stops}")

    # a lane on a program another lane used, against a fresh program
    make = unet()
    fold_lane(torch, data, make, 1, 1e-4, 11, st(), False)
    reused = fold_lane(torch, data, make, 1, 1e-3, 12, st(), False)
    misses = programs.STATS["misses"]
    programs._program_memo.clear()
    fresh = fold_lane(torch, data, make, 1, 1e-3, 12, st(), False)
    check(programs.STATS["misses"] == misses + 1, "no fresh program")
    diff = same_run(torch, reused, fresh)
    check(not diff, f"(a) reused program vs fresh program: {diff}")
    print("  (a) a lane on a program another lane (lr 1e-4) used == the "
          "lane on a freshly captured program, bit for bit")

    gefs = get_config("tune_GEFS_full")
    gdata = program_data(torch, "tune_GEFS_full")
    vrows = int(gdata[2].val.sum(1).max())
    pair(f"train_fold, a _BLOCKS_GRID lane of tune_GEFS_full (n_blocks 5, "
         f"filters 3, ct 5x5; {tuple(gdata[0].shape)}), 2 epochs",
         lambda u: fold_lane(torch, gdata, lambda g: UNet(
             UNetConfig(filters=3, n_blocks=5, ct_kernel=(5, 5)),
             gdata[0].shape[-1], generator=g, device=PROG_DEVICE),
             0, gefs.tuning.learning_rates[0], 13, st(2, 10), u))
    idata = program_data(torch, "tune_IITM_full")
    vrows = int(idata[2].val.sum(1).max())
    pair(f"train_fold, a tune_IITM_full lane at 64x64 (n_blocks 5, filters "
         f"3, ct 3x3; {tuple(idata[0].shape)}), 2 epochs",
         lambda u: fold_lane(torch, idata, lambda g: UNet(
             UNetConfig(filters=3, n_blocks=5, ct_kernel=(3, 3)),
             idata[0].shape[-1], generator=g, device=PROG_DEVICE),
             0, 1e-3, 14, st(2, 10), u))
    return data


def programs_trace(torch, conv, data):
    """(b) of phase 14: the conv kernel's device events in one profiled
    epoch (a replay) against the counter's delta."""
    from s2s_ismr_tpu_torch.bench import device_profile
    from s2s_ismr_tpu_torch.models import UNet, UNetConfig
    from s2s_ismr_tpu_torch.train.engine import TrainSettings, train_fold
    x, y, fm = data
    st = TrainSettings(epochs=1, batch_size=BATCH, patience=15,
                       val_rows=int(fm.val.sum(1).max()), early_exit=True)

    def epoch():
        g = torch.Generator().manual_seed(21)
        return train_fold(UNet(UNetConfig(), x.shape[-1], generator=g,
                               device=PROG_DEVICE), x, y[0], fm.train[0],
                          fm.val[0], 1e-3, g, st)

    epoch()                          # the program, built outside the trace
    before, warm = conv.LAUNCHES, conv.WARMUP_LAUNCHES
    _, wall, events = device_profile(epoch)
    delta = conv.LAUNCHES - before
    convs = [e for e in events if conv.is_kernel_event(e.name)]
    n_conv = len(convs)
    check(conv.WARMUP_LAUNCHES == warm and n_conv == delta and delta > 0,
          f"(b) profiled epoch: {n_conv} conv kernel events, counter delta "
          f"{delta}, warm-up launches {conv.WARMUP_LAUNCHES - warm}")
    busy = sum(e.time_range.elapsed_us() for e in events)
    kern = sum(e.time_range.elapsed_us() for e in convs)
    share = kern / busy
    print(f"  (b) one profiled epoch (a replay): {n_conv} conv kernel device "
          f"events = the counter's delta {delta}; {len(events)} device "
          f"events in {wall * 1e3:.1f} ms; the conv kernel takes "
          f"{kern / 1e3:.4f} of the epoch's {busy / 1e3:.4f} device ms "
          f"({share:.1%}; the epoch is its lane steps and one val forward)")
    return share


def programs_turns(torch, conv, card, data, since):
    """(c) of phase 14: graph against seam in turns on 2 lanes x
    PROG_TURN_EPOCHS epochs; then one profiled run of each; the programs'
    counts since `since` (programs.STATS at the phase's start). Returns
    the numbers for the kernels line."""
    from s2s_ismr_tpu_torch import programs
    from s2s_ismr_tpu_torch.bench import device_profile
    from s2s_ismr_tpu_torch.models import UNet, UNetConfig
    from s2s_ismr_tpu_torch.train.engine import (TrainSettings, train_batches,
                                                 train_fold)
    x, y, fm = data
    st = TrainSettings(epochs=PROG_TURN_EPOCHS, batch_size=BATCH,
                       patience=15,
                       val_rows=int(fm.val.sum(1).max()), early_exit=True)
    steps = PROG_TURN_EPOCHS * sum(
        train_batches(int(fm.train[f].sum()), BATCH) for f in (0, 1))

    def two_lanes(uncaptured):
        out = []
        for f in (0, 1):
            g = torch.Generator().manual_seed(30 + f)
            out.append(train_fold(
                UNet(UNetConfig(), x.shape[-1], generator=g, device=PROG_DEVICE),
                x, y[f], fm.train[f], fm.val[f], 1e-3, g, st,
                _uncaptured=uncaptured))
        return out

    def timed_run(uncaptured):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = two_lanes(uncaptured)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    two_lanes(False)                 # the programs, built before the turns
    rates = {"graph": [], "seam": []}
    ref = None
    for turn in range(PROG_TURNS):
        for mode in (("graph", "seam") if turn % 2 == 0
                     else ("seam", "graph")):
            out, secs = timed_run(mode == "seam")
            key = [(b, v, h) for b, v, h in out]
            if ref is None:
                ref = key
            check(all(torch.equal(v, rv) for (_, v, _), (_, rv, _)
                      in zip(key, ref)), f"(c) {mode} turn {turn}: val "
                  f"losses differ from the first run's")
            rates[mode].append((steps / secs,
                                secs * 1e3 / (2 * PROG_TURN_EPOCHS)))
    prof = {}
    for mode in ("graph", "seam"):
        _, wall, events = device_profile(lambda: two_lanes(
            mode == "seam"))
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
        prof[mode] = (1 - busy / wall, len(events) / steps, busy * 1e3 / steps)
    for mode in ("graph", "seam"):
        r = rates[mode]
        print(f"  (c) {mode}: lane steps/s "
              f"{[round(v[0], 1) for v in r]}, host ms per lane epoch "
              f"{[round(v[1], 2) for v in r]}; profiled: idle share "
              f"{prof[mode][0]:.3f}, {prof[mode][1]:.1f} device ops and "
              f"{prof[mode][2]:.3f} device ms per lane step ({steps} lane "
              f"steps, 2 lanes x {PROG_TURN_EPOCHS} epochs) on {card}")
    s = {k: v - since[k] for k, v in programs.STATS.items()}
    caps = max(1, s["captures"])
    pool = pool_bytes(torch)
    print(f"  (c) phase 14 so far: {s['captures']} captures, "
          f"{s['capture_s'] / caps:.3f} s per capture, "
          f"{s['build_s'] / caps:.3f} s per build with its warm-up; memo hits "
          f"{s['hits']}, misses {s['misses']}, {len(programs._program_memo)}"
          f" entries; graph pools hold {pool / 2**20:.1f} MiB; warm-up "
          f"launches so far {conv.WARMUP_LAUNCHES}")
    return {"graph_steps_per_s": [v[0] for v in rates["graph"]],
            "seam_steps_per_s": [v[0] for v in rates["seam"]],
            "graph_idle_share": prof["graph"][0],
            "seam_idle_share": prof["seam"][0],
            "graph_ops_per_step": prof["graph"][1],
            "seam_ops_per_step": prof["seam"][1],
            "capture_s": s["capture_s"] / caps,
            "build_s": s["build_s"] / caps, "pool_bytes": pool}


def pool_bytes(torch):
    """Device bytes the CUDA graphs' memory pools hold: the caching
    allocator's segments outside its default pool."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))


def programs_path(torch, conv, card):
    """Phase 14; returns the numbers of (c). TF32 off (main sets it),
    cuDNN held deterministic."""
    from s2s_ismr_tpu_torch import programs
    from s2s_ismr_tpu_torch.train.engine import deterministic_cudnn
    t0 = time.perf_counter()
    since = dict(programs.STATS)
    with deterministic_cudnn():
        data = programs_bits(torch, conv, card)
        print(f"  (a) took {time.perf_counter() - t0:.1f} s")
        share = programs_trace(torch, conv, data)
        nums = programs_turns(torch, conv, card, data, since)
        nums["kernel_share"] = share
    print(f"  phase 14 wall {time.perf_counter() - t0:.2f} s")
    return nums


# phase 11's suite: every config with its whole grid, cut to 1 fold and 1
# epoch, so that phase 13's depth run fits the script's time; the port's
# expectations file holds its RPSS means on the card
SUITE_ARGV = ["suite", "--synthetic", "--folds", "1", "--epochs", "1"]


def expected_path():
    """The port's `suite --check` file, shipped with the package."""
    import s2s_ismr_tpu_torch
    return os.path.join(os.path.dirname(s2s_ismr_tpu_torch.__file__),
                        "expected", "suite_rpss_h100_cut.json")


def suite_configs():
    """The eight configs as `run.main(SUITE_ARGV)` resolves them."""
    from s2s_ismr_tpu_torch import run
    from s2s_ismr_tpu_torch.pipelines import CONFIGS
    args = run._parser().parse_args(SUITE_ARGV)
    return [run._resolve(name, args) for name in CONFIGS]


def grid_kernels(torch, conv, card):
    """(a) of phase 11: the kernel at every kernel-conv shape of the eight
    configs' tuning grids (every trial at its batch size on the config's
    grid, from bench.config_shapes) against float64, forward, backward and
    dx mode, every launch twice and bit-equal; the eval row counts' shapes
    forward only; then the device times of the training shapes in turns
    with cuDNN, summed per grid family, and each shape where cuDNN wins.
    Returns (max abs err, summed times over the training shapes, the
    number of training and eval shapes)."""
    families = {}
    for cfg in suite_configs():
        train, evals = bench.config_shapes(torch, cfg)
        fam = families.setdefault((cfg.tuning, train[0][1:3]), {
            "configs": [], "train": train, "eval": []})
        fam["configs"].append(cfg.name)
        fam["eval"] += [e for e in evals if e not in fam["eval"]]
    train, evals = [], []
    for fam in families.values():
        train += [t for t in fam["train"] if t not in train]
        evals += [e for e in fam["eval"] if e not in evals + train]
    old = bench.slice_shapes(torch, (2, 3), BATCH)
    check(max(max(t[3:]) for t in train + evals) <= conv.MAX_CHANNELS,
          "a grid shape is wider than the kernel takes")
    n_new = len([t for t in train if t not in old])
    print(f"  {len(train)} training shapes ({n_new} not among phase 3's), "
          f"{len(evals)} eval shapes (val rows and T in row chunks) over "
          f"{len(families)} grid families")
    named = [t for t in train if t[3] == t[4] == 384 or t[1] == 3]
    print(f"  named cases: C = O = 384 at 1x1 and 2x2 maps, and the 3x3 maps "
          f"of the 24x24 grid")
    max_abs = kernel_vs_plain(torch, conv, named)
    print(f"  named cases: max abs err {max_abs:.3e} over {len(named)} "
          f"shapes")
    max_abs = max(max_abs, kernel_vs_plain(
        torch, conv, [t for t in train if t not in named]))
    print(f"  eval shapes, forward (ELU)")
    max_abs = max(max_abs, kernel_vs_plain(torch, conv, evals,
                                           backward=False, acts=("elu",)))
    print(f"  max abs err {max_abs:.3e} over {len(train)} training and "
          f"{len(evals)} eval shapes")

    print(f"  device time per launch at the {len(train)} training shapes "
          f"(kernel and cuDNN in turns; on {card})")
    sums, per = kernel_times(torch, conv, train, phase="11")
    for fam in families.values():
        name = (f"grid family {'+'.join(fam['configs'])} "
                f"({fam['train'][0][1]}x{fam['train'][0][2]})")
        fsums = {m: {k: sum(per[t][m][k] for t in fam["train"])
                     for k in sums[m]} for m in sums}
        print_sums(name, len(fam["train"]), fsums)
    print_sums("all grid shapes", len(train), sums)
    return max_abs, sums, len(train), len(evals)


def run_suite(torch, conv, argv):
    """run.main(argv) for `suite` in-process on cuda, cuDNN deterministic,
    its output captured; each config's kernel launch counts set to 0 and
    the peak device memory reset just before its run_pipeline and read
    just after (the BatchNorm kernel's checked against its steps). Returns (exit code, {config: (TuneOutputs, wall s,
    launches, peak bytes)}, suite_summary.json, captured stderr)."""
    import contextlib
    import io
    from s2s_ismr_tpu_torch import run
    from s2s_ismr_tpu_torch.pipelines import tune
    from s2s_ismr_tpu_torch.train.engine import deterministic_cudnn
    per, real = {}, tune.run_pipeline

    def recording(cfg, *args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(conv)
        t0 = time.perf_counter()
        out = real(cfg, *args, **kw)
        torch.cuda.synchronize()
        check_bn_launches(f"suite {cfg.name}[{cfg.week}]",
                          expected_bn_launches(torch, out))
        per[cfg.name] = (out, time.perf_counter() - t0, conv.LAUNCHES,
                         torch.cuda.max_memory_allocated())
        return out

    tune.run_pipeline = recording
    log, err = io.StringIO(), io.StringIO()
    try:
        with deterministic_cudnn(), contextlib.redirect_stdout(log), \
                contextlib.redirect_stderr(err):
            rc = run.main(argv)
    finally:
        tune.run_pipeline = real
    out_dir = argv[argv.index("--out") + 1]
    with open(os.path.join(out_dir, "suite_summary.json")) as fh:
        summary = json.load(fh)
    return rc, per, summary, err.getvalue()


def suite_path(torch, conv, card, work):
    """(b) of phase 11: the CLI's `suite` of all eight configs at the full
    width of their grids (1 fold, 1 epoch) with --check against the
    port's expectations file; per config the outputs tree, ELR and U-Net
    test RPSS finite on land in every fold, the launches against the
    per-trial count, wall, NN lane steps/s and peak device memory. Returns
    the launches of the suite."""
    import numpy as np
    from s2s_ismr_tpu_torch.pipelines import CONFIGS, tune

    d = os.path.join(work, "suite")
    argv = SUITE_ARGV + ["--out", d, "--check", expected_path()]
    t0 = time.perf_counter()
    rc, per, summary, err = run_suite(torch, conv, argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"run.main({argv}) returned {rc}: {err[-2000:]}")
    check(sorted(summary["configs"]) == sorted(CONFIGS) == sorted(per)
          and not any("error" in r for r in summary["configs"].values()),
          f"suite configs {summary['configs']}")
    check(summary["check"]["ok"] and "[check] ok" in err,
          f"suite --check: {summary['check']}")
    with open(expected_path()) as fh:
        tol = json.load(fh)["tolerance"]
    print(f"  suite of {len(per)} configs: exit 0, every config ok, "
          f"`[check] ok` against {os.path.relpath(expected_path())} "
          f"(tolerance {tol!r})")
    n = check_tree(d, [p[0] for p in per.values()], "tuned",
                   extra=[os.path.join(d, "suite_summary.json")])
    print(f"  outputs: {n} files, as the JAX CLI writes them")
    launches = 0
    for name, (out, seconds, n_launch, peak) in per.items():
        cfg = out.config
        # land: the grid's pixels with y everywhere finite (the mean over
        # an MME's models); tune_ECMWF_full's zero-filled pad row is not
        # land (its ELR RPSS is NaN, as in the reference)
        ys = [b.y for b in tune.load_bundles(cfg).values()]
        land = np.pad(~np.isnan(np.mean(ys, 0)).any(0),
                      ((0, cfg.pad_y_rows), (0, 0)))
        means = check_rpss(d, out, land, {"ELR": out.elr.rpss_test,
                                          "unet": out.nn.rpss_test})
        expected, terms = expected_launches(torch, out)
        check(n_launch == expected, f"{name}: launches {n_launch}, expected "
              f"{expected} ({terms})")
        launches += n_launch
        with open(out.paths["profile"]) as fh:
            stages = json.load(fh)["stages_s"]
        got = summary["configs"][name]
        print(f"  {name}: {land.shape[0]}x{land.shape[1]}, T "
              f"{out.nn.labels.shape[1]}; ELR / U-Net test RPSS means "
              f"{got['elr_rpss_test_mean']!r} / {got['nn_rpss_test_mean']!r}"
              f" (per fold on land: ELR {means['ELR']}, U-Net "
              f"{means['unet']}); kernel launches {n_launch} = expected "
              f"({terms}); wall {seconds:.2f} s (data {stages['data']} s, "
              f"ELR {stages['elr']} s, NN {stages['nn']} s), "
              f"{out.nn.train_steps} lane steps = "
              f"{out.nn.train_steps / stages['nn']:.1f} lane steps/s in the "
              f"NN stage; peak device memory {peak / 2**20:.1f} MiB on "
              f"{card}")
    steps = sum(p[0].nn.train_steps for p in per.values())
    print(f"  suite wall {wall:.2f} s, {steps} lane steps, launches "
          f"{launches}")
    return launches


# phase 12: IITM's 24 members on tune_IITM_full's 64x64 grid (the
# multi_predictor at the full grid, the stacked predictor through `train`
# and `load`), and the weeks cross product with its persistence seams;
# folds and epochs cut as phase 11's, the weeks on the fast grids
IITM = "tune_IITM_full"
IITM_ARGV = [IITM, "--synthetic", "--folds", "2", "--epochs", "1"]
WEEKS = ("wk1", "wk2")
WEEK_CONFIGS = ("tune_ECMWF_com", "tune_2MME")
WEEK_FLAGS = ["--synthetic", "--fast", "--folds", "2", "--epochs", "1"]
# (n_blocks, filters) of the stacked trials whose eval chunks (a) checks:
# the grid's shallowest and narrowest (the one `train` runs) and its
# deepest and widest
STACKED_TRIALS = ((3, 2), (5, 3))


def iitm_config(predictor):
    """tune_IITM_full as `run.main(IITM_ARGV + ['--predictor', p])`
    resolves it."""
    from s2s_ismr_tpu_torch import run
    args = run._parser().parse_args(IITM_ARGV + ["--predictor", predictor])
    return run._resolve(IITM, args)


def member_shapes(torch, device="cuda"):
    """(a)'s shapes: the multi_predictor first conv at every trial of
    tune_IITM_full's grid (C = the members) at batch 16, and at the val
    rows and T; and the stacked predictor's eval chunks (full chunks and
    the val rows' and T rows' last ones) of every conv of STACKED_TRIALS.
    Returns (training shapes, multi_predictor eval shapes, stacked eval
    shapes)."""
    from dataclasses import replace
    train, evals = bench.config_shapes(torch, iitm_config("multi_predictor"),
                                       device)
    members, side = train[0][3], train[0][1]
    first = [s for s in train if s[3] == members and s[1] == side]
    evals = [s for s in evals if s[3] == members and s[1] == side]
    cfg, stacked = iitm_config("stacked"), []
    for n_blocks, filters in STACKED_TRIALS:
        one = replace(cfg, tuning=replace(
            cfg.tuning, n_blocks=(n_blocks,), n_filters=(filters,),
            ct_kernels=cfg.tuning.ct_kernels[:1]))
        stacked += [s for s in bench.config_shapes(torch, one, device)[1]
                    if s not in stacked]
    return first, evals, stacked


def member_kernels(torch, conv, card):
    """(a) of phase 12: the kernel at member_shapes' shapes against float64
    (the multi_predictor first convs forward, backward and dx mode; the
    eval shapes forward), every launch twice and bit-equal; then their
    device times in turns with cuDNN (the eval shapes forward only) and
    each shape's kernel / cuDNN ratio. Returns (max abs err, the sums over
    the training shapes, over the eval shapes, the shape count)."""
    first, multi, stacked = member_shapes(torch)
    print(f"  {len(first)} multi_predictor first convs {first}, "
          f"{len(multi)} at its eval rows N = {sorted({s[0] for s in multi})}"
          f" and {len(stacked)} stacked eval shapes (chunks of N = "
          f"{sorted({s[0] for s in stacked})} at (n_blocks, filters) "
          f"{STACKED_TRIALS})")
    evals = multi + stacked
    max_abs = kernel_vs_plain(torch, conv, first)
    max_abs = max(max_abs, kernel_vs_plain(torch, conv, evals,
                                           backward=False, acts=("elu",)))
    print(f"  max abs err {max_abs:.3e}; device time per launch (kernel and "
          f"cuDNN in turns; on {card})")
    tsums, per = kernel_times(torch, conv, first, phase="12")
    esums, eper = kernel_times(torch, conv, evals, modes=("fwd",),
                               phase="12")
    print_sums("multi_predictor first convs", len(first), tsums)
    print_sums("eval shapes", len(evals), esums)
    print("  kernel / cuDNN per shape: " + "; ".join(
        f"{s} {m} {r['ms'] / r['library_ms']:.2f}x"
        for p in (per, eper) for s, modes in p.items()
        for m, r in modes.items()))
    return max_abs, tsums, esums, len(first) + len(evals)


@contextlib.contextmanager
def stage_memory(torch):
    """Peak device memory by stage of the runs inside the block: each of
    the port's functions below, wrapped here, resets the peak at entry
    and reads it at exit (none of them runs inside another). Yields
    {stage: [bytes allocated at entry, peak bytes]}, each the largest over
    the stage's calls; 'whole run' is added at exit."""
    from s2s_ismr_tpu_torch.pipelines import tune
    from s2s_ismr_tpu_torch.train import sweep
    seams = ((tune, "load_bundles", "data"), (tune, "_nn_setup", "labels"),
             (tune, "run_elr_branch", "ELR"),
             (sweep, "train_fold", "NN training"),
             (sweep, "predict", "winner eval"),
             (tune, "predict", "winner eval"), (tune, "_nn_result", "scores"))
    peaks, real = {}, [getattr(mod, name) for mod, name, _ in seams]

    def staged(fn, stage):
        def call(*args, **kw):
            torch.cuda.synchronize()
            entry = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            p = peaks.setdefault(stage, [0, 0])
            p[0] = max(p[0], entry)
            p[1] = max(p[1], torch.cuda.max_memory_allocated())
            return out
        return call
    for (mod, name, stage), fn in zip(seams, real):
        setattr(mod, name, staged(fn, stage))
    torch.cuda.reset_peak_memory_stats()
    try:
        yield peaks
    finally:
        for (mod, name, _), fn in zip(seams, real):
            setattr(mod, name, fn)
        peaks["whole run"] = [0, max([p[1] for p in peaks.values()]
                                     + [torch.cuda.max_memory_allocated()])]


def print_memory(name, peaks, card):
    print(f"  {name}: peak device memory by stage, MiB (allocated at entry "
          f"/ peak): " + "; ".join(f"{s} {a / 2**20:.1f} / {p / 2**20:.1f}"
                                   for s, (a, p) in peaks.items())
          + f" on {card}")


def cuda_vs_cpu(torch, mdir, week, fold, x, want):
    """Max abs difference between the fold's winner reloaded on the CPU
    and run on the rows x, and `want`: the card's predictions of them."""
    from s2s_ismr_tpu_torch.train import checkpoint
    from s2s_ismr_tpu_torch.train.engine import predict
    model, _ = checkpoint.load_winner(mdir, week, fold, device="cpu")
    return float((predict(model, None, torch.as_tensor(x))
                  - want.cpu()).abs().max())


def multi_path(torch, conv, card, work):
    """(b) of phase 12: the CLI's tune_IITM_full --predictor
    multi_predictor at its full grid (2 folds, 1 epoch), with peak device
    memory by stage; the outputs tree, the manifest's input shape, test
    RPSS finite on land, launches exact per trial, the winners reloaded
    from disk bit-equal to the sweep's predictions, and a winner forward
    on the CPU within 1e-5 of the card's. Returns the launches."""
    from s2s_ismr_tpu_torch.pipelines import tune
    from s2s_ismr_tpu_torch.train import checkpoint
    from s2s_ismr_tpu_torch.train.engine import predict
    d = os.path.join(work, "multi")
    with stage_memory(torch) as mem:
        out, seconds, launches = cli_run(
            torch, conv, IITM_ARGV + ["--predictor", "multi_predictor",
                                      "--out", d])
    cfg, wk = out.config, out.config.week
    n = check_tree(d, [out], "tuned")
    _, (mdir,) = out_dirs(d, cfg)
    bundle = tune.load_bundles(cfg)[cfg.models[0]]
    with open(os.path.join(mdir, f"winners_{wk}.json")) as fh:
        shapes = {tuple(e["input_shape"]) for e in json.load(fh)}
    want = (1,) + bundle.shape_yx + (bundle.n_m,)
    check(shapes == {want}, f"manifest input shapes {shapes}, want {want}")
    means = check_rpss(d, out, bundle.valid_pixels(),
                       {"ELR": out.elr.rpss_test, "unet": out.nn.rpss_test})
    expected, terms = expected_launches(torch, out)
    check(launches == expected, f"multi_predictor: launches {launches}, "
          f"expected {expected} ({terms})")
    x = bundle.fillna(0.0).predictor_images(cfg.predictor)
    dev = out.nn.predictions.device
    xd = torch.as_tensor(x, device=dev)
    diffs = []
    for f in range(out.nn.masks.n_folds):
        model, _ = checkpoint.load_winner(mdir, wk, f, device=dev)
        check(torch.equal(predict(model, None, xd), out.nn.predictions[f]),
              f"fold {f}: the reloaded winner's predictions differ from "
              f"the sweep's")
        diffs.append(cuda_vs_cpu(torch, mdir, wk, f, x[:64],
                                 out.nn.predictions[f, :64]))
    check(max(diffs) <= 1e-5, f"cuda vs CPU winner forward differs by "
          f"{max(diffs):.3e} > 1e-5")
    print(f"  (b) multi_predictor: {n} files; manifest input shape {want}; "
          f"ELR / U-Net test RPSS on land per fold {means['ELR']} / "
          f"{means['unet']}; launches {launches} = expected ({terms}); "
          f"winners reloaded bit-equal; cuda vs CPU on the first 64 rows "
          f"max abs {max(diffs):.3e}; wall {seconds:.2f} s, "
          f"{out.nn.train_steps} lane steps on {card}")
    print_memory("multi_predictor", mem, card)
    return launches


def stacked_path(torch, conv, card, work):
    """(c) of phase 12: the CLI's tune_IITM_full --predictor stacked
    --training-type train (the grid's first trial, one lane per fold),
    then `load` on the same --out, each with its peak device memory by
    stage; the outputs tree, the shapes on the tiled axis, the row chunks
    per winner forward, launches exact, the load's predictions and RPSS
    maps bit-equal to the train run's, and a CPU forward of the last 64
    rows within 1e-5 of the card's. Returns the launches."""
    from s2s_ismr_tpu_torch.pipelines import tune
    from s2s_ismr_tpu_torch.train.engine import row_chunk
    d = os.path.join(work, "stacked")
    argv = IITM_ARGV + ["--predictor", "stacked", "--out", d]
    runs, mems = {}, {}
    for mode in ("train", "load"):
        with stage_memory(torch) as mems[mode]:
            runs[mode] = cli_run(torch, conv,
                                 argv + ["--training-type", mode])
    trained, loaded = runs["train"][0], runs["load"][0]
    cfg, wk = trained.config, trained.config.week
    n = check_tree(d, [trained], "trained")
    bundle = tune.load_bundles(cfg)[cfg.models[0]]
    rows, F = bundle.n_m * bundle.n_t, trained.nn.masks.n_folds
    check(tuple(trained.nn.predictions.shape)
          == (F, rows) + bundle.shape_yx + (3,)
          and trained.nn.labels.shape == (F, rows) + bundle.shape_yx,
          f"stacked predictions {tuple(trained.nn.predictions.shape)}, "
          f"labels {trained.nn.labels.shape}")
    chunk = row_chunk(torch.empty((1,) + bundle.shape_yx + (1,)))
    chunks = -(-rows // chunk)
    for mode, (out, seconds, launches) in runs.items():
        expected, terms = expected_launches(torch, out, mode == "load")
        check(launches == expected, f"stacked {mode}: launches {launches}, "
              f"expected {expected} ({terms})")
        print(f"  (c) stacked {mode}: launches {launches} = expected "
              f"({terms}); wall {seconds:.2f} s")
    check(torch.equal(loaded.nn.predictions, trained.nn.predictions),
          "the stacked load's predictions differ from the train run's")
    for split in ("rpss_train", "rpss_val", "rpss_test"):
        check((getattr(loaded.nn, split).values.tobytes()
               == getattr(trained.nn, split).values.tobytes()),
              f"the stacked load's {split} differs from the train run's")
    means = check_rpss(d, trained, bundle.valid_pixels())
    x = bundle.fillna(0.0).stacked().predictor_images("stacked")[-64:]
    _, (mdir,) = out_dirs(d, cfg)
    diff = max(cuda_vs_cpu(torch, mdir, wk, f, x,
                           trained.nn.predictions[f, -64:])
               for f in range(F))
    check(diff <= 1e-5, f"stacked cuda vs CPU forward differs by "
          f"{diff:.3e} > 1e-5")
    print(f"  (c) stacked: {n} files; predictions and labels on the tiled "
          f"axis of {rows} rows; {chunks} row chunks of {chunk} per winner "
          f"forward (the last {rows - (chunks - 1) * chunk} rows); the load "
          f"bit-equal to the train run; U-Net test RPSS on land per fold "
          f"{means['unet']}; cuda vs CPU on the last 64 rows max abs "
          f"{diff:.3e}; {trained.nn.train_steps} steps on {card}")
    for mode, mem in mems.items():
        print_memory(f"stacked {mode}", mem, card)
    return sum(r[2] for r in runs.values())


def weeks_path(torch, conv, card, work):
    """(e) of phase 12: the CLI's `suite` of WEEK_CONFIGS x WEEKS (fast
    grids, 2 folds, 1 epoch), cuDNN deterministic: each (config, week)'s
    outputs tree file by file, the week's leads (tune_2MME's custom leads
    revert), test RPSS finite on land, launches exact; the same command
    with --resume runs nothing; a wk1 `load` on the tree is bit-equal to
    the suite's wk1 run; wk1 winners copied under the wk2 name are
    refused; rpss_records reads rows of both weeks. Returns the
    launches."""
    import shutil

    import numpy as np
    from s2s_ismr_tpu_torch import analysis
    from s2s_ismr_tpu_torch.pipelines import tune
    from s2s_ismr_tpu_torch.pipelines.configs import LEAD_MAPPING
    d = os.path.join(work, "weeks")
    argv = (["suite", "--configs", ",".join(WEEK_CONFIGS), "--week",
             ",".join(WEEKS), "--out", d] + WEEK_FLAGS)
    rc, per, summary, err = run_suite(torch, conv, argv)
    names = sorted(f"{c}[{w}]" for c in WEEK_CONFIGS for w in WEEKS)
    check(rc == 0 and sorted(per) == names == sorted(summary["configs"])
          and not any("error" in r for r in summary["configs"].values()),
          f"run.main({argv}) returned {rc}: {err[-2000:]}")
    n = check_tree(d, [p[0] for p in per.values()], "tuned",
                   extra=[os.path.join(d, "suite_summary.json")])
    launches = 0
    for name, (out, seconds, n_launch, _) in per.items():
        cfg = out.config
        leads = [cfg.lead(m) for m in cfg.models]
        check(cfg.custom_lead is None and cfg.custom_leads is None
              and set(leads) == {LEAD_MAPPING[cfg.week]},
              f"{name}: leads {leads}")
        ys = [b.y for b in tune.load_bundles(cfg).values()]
        land = ~np.isnan(np.mean(ys, 0)).any(0)
        means = check_rpss(d, out, land, {"ELR": out.elr.rpss_test,
                                          "unet": out.nn.rpss_test})
        expected, terms = expected_launches(torch, out)
        check(n_launch == expected, f"{name}: launches {n_launch}, expected "
              f"{expected} ({terms})")
        launches += n_launch
        print(f"  (e) {name}: leads {leads}; ELR / U-Net test RPSS on land "
              f"per fold {means['ELR']} / {means['unet']}; launches "
              f"{n_launch} = expected; wall {seconds:.2f} s")
    print(f"  (e) the weeks suite: exit 0, {len(per)} runs, {n} files as "
          f"the JAX CLI writes them")

    conv.LAUNCHES = 0
    rc, again, resumed, err = run_suite(torch, conv, argv + ["--resume"])
    check(rc == 0 and not again and conv.LAUNCHES == 0
          and resumed["configs"] == summary["configs"],
          f"--resume: exit {rc}, ran {sorted(again)}, launches "
          f"{conv.LAUNCHES}: {err[-2000:]}")
    print("  (e) --resume: exit 0, no run and no launch, the summary's "
          "runs unchanged")

    base = [WEEK_CONFIGS[0], "--training-type", "load"] + WEEK_FLAGS
    loaded, _, n_load = cli_run(torch, conv,
                                base + ["--week", "wk1", "--out", d])
    expected, terms = expected_launches(torch, loaded, load=True)
    check(n_load == expected and torch.equal(
        loaded.nn.predictions,
        per[f"{WEEK_CONFIGS[0]}[wk1]"][0].nn.predictions),
        f"wk1 load: launches {n_load} (expected {expected}), or its "
        f"predictions differ from the suite's wk1 run")
    launches += n_load
    cfg = loaded.config
    copied = os.path.join(work, "weeks_copied")
    src, dst = (os.path.join(root, "models", cfg.out_dir,
                             f"{cfg.models[0]}_{cfg.obs}")
                for root in (d, copied))
    shutil.copytree(os.path.join(src, "wk1"), os.path.join(dst, "wk2"))
    os.rename(os.path.join(dst, "wk2", "winners_wk1.json"),
              os.path.join(dst, "wk2", "winners_wk2.json"))
    try:
        cli_run(torch, conv, base + ["--week", "wk2", "--out", copied])
    except ValueError as e:
        check("week" in str(e), f"the refusal does not name the week: {e}")
        refusal = str(e)
    else:
        raise SmokeFailure("wk1 winners copied under wk2 were loaded")
    print(f"  (e) wk1 load: bit-equal to the suite's wk1 run, launches "
          f"{n_load} = expected; wk1 winners copied under wk2 refused: "
          f"{refusal}")

    runs = [{"period_dir": c.out_dir, "model": c.result_name, "obs": c.obs,
             "arch": a, "week": c.week, "label": c.week}
            for c in (p[0].config for p in per.values())
            for a in ("ELR", "unet")]
    table = analysis.rpss_records(runs, d)
    rows = {w: table.subset(lead=w).values.size for w in WEEKS}
    check(all(rows.values()) and np.isfinite(table.values).all(),
          f"rpss_records over the weeks tree: rows {rows}")
    print(f"  (e) rpss_records over the tree: rows per week {rows}")
    return launches


def members_weeks_path(torch, conv, card, work):
    """Phase 12; returns (launches, max abs err, (a)'s sums over its
    training shapes and over its eval shapes, (a)'s shape count)."""
    from s2s_ismr_tpu_torch.train.engine import deterministic_cudnn
    t0 = time.perf_counter()

    def took(part):
        print(f"  ({part}) took {time.perf_counter() - t0:.1f} s of phase 12")
    max_abs, tsums, esums, n_shapes = member_kernels(torch, conv, card)
    took("a")
    with deterministic_cudnn():
        launches = multi_path(torch, conv, card, work)
        took("b")
        launches += stacked_path(torch, conv, card, work)
        took("c")
        launches += weeks_path(torch, conv, card, work)
        took("e")
    return launches, max_abs, tsums, esums, n_shapes


def write_expected(torch, conv, card, path):
    """The port's `suite --check` file from two runs of phase 11's suite
    on this card: the first run's means, the tolerance the larger of 1e-5
    and ten times the largest drift between the two runs."""
    from s2s_ismr_tpu_torch.pipelines import CONFIGS
    runs = []
    with tempfile.TemporaryDirectory() as work:
        for i in range(2):
            t0 = time.perf_counter()
            rc, per, summary, err = run_suite(
                torch, conv, SUITE_ARGV + ["--out", os.path.join(work, str(i))])
            check(rc == 0 and sorted(summary["configs"]) == sorted(CONFIGS),
                  f"suite run {i}: exit {rc}: {err[-2000:]}")
            print(f"  suite run {i + 1}: {time.perf_counter() - t0:.2f} s; "
                  + "; ".join(f"{n} {w:.1f} s" for n, (_, w, _, _)
                              in per.items()))
            runs.append(summary)
    keys = ("elr_rpss_test_mean", "nn_rpss_test_mean")
    a, b = (r["configs"] for r in runs)
    drift = max(abs(a[n][k] - b[n][k]) for n in a for k in keys)
    tol = max(1e-5, 10 * drift)
    doc = {
        "_comment": (
            f"Expectations for `python -m s2s_ismr_tpu_torch.run "
            f"{' '.join(SUITE_ARGV)} --check <this file>` on the card: "
            f"per-config ELR / U-Net test-RPSS means of all eight configs "
            f"with every trial of their grids, cut to 1 fold and 1 epoch. "
            f"Written by `python3 chip_smoke.py --write-expected` on {card} "
            f"(nvidia-smi name, power limit), torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, TF32 off, cuDNN deterministic. Two "
            f"runs drifted by at most {drift!r}; the tolerance is "
            + ("1e-5 (ten times the drift is smaller)" if tol == 1e-5 else
               "ten times that drift")
            + ". Valid only at these settings; other settings, backends "
            f"or devices will not match."),
        "backend": torch.cuda.get_device_name(0),
        "settings": runs[0]["settings"],
        "tolerance": tol,
        "configs": {n: {k: a[n][k] for k in keys} for n in sorted(a)}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"  wrote {path}: largest drift {drift!r}, tolerance {tol!r}")


# phase 13: the sweep at the reference's depth. tune_ECMWF_com (synthetic
# 32x32, T = 349) on its fast grid's 2 trials, but with the published 10
# folds, 100 epochs and patience 15 (the fast variant caps patience at 5);
# (b) batches the first DEPTH_VMAP_FOLDS folds
DEPTH = "tune_ECMWF_com"
DEPTH_VMAP_FOLDS = 4
DEPTH_SEED = 42          # run_unet_sweep's default base_seed
DEPTH_RTOL = 1e-4        # val losses: card vs CPU, 'vmap' vs serial


def depth_config():
    from dataclasses import replace
    from s2s_ismr_tpu_torch.pipelines import get_config
    fast = get_config(DEPTH).fast_variant(n_bootstraps=10, epochs=100)
    return replace(fast, tuning=replace(fast.tuning, patience=15))


def depth_fingerprint(cfg):
    """What phase 13's numbers depend on besides the card: the run's
    settings fingerprint (tune.settings_fingerprint, the winners
    manifest's), the config, its epochs, grid and patience."""
    from s2s_ismr_tpu_torch.pipelines.tune import settings_fingerprint
    from s2s_ismr_tpu_torch.train.sweep import enumerate_trials
    fp = {**settings_fingerprint(cfg, "synthetic", 0, None),
          "config": cfg.name, "epochs": cfg.epochs,
          "patience": cfg.tuning.patience,
          "trials": [t.hparams() for t in enumerate_trials(cfg.tuning)]}
    return json.loads(json.dumps(fp))        # tuples as JSON lists


def depth_expected_path():
    """The port's phase 13 expectations file, shipped with the package."""
    import s2s_ismr_tpu_torch
    return os.path.join(os.path.dirname(s2s_ismr_tpu_torch.__file__),
                        "expected", "depth_rpss_h100.json")


def depth_run(torch, conv, root):
    """run_pipeline of depth_config() on cuda into root, cuDNN
    deterministic, the launch count set to 0 just before and read just
    after, peak device memory by stage; the sweep's arguments kept.
    Returns (TuneOutputs, wall s, launches, peaks, (args, kwargs) of the
    run_unet_sweep call)."""
    from s2s_ismr_tpu_torch.pipelines import tune
    from s2s_ismr_tpu_torch.train.engine import deterministic_cudnn
    calls, real = [], tune.run_unet_sweep

    def recording(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    tune.run_unet_sweep = recording
    try:
        with deterministic_cudnn(), stage_memory(torch) as peaks:
            reset_launches(conv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tune.run_pipeline(depth_config(), out_root=root,
                                    log=lambda s: None, device="cuda")
            torch.cuda.synchronize()
            check_bn_launches("depth run", expected_bn_launches(torch, out))
            seconds = time.perf_counter() - t0
            launches = conv.LAUNCHES
    finally:
        tune.run_unet_sweep = real
    return out, seconds, launches, peaks, calls[0]


def depth_means(root, out):
    """Per-fold U-Net test RPSS means on land of the depth run `out`
    written under root (check_rpss: finite on land, the netcdf equal to
    the run's map)."""
    from s2s_ismr_tpu_torch.pipelines import tune
    cfg = out.config
    land = tune.load_bundles(cfg)[cfg.models[0]].valid_pixels()
    return check_rpss(root, out, land)["unet"]


def depth_summary(out, rpss_means):
    """The numbers phase 13 holds to its expectations file: per fold the
    winner's trial index, every lane's stop epoch and the U-Net test RPSS
    mean on land."""
    sw = out.nn.sweeps[out.config.models[0]]
    return {"fingerprint": depth_fingerprint(out.config),
            "winners": [t.index for t in sw.best_trial],
            "stop_epochs": sw.epochs_table.tolist(),
            "rpss_test": [float(v) for v in rpss_means]}


def check_depth(got, want):
    """Failures (strings; none = pass) of a depth_summary against the
    expectations file's doc: the same fingerprint, winners and stop
    epochs, and each fold's RPSS mean within the file's tolerance."""
    failures = []
    if got["fingerprint"] != want["fingerprint"]:
        failures.append(f"settings {got['fingerprint']} differ from the "
                        f"file's {want['fingerprint']}")
    for key in ("winners", "stop_epochs"):
        if got[key] != want[key]:
            failures.append(f"{key} {got[key]} differ from the file's "
                            f"{want[key]}")
    tol = float(want["tolerance"])
    drift = [abs(a - b) for a, b in zip(got["rpss_test"], want["rpss_test"])]
    if len(drift) != len(want["rpss_test"]) or not all(d <= tol
                                                       for d in drift):
        failures.append(f"rpss_test {got['rpss_test']} vs the file's "
                        f"{want['rpss_test']}: drift {drift} > {tol!r}")
    return failures


def stop_histogram(epochs):
    """'epochs: lanes' of an epochs table, in order of epochs."""
    import numpy as np
    vals, counts = np.unique(np.asarray(epochs), return_counts=True)
    return ", ".join(f"{v}: {c}" for v, c in zip(vals.tolist(),
                                                 counts.tolist()))


def cpu_lane(torch, call, f, t):
    """Lane (fold f, trial t) of the sweep `call` (its run_unet_sweep
    arguments) retrained on the CPU as the sweep builds it: the lane
    generator's init and batch orders, train_fold with the sweep's
    settings. Returns (best val loss, epochs run)."""
    from s2s_ismr_tpu_torch.models import UNet, UNetConfig
    from s2s_ismr_tpu_torch.train import sweep
    from s2s_ismr_tpu_torch.train.engine import train_fold
    (x, y, tm, vm, grid), kw = call
    settings = sweep._settings(kw["epochs"], t.batch_size, grid.patience, vm,
                               True, kw["output"])
    gen = sweep.lane_generator(DEPTH_SEED, f, t.index)
    model = UNet(UNetConfig(filters=t.filters, n_blocks=t.n_blocks,
                            ct_kernel=t.ct_kernel, output=kw["output"]),
                 x.shape[-1], generator=gen, device="cpu")
    _, vloss, hist = train_fold(
        model, torch.as_tensor(x), y[f].cpu(), tm[f], vm[f], t.lr, gen,
        settings, dropout_generator=sweep.lane_generator(
            DEPTH_SEED, f, t.index, "cpu", stream=1))
    return float(vloss), int(torch.isfinite(hist).sum())


def depth_path(torch, conv, card, work):
    """Phase 13: (a) run_pipeline of depth_config() on cuda (20 lanes, each
    stopping on patience 15 or at 100 epochs): launches exact, RPSS finite
    on land, a `load` replay bit-equal, one lane rerun on the CPU, the
    numbers against depth_rpss_h100.json; (b) the first DEPTH_VMAP_FOLDS
    folds' sweep with lane_dispatch='vmap' against (a) lane by lane.
    Returns the launches of both."""
    import numpy as np
    from s2s_ismr_tpu_torch.pipelines import tune
    from s2s_ismr_tpu_torch.train.engine import deterministic_cudnn
    from s2s_ismr_tpu_torch.train.sweep import enumerate_trials, run_unet_sweep

    from s2s_ismr_tpu_torch import programs
    t0 = time.perf_counter()
    root = os.path.join(work, "depth")
    since = dict(programs.STATS)
    out, seconds, launches, peaks, call = depth_run(torch, conv, root)
    cfg = out.config
    sw = out.nn.sweeps[cfg.models[0]]
    F, R = sw.epochs_table.shape
    ep = sw.epochs_table
    check(F == cfg.n_bootstraps and R == 2,
          f"depth run: {F} folds x {R} trials")
    check((ep >= cfg.tuning.patience + 1).all() and (ep <= cfg.epochs).all()
          and (ep < cfg.epochs).any(),
          f"epochs run per lane {ep.tolist()}: no lane stopped early")
    expected, terms = expected_launches(torch, out)
    check(launches == expected,
          f"depth run: launches {launches}, expected {expected} ({terms})")
    check_programs("(a) programs", since, out.nn.epochs_run, F)
    means = depth_means(root, out)
    with open(out.paths["profile"]) as fh:
        stages = json.load(fh)["stages_s"]
    print(f"  (a) run_pipeline, {F} folds x {R} trials, up to {cfg.epochs} "
          f"epochs, patience {cfg.tuning.patience}: wall {seconds:.2f} s "
          f"(data {stages['data']} s, ELR {stages['elr']} s, NN "
          f"{stages['nn']} s); {out.nn.train_steps} lane steps of "
          f"{out.nn.epochs_run} lane epochs = "
          f"{out.nn.train_steps / stages['nn']:.1f} lane steps/s in the NN "
          f"stage on {card}")
    print(f"  epochs run per lane (fold x trial) {ep.tolist()}; "
          f"{int((ep < cfg.epochs).sum())} of {F * R} lanes stopped before "
          f"epoch {cfg.epochs}; histogram (epochs: lanes) "
          f"{stop_histogram(ep)}")
    print(f"  winners per fold {[t.index for t in sw.best_trial]}; kernel "
          f"launches {launches} = expected ({terms}); U-Net test RPSS on "
          f"land per fold {means}")
    print_memory("depth run", peaks, card)

    reset_launches(conv)
    with deterministic_cudnn():
        load = tune.run_pipeline(cfg, out_root=root, log=lambda s: None,
                                 device="cuda", training_type="load")
    check_bn_launches("depth load", 0)
    n_load = conv.LAUNCHES
    want_load, load_terms = expected_launches(torch, load, load=True)
    check(n_load == want_load, f"load: launches {n_load}, expected "
          f"{want_load} ({load_terms})")
    check(torch.equal(load.nn.predictions, out.nn.predictions),
          "the load replay's predictions differ from the depth run's")
    launches += n_load
    print(f"  `load` replay of the written winners: predictions bit-equal, "
          f"launches {n_load} = expected ({load_terms})")

    trials = enumerate_trials(call[0][4])
    f, r = np.unravel_index(np.argmin(ep), ep.shape)
    t1 = time.perf_counter()
    v_cpu, n_cpu = cpu_lane(torch, call, int(f), trials[r])
    v_card = float(sw.val_loss_table[f, r])
    rel = abs(v_cpu / v_card - 1)
    print(f"  lane (fold {f}, trial {r}) retrained on the CPU in "
          f"{time.perf_counter() - t1:.1f} s: {n_cpu} epochs (card "
          f"{int(ep[f, r])}), best val loss {v_cpu!r} (card {v_card!r}, "
          f"relative gap {rel:.2e})")
    check(n_cpu == ep[f, r] and rel <= DEPTH_RTOL,
          f"CPU lane: {n_cpu} epochs, val loss {v_cpu!r}; card "
          f"{int(ep[f, r])}, {v_card!r}")

    path = depth_expected_path()
    check(os.path.exists(path), f"no {path}: write it with `python3 "
          f"chip_smoke.py --write-depth PATH`")
    with open(path) as fh:
        want = json.load(fh)
    failures = check_depth(depth_summary(out, means), want)
    check(not failures, f"against {os.path.relpath(path)}: "
          + "; ".join(failures))
    print(f"  [check] ok against {os.path.relpath(path)} (winners, stop "
          f"epochs; RPSS per fold within {want['tolerance']!r})")
    print(f"  (a) took {time.perf_counter() - t0:.1f} s of phase 13")

    (x, y, tm, vm, grid), kw = call
    k = DEPTH_VMAP_FOLDS
    n_conv = 4 * max(grid.n_blocks) + 2
    reset_launches(conv)
    conv.LANE_LAUNCHES = 0
    since = dict(programs.STATS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with deterministic_cudnn():
        rv = run_unet_sweep(x, y[:k], tm[:k], vm[:k], grid,
                            **{**kw, "lane_dispatch": "vmap"})
    torch.cuda.synchronize()
    check_bn_launches("depth vmap", 0)   # batched lanes: the plain ops
    secs = time.perf_counter() - t1
    bs, be = rv.timings["batched_steps"], rv.timings["batched_epochs"]
    n_lane = conv.LANE_LAUNCHES
    want_lane = bs * (2 * n_conv - 1) + be * n_conv
    check(n_lane == want_lane and conv.LAUNCHES - n_lane == k * n_conv,
          f"vmap: {n_lane} lane-mode launches (expected {want_lane}), "
          f"{conv.LAUNCHES - n_lane} one-lane (expected {k * n_conv})")
    launches += conv.LAUNCHES
    check_programs("(b) programs", since, be, k)
    check(np.array_equal(rv.epochs_table, ep[:k]),
          f"vmap epochs per lane {rv.epochs_table.tolist()} differ from "
          f"serial's {ep[:k].tolist()}")
    check(be == int(ep[:k].max(0).sum()),
          f"vmap ran {be} batched epochs; the buckets' last stops are "
          f"{ep[:k].max(0).tolist()}")
    gap = float(np.abs(rv.val_loss_table / sw.val_loss_table[:k] - 1).max())
    check(gap <= DEPTH_RTOL, f"vmap val losses {rv.val_loss_table.tolist()} "
          f"vs serial {sw.val_loss_table[:k].tolist()}: {gap:.2e}")
    check([t.index for t in rv.best_trial] == [t.index for t in
                                               sw.best_trial[:k]],
          "vmap picks other winners than serial")
    print(f"  (b) lane_dispatch='vmap' on the first {k} folds ({k} lanes a "
          f"bucket): {bs} batched steps, {be} batched epochs (each bucket to "
          f"its last lane's stop, {ep[:k].max(0).tolist()}), "
          f"{rv.train_steps} lane steps in {secs:.2f} s = "
          f"{rv.train_steps / secs:.1f} lane steps/s; stop epochs equal to "
          f"serial's lane by lane, val losses within {gap:.2e} relative, "
          f"the same winners; {n_lane} lane-mode launches = {bs} x "
          f"{2 * n_conv - 1} + {be} x {n_conv}, {k * n_conv} one-lane on "
          f"{card}")
    print(f"  phase 13 wall {time.perf_counter() - t0:.2f} s")
    return launches


def write_depth(torch, conv, card, path):
    """Phase 13's expectations file from two runs of its (a) on this card:
    the first run's winners, stop epochs and RPSS per fold, which the two
    runs must share; the tolerance the larger of 1e-5 and ten times their
    largest RPSS drift."""
    runs = []
    with tempfile.TemporaryDirectory() as work:
        for i in range(2):
            root = os.path.join(work, str(i))
            out, seconds, _, _, _ = depth_run(torch, conv, root)
            runs.append(depth_summary(out, depth_means(root, out)))
            print(f"  depth run {i + 1}: {seconds:.2f} s, epochs per lane "
                  f"{runs[-1]['stop_epochs']}")
    a, b = runs
    check(a["winners"] == b["winners"] and a["stop_epochs"]
          == b["stop_epochs"], f"two runs disagree: {a} / {b}")
    drift = max(abs(u - v) for u, v in zip(a["rpss_test"], b["rpss_test"]))
    tol = max(1e-5, 10 * drift)
    doc = {
        "_comment": (
            f"Expectations for chip_smoke.py phase 13: run_pipeline of "
            f"{DEPTH}'s fast grid (2 trials) at 10 folds, 100 epochs and "
            f"patience 15, synthetic, on the card: per fold the winner's "
            f"trial index and the U-Net test RPSS mean on land, per lane "
            f"(fold x trial) its epochs run. Written by `python3 "
            f"chip_smoke.py --write-depth` on {card} (nvidia-smi name, "
            f"power limit), torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, TF32 off, cuDNN deterministic. Two runs "
            f"drifted by at most {drift!r} in RPSS; the tolerance is "
            + ("1e-5 (ten times the drift is smaller)" if tol == 1e-5 else
               "ten times that drift")
            + "; winners and stop epochs must be equal. Valid only at "
            f"these settings."),
        "backend": torch.cuda.get_device_name(0),
        "tolerance": tol, **a}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
        fh.write("\n")
    print(f"  wrote {path}: largest drift {drift!r}, tolerance {tol!r}")


# phase 15: the port's measurement programs, the counterparts of the JAX
# bench, probes/roofline_r5.py and probes/lane_regime_probe.py, each run as
# a subprocess (a fresh CUDA context: torch.profiler loses device events
# late in this one, and each program loads the kernel library itself), and
# the two legs of probes/flagmatrix_r4.py:45-51 that no earlier phase runs
MEASURE = (("bench", ["s2s_ismr_tpu_torch.bench"]),
           ("roofline", ["s2s_ismr_tpu_torch.probes.roofline"]),
           ("lane_regime", ["s2s_ismr_tpu_torch.probes.lane_regime",
                            "--turns", "1"]))
MEASURE_TIMEOUT = 900
BENCH_VMAP_ATOL = 1e-5   # vmapped against serial-async best val losses
FLAG_LEGS = (("standardize", ["tune_GEFS_com", "--standardize"]),
             ("batch_full", ["tune_IITM_com", "--batch-size", "full"]))
FLAG_CUT = ["--synthetic", "--folds", "1", "--epochs", "1"]


def measure(name, args, card):
    """`python -m args` from the repo's root; prints its output (but its
    long JSON lines) and returns its stdout lines. A non-zero exit
    fails."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=root,
                          capture_output=True, text=True,
                          timeout=MEASURE_TIMEOUT)
    lines = proc.stdout.splitlines()
    for line in lines:
        if len(line) <= 600:
            print(f"  | {line}")
    check(proc.returncode == 0, f"({name}) `python -m {' '.join(args)}` "
          f"exited {proc.returncode}: {proc.stderr[-3000:]}")
    print(f"  ({name}) took {time.perf_counter() - t0:.1f} s on {card}")
    return lines


def bench_run(card):
    """(a): the port's bench at full size. Its last line has the JAX
    bench's four keys; the sequential lanes equal the serial-async ones bit for
    bit, every round of the kernel backend repeats the first, and the
    vmapped lanes lie within BENCH_VMAP_ATOL of the serial-async ones.
    Returns (its conv launches, its report, its last line)."""
    lines = measure("a", MEASURE[0][1], card)
    last = json.loads(lines[-1])
    check(sorted(last) == ["metric", "unit", "value", "vs_baseline"]
          and last["metric"] == "unet_tuning_steps_per_sec_per_chip",
          f"(a) the bench's last line {last}")
    rep = next(json.loads(line)["bench"] for line in lines
               if line.startswith('{"bench"'))
    check(rep["captures_after_warmup"] == 0, f"(a) the bench captured "
          f"{rep['captures_after_warmup']} programs after its warm-up")
    v = rep["variants"]
    for key, var in v.items():
        if key.endswith("/kernel"):
            check(all(r["best_vloss"] == var["best_vloss"]
                      for r in var["rounds"]),
                  f"(a) {key}: a round's best val losses differ from the "
                  f"first round's")
    seq = v["sequential/kernel"]["best_vloss"]
    asy = v["serial-async/kernel"]["best_vloss"]
    vm = v["vmapped/kernel"]["best_vloss"]
    check(seq == asy[:len(seq)], f"(a) sequential {seq} and serial-async "
          f"{asy[:len(seq)]} best val losses differ")
    dv = max(abs(a - b) for a, b in zip(vm, asy))
    check(dv <= BENCH_VMAP_ATOL, f"(a) vmapped best val losses {dv:.3e} "
          f"from serial-async's")
    print(f"  (a) {last['metric']} = {last['value']} {last['unit']}, "
          f"vs_baseline {last['vs_baseline']}; the sequential lanes == "
          f"serial-async bit for bit, every round repeats, vmapped within "
          f"{dv:.2e}; {rep['launches']} conv launches")
    return rep["launches"], rep, last


def roofline_run(card, work):
    """(b): the roofline probe; its conv census per lane step equals
    step_launches(3), and the profiled replay's conv kernel events equal
    the launches its program captured. Returns (its conv launches, its
    report)."""
    path = os.path.join(work, "roofline.json")
    measure("b", MEASURE[1][1] + ["--out", path], card)
    with open(path) as fh:
        rep = json.load(fh)
    cc, ce = rep["conv_census"], rep["census"]
    fwd, dx = step_launches(3)
    got = (sum(cc["fwd"].values()), sum(cc["dx"].values()))
    check(got == (fwd, dx), f"(b) conv census per lane step {got}, "
          f"expected {(fwd, dx)}")
    rp = ce["replay"]
    want = ce["n_steps"] * (fwd + dx) + fwd * ce["val_chunks"]
    check(rp["conv_launches"] == rp["captured_launches"] == want,
          f"(b) the replay's conv events {rp['conv_launches']}, captured "
          f"{rp['captured_launches']}, expected {want}")
    bad = [k for k, us in rep["per_op_us"].items() if us <= 0]
    print(f"  (b) conv census per lane step {got} = step_launches(3); the "
          f"replay's {rp['conv_launches']} conv events = captured = "
          f"expected; per-op us {rep['per_op_us']}, elementwise "
          f"{rep['elementwise_us']:.3f}; conv floor "
          f"{rep['conv_floor_step_us']:.1f} us, serialized "
          f"{rep['serialized_sum_step_us']:.1f} us, measured "
          f"{rep['serial_async_step_us']:.1f} us per step (achieved "
          f"{rep['achieved_fraction_of_conv_floor']:.3f} of the floor)"
          + (f"; K2 - K1 not positive at {bad}" if bad else ""))
    return rep["launches"], rep


def lane_regime_run(card, work):
    """(c): the lane-regime probe; at each workload's full lane count the
    vmapped lanes stop where the serial ones stop, their best val losses
    within DEPTH_RTOL. Returns (its conv launches, its report)."""
    path = os.path.join(work, "lane_regime.json")
    measure("c", MEASURE[2][1] + ["--out", path], card)
    with open(path) as fh:
        rep = json.load(fh)
    for name, res in rep["shapes"].items():
        check(res["stops_equal"] and res["max_dvloss"] <= DEPTH_RTOL,
              f"(c) {name}: vmap against serial: stops equal "
              f"{res['stops_equal']}, max |dvloss| {res['max_dvloss']}")
    print(f"  (c) vmap stops = serial stops at the full lane counts; max "
          f"|dvloss| " + ", ".join(f"{n} {r['max_dvloss']:.2e}"
                                    for n, r in rep["shapes"].items()))
    return rep["launches"], rep


def flag_legs(torch, conv, card, work):
    """(d): the flag-matrix legs no earlier phase runs, through cli_run at
    1 fold and 1 epoch: test RPSS finite on land, launches exact; then the
    kernel against float64 at the full-batch leg's training shapes (batch
    = T), each within the wrapper's N*H*W limit. Returns (launches, max
    abs err)."""
    from dataclasses import replace

    import numpy as np
    from s2s_ismr_tpu_torch.pipelines import get_config, tune
    launches = 0
    for name, argv in FLAG_LEGS:
        d = os.path.join(work, "flags", name)
        out, seconds, n_launch = cli_run(torch, conv,
                                         argv + FLAG_CUT + ["--out", d])
        cfg = out.config
        ys = [b.y for b in tune.load_bundles(cfg).values()]
        land = ~np.isnan(np.mean(ys, 0)).any(0)
        means = check_rpss(d, out, land, {"ELR": out.elr.rpss_test,
                                          "unet": out.nn.rpss_test})
        expected, terms = expected_launches(torch, out)
        check(n_launch == expected, f"(d) {name}: launches {n_launch}, "
              f"expected {expected} ({terms})")
        launches += n_launch
        print(f"  (d) {' '.join(argv + FLAG_CUT)}: exit 0, test RPSS on "
              f"land ELR {means['ELR']}, U-Net {means['unet']}; launches "
              f"{n_launch} = expected ({terms}); wall {seconds:.2f} s on "
              f"{card}")
    cfg = get_config("tune_IITM_com")
    cfg = replace(cfg, tuning=replace(cfg.tuning, batch_sizes=(0,)))
    shapes = bench.config_shapes(torch, cfg)[0]
    big = [s for s in shapes if s[0] * s[1] * s[2] > conv.MAX_PIXELS]
    check(not big, f"(d) full-batch shapes past the kernel's N*H*W limit "
          f"{conv.MAX_PIXELS}: {big}")
    print(f"  (d) the kernel against float64 at the {len(shapes)} "
          f"training shapes of tune_IITM_com --batch-size full (N = T = "
          f"{shapes[0][0]}; N*H*W at most "
          f"{max(s[0] * s[1] * s[2] for s in shapes)})")
    return launches, kernel_vs_plain(torch, conv, shapes)


def measure_path(torch, conv, card, work):
    """Phase 15; returns (launches: per part, max abs err of (d), the
    bench's report and last line, the roofline's report)."""
    t0 = time.perf_counter()
    launches = {}
    launches["bench"], bench_rep, last = bench_run(card)
    launches["roofline"], roof = roofline_run(card, work)
    launches["lane_regime"], _ = lane_regime_run(card, work)
    launches["flags"], max_abs = flag_legs(torch, conv, card, work)
    print(f"  phase 15 wall {time.perf_counter() - t0:.2f} s")
    return launches, max_abs, bench_rep, last, roof


# phase 16: the train-mode BatchNorm kernels (kernels/batchnorm.py)
# (config, n_blocks, filters, side) of the benchmark's U-Nets, and the
# MLP's two BatchNorm widths
BN_UNETS = (("tune_ECMWF_com", 3, 2, 32), ("tune_IITM_full", 5, 3, 64))
MLP_WIDTHS = (2048, 512)
BN_CHAIN = 20           # calls per captured graph when timing
BN_KERNELS = ("bn_train_fwd_kernel", "bn_train_bwd_kernel")
# the side of a config's grid where it is not 32: tune_ECMWF_full's 23x24
# padded to 24x24, tune_IITM_full's native 0.5 degree
GRID_SIDES = {"tune_ECMWF_full": 24, "tune_IITM_full": 64}


def bn_shapes(n_blocks, filters, side, batch=BATCH):
    """The shapes the train-mode BatchNorms of a U-Net (apool, bn) see, in
    forward order: each encoder block's, the bottleneck's, and the decoder's
    but the last (its widths repeat the encoder's)."""
    def width(k):
        return filters * 4 * 2 ** (k - 1)
    down = [(batch, side >> (k - 1), side >> (k - 1), width(k))
            for k in range(1, n_blocks + 1)]
    bott = (batch, side >> n_blocks, side >> n_blocks,
            filters * 4 * 2 ** n_blocks)
    return down + [bott] + down[:0:-1]


def bn_main_shapes():
    """{name: shapes} that phase 16 times: each of BN_UNETS's BatchNorm
    shapes in forward order, and the MLP's (batch, width)."""
    shapes = {name: bn_shapes(nb, f, side)
              for name, nb, f, side in BN_UNETS}
    shapes["mlp"] = [(BATCH, w) for w in MLP_WIDTHS]
    return shapes


def bn_grid():
    """(n_blocks, filters, side, batch) of every U-Net that the eight
    configs' tuning grids train, each once, in the configs' order."""
    import itertools

    from s2s_ismr_tpu_torch.pipelines import CONFIGS
    grid = []
    for name, cfg in CONFIGS.items():
        g = cfg.tuning
        for nb, f, b in itertools.product(g.n_blocks, g.n_filters,
                                          g.batch_sizes):
            t = (nb, f, GRID_SIDES.get(name, 32), b)
            if t not in grid:
                grid.append(t)
    return grid


def bn_check_shapes():
    """The shapes phase 16 checks against float64: bn_main_shapes' and
    every BatchNorm shape of bn_grid's U-Nets, each once, the largest
    first."""
    shapes = {s for ss in bn_main_shapes().values() for s in ss}
    shapes |= {s for nb, f, side, b in bn_grid()
               for s in bn_shapes(nb, f, side, b)}
    return sorted(shapes, key=lambda s: (-math.prod(s), s))


def bn_weights(torch, n, case):
    """Sample weights of a case: 'padded' (the last three rows padding),
    'zero' (a batch of padding only) or 'ones'."""
    if case == "zero":
        return torch.zeros(n)
    w = torch.ones(n)
    if case == "padded":
        w[-3:] = 0.0
    return w


def bn_run(torch, fn, x, w, scale, bias, mean, var, g, dtype):
    """(y, running mean, running var, dx, dscale, dbias) of fn, the
    train-mode forward (batchnorm_train's signature), in `dtype`."""
    xs, ss, bs = (t.detach().to(dtype, copy=True).requires_grad_()
                  for t in (x, scale, bias))
    ms, vs = (t.to(dtype, copy=True) for t in (mean, var))
    y = fn(xs, w.to(dtype), ss, bs, ms, vs)
    dx, ds, db = torch.autograd.grad(y, (xs, ss, bs), g.to(dtype))
    return y.detach(), ms, vs, dx, ds, db


BN_OUTPUTS = ("y", "mean", "var", "dx", "dscale", "dbias")


def bn_errors(torch, shape, case, seed=0, device="cuda"):
    """The kernel path (batchnorm_train on `device`) and the float32 plain
    version against the float64 plain version at `shape` (channel last)
    with weights `case`: ({output: (kernel err, plain err)}, the kernel
    path's outputs, a second run's). Inputs: x ~ 2 N(0, 1) + 0.5, scale in
    [0.5, 1.5], bias, running statistics and g drawn from `seed`."""
    from s2s_ismr_tpu_torch.kernels import batchnorm as bn
    gen = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = 2.0 * torch.randn(shape, generator=gen) + 0.5
    scale = 0.5 + torch.rand(c, generator=gen)
    bias = 0.1 * torch.randn(c, generator=gen)
    mean = 0.1 * torch.randn(c, generator=gen)
    var = 0.5 + torch.rand(c, generator=gen)
    g = torch.randn(shape, generator=gen) / (x.numel() // c) ** 0.5
    args = [t.to(device) for t in (x, bn_weights(torch, shape[0], case),
                                   scale, bias, mean, var, g)]
    want = bn_run(torch, bn.batchnorm_train_plain, *args,
                  torch.float64)
    plain = bn_run(torch, bn.batchnorm_train_plain, *args,
                   torch.float32)
    got = bn_run(torch, bn.batchnorm_train, *args, torch.float32)
    again = bn_run(torch, bn.batchnorm_train, *args, torch.float32)
    errs = {name: (float((k.double() - r).abs().max()),
                   float((p.double() - r).abs().max()))
            for name, k, p, r in zip(BN_OUTPUTS, got, plain, want)}
    return errs, got, again


def bn_check(torch, shapes):
    """(a) of phase 16: bn_errors at every shape, weights padded and zero:
    each output's kernel error at most twice the float32 plain version's,
    a repeat bit-equal. Returns the largest kernel / plain ratio."""
    worst = 0.0
    for shape in shapes:
        for case in ("padded", "zero"):
            errs, got, again = bn_errors(torch, shape, case)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"batchnorm kernel {shape} {case}: a repeat differs")
            for name, (k, p) in errs.items():
                check(k <= 2 * p, f"batchnorm kernel {shape} {case} "
                      f"{name}: error {k:.3e} against float64, above twice "
                      f"the float32 plain version's {p:.3e}")
                worst = max(worst, k / p if p else 0.0)
            print(f"  {shape} {case}: " + ", ".join(
                f"{n} {k:.2e} ({p:.2e})" for n, (k, p) in errs.items()))
    return worst


def chain_us(torch, fn, reps=10):
    """Device time per call of fn in a chain: BN_CHAIN calls captured in
    one CUDA graph (after a warm-up on a side stream), `reps` replays
    between CUDA events, over the calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(BN_CHAIN):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (reps * BN_CHAIN)


def bn_inputs(torch, shape):
    gen = torch.Generator(device="cuda").manual_seed(1)
    c = shape[-1]
    x = torch.randn(shape, device="cuda", generator=gen)
    ones = torch.ones(c, device="cuda")
    return (x, bn_weights(torch, shape[0], "padded").cuda(), ones.clone(),
            torch.zeros(c, device="cuda"), torch.zeros(c, device="cuda"),
            ones.clone(), torch.randn(shape, device="cuda", generator=gen))


def bn_times(torch, shape):
    """(b) of phase 16 at one shape: us per call in a graph chain of the
    kernel and of the plain version, forward and backward (a backward is
    its forward and backward less the forward), and the bound (x read and
    y written, g and x read and dx written, at 3.35 TB/s)."""
    from s2s_ismr_tpu_torch.kernels import batchnorm as bn
    from s2s_ismr_tpu_torch.kernels.conv_bench import PEAK_BYTES
    x, w, scale, bias, mean, var, g = bn_inputs(torch, shape)
    xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))

    def both(fn):
        def run():
            y = fn(xs, w, ss, bs, mean, var)
            torch.autograd.grad(y, (xs, ss, bs), g)
        return run

    def fwd(fn):
        return lambda: fn(x, w, scale, bias, mean, var)

    t = {}
    for name, fn in (("kernel", bn.batchnorm_train),
                     ("plain", bn.batchnorm_train_plain)):
        t[name] = chain_us(torch, fwd(fn))
        t[f"{name}_bwd"] = chain_us(torch, both(fn)) - t[name]
    t["bound"] = 2 * 4 * x.numel() / PEAK_BYTES * 1e6
    t["bound_bwd"] = 3 * 4 * x.numel() / PEAK_BYTES * 1e6
    return t


def batchnorm_path(torch, card):
    """Phase 16: the train-mode BatchNorm kernels at the main path's
    shapes: (a) bn_check at bn_check_shapes(); (b) bn_times at the shapes
    of bn_main_shapes() and summed per model (each U-Net's BatchNorms in
    forward order; a step launches each shape once forward and once
    backward), beside one tiny elementwise op's chain time (the launch
    floor). Returns the sums {model: {key: us}} and the floor."""
    t0 = time.perf_counter()
    checked = bn_check_shapes()
    worst = bn_check(torch, checked)
    print(f"  (a) {len(checked)} shapes (the benchmark's U-Nets, the MLP "
          f"and the {len(bn_grid())} U-Nets of the eight configs' grids) x "
          f"2 weight cases: every output within twice the float32 plain "
          f"version's error (largest ratio {worst:.2f}), repeats bit-equal")
    shapes = bn_main_shapes()
    unique = sorted({s for ss in shapes.values() for s in ss},
                    key=lambda s: -len(s))
    one = torch.zeros(1, device="cuda")
    floor = chain_us(torch, lambda: one.add_(1.0))
    print(f"  (b) us per call in a graph chain of {BN_CHAIN} (on {card}); "
          f"launch floor (a one-element add) {floor:.2f} us")
    per = {}
    for shape in unique:
        t = per[shape] = bn_times(torch, shape)
        print(f"  {shape}: kernel {t['kernel']:.2f} / {t['kernel_bwd']:.2f}, "
              f"plain {t['plain']:.2f} / {t['plain_bwd']:.2f}, bound "
              f"{t['bound']:.3f} / {t['bound_bwd']:.3f}")
    keys = ("kernel", "kernel_bwd", "plain", "plain_bwd", "bound",
            "bound_bwd")
    sums = {name: {k: sum(per[s][k] for s in ss) for k in keys}
            for name, ss in shapes.items()}
    for name, s in sums.items():
        print(f"  {name} ({len(shapes[name])} BatchNorms a step): forward "
              f"kernel {s['kernel']:.2f} us, plain {s['plain']:.2f}, bound "
              f"{s['bound']:.3f}; backward kernel {s['kernel_bwd']:.2f}, "
              f"plain {s['plain_bwd']:.2f}, bound {s['bound_bwd']:.3f}")
    print(f"  phase 16 wall {time.perf_counter() - t0:.2f} s")
    return sums, floor


# phase 17: the stacked predictor's 64x64 epoch (24 members x 437 dates as
# rows, tune_IITM_full's widest trial) in the engine's chunk graphs
CHUNK_MEMBERS, CHUNK_DATES, CHUNK_SIDE = 24, 437, 64
CHUNK_BATCHES = (458, 461)      # real batches of 16 a fold (benchmark)
CHUNK_VAL_ROWS = 2112           # 24 x 88 val dates, the most of a fold
CHUNK_SIZES = (20, 24, 28, 32, 36, 40)   # (a)'s chunks
CHUNK_DROPOUT = (349, 32, 5)    # (c): rows, side, the chunk patched
CHUNK_DEVICE = "cuda"           # "cpu" rehearses the phase (no graphs)


def chunk_data(torch, rows, side, n_batches, val_rows, seed=17):
    """x (rows, side, side, 1), one-hot targets and masks: n_batches real
    batches of 16 (the last ragged), the last val_rows rows val."""
    g = torch.Generator(device=CHUNK_DEVICE).manual_seed(seed)
    x = torch.randn((rows, side, side, 1), generator=g, device=CHUNK_DEVICE)
    cls = torch.randint(0, 3, (rows, side, side), generator=g,
                        device=CHUNK_DEVICE)
    y = torch.nn.functional.one_hot(cls, 3).to(torch.float32)
    train = torch.zeros(rows, dtype=torch.bool)
    train[:16 * n_batches - 5] = True
    val = torch.zeros(rows, dtype=torch.bool)
    val[rows - val_rows:] = True
    return x, y, train, val


def chunk_lane(torch, data, chunk, epochs=2, rate=0.0, blocks=(5, 3),
               uncaptured=False, seed=5):
    """train_fold of one lane with engine.EPOCH_CHUNK = chunk: (best, best
    vloss, hist, Adam count, generator states after, the program, conv
    and BatchNorm launches, wall s)."""
    from s2s_ismr_tpu_torch import programs
    from s2s_ismr_tpu_torch.kernels import batchnorm, conv
    from s2s_ismr_tpu_torch.models import UNet, UNetConfig
    from s2s_ismr_tpu_torch.train import engine
    x, y, train, val = data
    engine.EPOCH_CHUNK = chunk
    cfg = UNetConfig(n_blocks=blocks[0], filters=blocks[1], ct_kernel=(3, 3),
                     dropout_rate=rate)
    g = torch.Generator().manual_seed(seed)
    d = torch.Generator(device=CHUNK_DEVICE).manual_seed(seed + 1)
    model = UNet(cfg, 1, generator=g, device=CHUNK_DEVICE)
    settings = engine.TrainSettings(epochs=epochs, batch_size=16,
                                    patience=2, val_rows=int(val.sum()),
                                    early_exit=True)
    if CHUNK_DEVICE == "cuda":
        torch.cuda.synchronize()
    n0, b0, t0 = conv.LAUNCHES, batchnorm.LAUNCHES, time.perf_counter()
    best, v, h = engine.train_fold(model, x, y, train, val, 1e-3, g,
                                   settings, dropout_generator=d,
                                   _uncaptured=uncaptured)
    if CHUNK_DEVICE == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prog = programs.last()
    return (best, v, h, prog.lane.opt_state[0].clone(), gen_states([g, d]),
            prog, conv.LAUNCHES - n0, batchnorm.LAUNCHES - b0, wall)


def chunk_want(torch, data, epochs, n_blocks=5):
    """(conv, BatchNorm) kernel launches the shapes give for `epochs`
    epochs of one lane: per step step_launches and bn_step_launches, per
    epoch a val forward in row chunks."""
    from s2s_ismr_tpu_torch.train.engine import row_chunk, train_batches
    x, _, train, val = data
    n = train_batches(int(train.sum()), 16)
    chunks = -(-int(val.sum()) // row_chunk(x))
    return (epochs * (n * sum(step_launches(n_blocks))
                      + chunks * (4 * n_blocks + 2)),
            epochs * n * bn_step_launches("unet", n_blocks))


def segment_times(torch, prog, reps=5):
    """Per segment of a captured program: (host ms of its launch on an idle
    device, device ms to its end), medians over `reps`; the step counter
    reset before each so that no chunk reads past the batches."""
    out = []
    for graph, *_ in prog.graphs:
        host, dev = [], []
        for _ in range(reps):
            if hasattr(prog, "offset"):
                prog.offset.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph.replay()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            host.append(1e3 * (t1 - t0))
            dev.append(1e3 * (t2 - t0))
        out.append((sorted(host)[reps // 2], sorted(dev)[reps // 2]))
    return out


def relaunch_times(torch, prog):
    """Host ms of launches queued behind a chunk graph's: the chunk graph
    launched again at once, and the single-step graph after a chunk."""
    chunk, step = prog.graphs[1][0], prog.graphs[2][0]
    out = []
    for second in (chunk, step):
        prog.offset.zero_()
        torch.cuda.synchronize()
        chunk.replay()
        t0 = time.perf_counter()
        second.replay()
        out.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return out


def state_diff(torch, a, b):
    """{name: largest |a - b|} of two state_dicts where they differ."""
    return {k: float((a[k].double() - b[k].double()).abs().max())
            for k in a if not torch.equal(a[k], b[k])}


def epoch_chunks_path(torch, card):
    """Phase 17: (a) the stacked 64x64 epoch at 458 batches under each
    chunk of CHUNK_SIZES: capture seconds and each segment's launch (host
    ms on an idle device, device ms), launches queued behind a chunk, the
    epoch's launches; (b) with cuDNN free (as the sweep trains)
    the whole epoch against itself, printed; with cuDNN deterministic the
    committed chunk against the whole-epoch capture at 458 and 461
    batches, bit for bit; (c) launches of every run of (a) and (b) against
    the shapes' count; (d) a 32x32 lane with dropout, chunked graphs
    against the uncaptured seam, bit for bit (generator states included).
    Returns the numbers."""
    from s2s_ismr_tpu_torch import profiling, programs
    from s2s_ismr_tpu_torch.train import engine
    t_phase = time.perf_counter()
    committed = engine.EPOCH_CHUNK
    rows = CHUNK_MEMBERS * CHUNK_DATES
    out = {"chunk": committed, "sizes": {}}

    def checked(tag, run, data, epochs):
        want = chunk_want(torch, data, epochs)
        check(run[6] == want[0], f"{tag}: {run[6]} conv launches, the "
              f"shapes give {want[0]}")
        check(run[7] == want[1], f"{tag}: {run[7]} BatchNorm launches, the "
              f"shapes give {want[1]}")

    data = chunk_data(torch, rows, CHUNK_SIDE, CHUNK_BATCHES[0],
                      CHUNK_VAL_ROWS)
    print(f"  (a) x {tuple(data[0].shape)}, {CHUNK_BATCHES[0]} batches of "
          f"16, {CHUNK_VAL_ROWS} val rows, n_blocks 5 filters 3 (on {card})")
    for k in CHUNK_SIZES:
        programs._program_memo.clear()
        s0 = dict(programs.STATS)
        with profiling.call("phase17") as rec:
            run = chunk_lane(torch, data, k)
        checked(f"chunk {k}", run, data, 2)
        sp = rec.as_dict()["spans"]
        prog = run[5]
        segs = segment_times(torch, prog) if prog.graphs else []
        again = relaunch_times(torch, prog) if prog.graphs else []
        row = {"capture_s": programs.STATS["capture_s"] - s0["capture_s"],
               "build_s": programs.STATS["build_s"] - s0["build_s"],
               "captured_steps": (programs.STATS["captured_steps"]
                                  - s0["captured_steps"]),
               "launches_per_epoch": len(prog.schedule()),
               "train_replay_ms": 1e3 * sp["programs.train_replay"]["total_s"]
               / sp["programs.train_replay"]["count"],
               "segments_host_ms": [s[0] for s in segs],
               "segments_device_ms": [s[1] for s in segs],
               "behind_chunk_host_ms": again, "wall_s": run[8]}
        out["sizes"][k] = row
        print(f"  chunk {k}: capture {row['capture_s']:.2f} s (build "
              f"{row['build_s']:.2f}), {row['captured_steps']} steps "
              f"captured; {row['launches_per_epoch']} launches an epoch, "
              f"train_replay "
              f"{row['train_replay_ms']:.2f} ms; segments host ms "
              f"{[round(v, 3) for v in row['segments_host_ms']]}, device ms "
              f"{[round(v, 3) for v in row['segments_device_ms']]}; behind "
              f"a chunk, the chunk again / a step {[round(v, 3) for v in again]}"
              f" host ms; 2 epochs in {run[8]:.2f} s")
        del run, prog

    # cuDNN free, as the sweep trains: does the whole epoch repeat itself?
    programs._program_memo.clear()
    d = chunk_data(torch, rows, CHUNK_SIDE, CHUNK_BATCHES[0], CHUNK_VAL_ROWS)
    free = [chunk_lane(torch, d, 10 ** 6) for _ in range(2)]
    diff = state_diff(torch, free[0][0], free[1][0])
    out["free_repeat_differs"] = len(diff)
    out["free_repeat_max_abs"] = max(diff.values(), default=0.0)
    print(f"  (b) cuDNN free: the whole epoch against itself, "
          f"{len(diff)} state tensors differ (largest |diff| "
          f"{out['free_repeat_max_abs']:.3e}), val losses "
          f"{'equal' if torch.equal(free[0][2], free[1][2]) else 'differ'}")
    del free, d
    for n in CHUNK_BATCHES:
        programs._program_memo.clear()
        d = chunk_data(torch, rows, CHUNK_SIDE, n, CHUNK_VAL_ROWS)
        s0 = programs.STATS["capture_s"]
        with engine.deterministic_cudnn():
            whole = chunk_lane(torch, d, 10 ** 6)
        whole_s = programs.STATS["capture_s"] - s0
        checked(f"whole {n}", whole, d, 2)
        programs._program_memo.clear()
        with engine.deterministic_cudnn():
            chunked = chunk_lane(torch, d, committed)
        checked(f"chunked {n}", chunked, d, 2)
        check(isinstance(chunked[5], engine._ChunkedFoldProgram)
              and not isinstance(whole[5], engine._ChunkedFoldProgram),
              "the programs are not the chunked and the whole one")
        diff = same_run(torch, chunked[:5], whole[:5])
        check(not diff, f"(b) {n} batches: chunk {committed} against the "
              f"whole epoch differs in {diff}: "
              f"{state_diff(torch, chunked[0], whole[0])}")
        out[f"whole_{n}_capture_s"] = whole_s
        out[f"whole_{n}_wall_s"] = whole[8]
        out[f"chunked_{n}_wall_s"] = chunked[8]
        print(f"  (b) {n} batches, cuDNN deterministic: chunk {committed} "
              f"bit-equal to the whole epoch (capture {whole_s:.2f} s; 2 "
              f"epochs {whole[8]:.2f} s "
              f"whole, {chunked[8]:.2f} s chunked); launches exact")
        del whole, chunked, d
    del data
    programs._program_memo.clear()

    n_rows, side, k = CHUNK_DROPOUT
    d = chunk_data(torch, n_rows, side, 17, 64, seed=3)
    with engine.deterministic_cudnn():
        a = chunk_lane(torch, d, k, epochs=3, rate=0.2, blocks=(3, 2))
        b = chunk_lane(torch, d, k, epochs=3, rate=0.2, blocks=(3, 2),
                       uncaptured=True)
    diff = same_run(torch, a[:5], b[:5])
    check(not diff, f"(d) dropout lane, chunk {k}: graphs against the seam "
          f"differ in {diff}")
    check(a[6] == b[6] == chunk_want(torch, d, 3, 3)[0],
          f"(d) conv launches {a[6]} / {b[6]}")
    print(f"  (d) {side}x{side}, dropout 0.2, 17 batches in chunks of {k}: "
          f"graphs bit-equal to the uncaptured seam, generator states "
          f"included")
    programs._program_memo.clear()
    engine.EPOCH_CHUNK = committed
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  phase 17 wall {out['wall_s']:.2f} s")
    return out


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


def check_sass(conv, build, path):
    """Phase 2: the built library's SASS (cuobjdump -sass from the
    toolkit) holds the halo tiles' wgmma (HGMMA) and TMA loads (UTMALDG),
    and the split tiles' cluster barriers; prints how many kernels hold
    each."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=600)
    check(out.returncode == 0, f"cuobjdump -sass failed: {out.stderr[-400:]}")
    kernels = out.stdout.split("Function : ")[1:]
    want = {"UTMALDG": conv.HALO in {t[0] for t in conv.TILES}
            or conv.HALO_MMA in {t[0] for t in conv.TILES},
            "HGMMA": conv.HALO in {t[0] for t in conv.TILES},
            "UCGABAR": False}         # printed, not required
    found = {op: sum(op in k for k in kernels) for op in want}
    print(f"  SASS: {len(kernels)} kernels; holding HGMMA "
          f"{found['HGMMA']}, UTMALDG {found['UTMALDG']}, cluster barrier "
          f"(UCGABAR) {found['UCGABAR']}")
    for op, needed in want.items():
        check(not needed or found[op] > 0,
              f"the library's SASS holds no {op} instruction")


def timed_shapes(torch, device="cuda"):
    """The shapes phases 3, 10, 11 and 12 time, each once: [(shape, act,
    modes)] (phase 10's are phase 3's; phase 12's eval shapes forward
    only)."""
    out = {}

    def add(shapes, act, modes=("fwd", "dx")):
        for s in shapes:
            have = out.setdefault((tuple(s), act), [])
            have += [m for m in modes if m not in have]
    add(bench.slice_shapes(torch, (2, 3), BATCH, device), "elu")
    add(CNN_SHAPES, "none")
    add(MULTI_SHAPES, "elu")
    add(bench.slice_shapes(torch, (2,), RT_ROWS, device), "elu")
    add([(RT_ROWS,) + s[1:] for s in CNN_SHAPES], "none")
    for cfg in suite_configs():
        add(bench.config_shapes(torch, cfg, device)[0], "elu")
    first, multi, stacked = member_shapes(torch, device)
    add(first, "elu")
    add(multi + stacked, "elu", ("fwd",))
    return [(s, a, tuple(m)) for (s, a), m in out.items()]


def main(argv=None):
    global bench
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write-expected", metavar="PATH", default=None,
                    help="only run phase 11's suite twice and write the "
                         "port's suite --check file to PATH")
    ap.add_argument("--shapes-json", metavar="PATH", default=None,
                    help="only write the shapes phases 3, 10, 11 and 12 "
                         "time (for `conv_bench tiles --shapes`) to PATH")
    ap.add_argument("--write-depth", metavar="PATH", default=None,
                    help="only run phase 13's (a) twice and write its "
                         "expectations file to PATH")
    ap.add_argument("--batchnorm", action="store_true",
                    help="only run phase 16 (the BatchNorm kernels)")
    ap.add_argument("--epoch-chunks", action="store_true",
                    help="only run phase 17 (the stacked 64x64 epoch in "
                         "the engine's chunk graphs)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from s2s_ismr_tpu_torch.kernels import _build, batchnorm, conv
    from s2s_ismr_tpu_torch.kernels import conv_bench as bench

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        print("[1/16] device")
        card = card_line()
        print(f"  {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
              f"torch {torch.__version__} cuda {torch.version.cuda}")

        print("[2/16] build")
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
        check_sass(conv, _build, info["path"])
        if args.shapes_json:
            shapes = timed_shapes(torch)
            with open(args.shapes_json, "w") as fh:
                json.dump([{"shape": s, "act": a, "modes": m}
                           for s, a, m in shapes], fh)
            print(f"  wrote the {len(shapes)} shapes phases 3, 10, 11 and "
                  f"12 time to {args.shapes_json}")
            return 0
        if args.write_expected:
            print(f"[11/16] (b) only: the suite twice -> "
                  f"{args.write_expected}")
            write_expected(torch, conv, card, args.write_expected)
            return 0
        if args.write_depth:
            print(f"[13/16] (a) only: the depth run twice -> "
                  f"{args.write_depth}")
            write_depth(torch, conv, card, args.write_depth)
            return 0
        if args.batchnorm:
            print("[16/16] only: the train-mode BatchNorm kernels")
            batchnorm_path(torch, card)
            return 0
        if args.epoch_chunks:
            print("[17] only: the stacked predictor's 64x64 epoch in the "
                  "engine's chunk graphs")
            nums = epoch_chunks_path(torch, card)
            print(card)
            print(json.dumps({"epoch_chunks": nums}))
            return 0

        print("[3/16] kernel vs plain (TF32 off), batch 16")
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
            sums, _ = kernel_times(torch, conv, group, act, phase="3")
            print_sums(name, len(group), sums)
            for mode, s in sums.items():
                for key, v in s.items():
                    times[mode][key] = times[mode].get(key, 0.0) + v
        print(f"  max abs err {max_abs:.3e}")

        print("[16/16] the train-mode BatchNorm kernels against float64 and "
              "timed at the main path's shapes")
        bn_sums, bn_floor = batchnorm_path(torch, card)

        print("[4/16] main path: tune_ECMWF_com NN branch, fast variant")
        launches, main_abs = main_path(torch, conv, card)
        max_abs = max(max_abs, main_abs)

        with tempfile.TemporaryDirectory() as work:
            unet_root = os.path.join(work, "tune")
            print("[5/16] main path: `python -m s2s_ismr_tpu_torch.run "
                  "tune_ECMWF_com --synthetic --fast` in-process on cuda")
            launches += pipeline_path(torch, conv, card, unet_root)

            print("[6/16] the other run modes of tune_ECMWF_com (fast "
                  "variant) in-process on cuda")
            modes_launches, modes_abs = modes_path(torch, conv, card,
                                                   os.path.join(work, "modes"))
            launches += modes_launches
            max_abs = max(max_abs, modes_abs)

            print("[7/16] ELR branch of the full tune_ECMWF_com and tune_2MME "
                  "(10 folds), cuda vs CPU")
            elr = elr_cuda_vs_cpu(torch)

            print("[8/16] realtime path on cuda: the CLI's `realtime` on "
                  "phase 5's winners, the cnn's of phase 6, and the "
                  "operational forecast on a fake cache")
            launches += realtime_path(
                torch, conv, card, unet_root,
                os.path.join(work, "modes", "cnn"), work)

            print("[9/16] reporting and profiler traces on cuda: the CLI's "
                  "`accs`, REL/BSS/RES and CC/ACC against float64, RPSS "
                  "records, and a traced fast tune run")
            launches += reporting_path(torch, conv, card, unet_root, elr,
                                       work)

            print("[10/16] batched lanes (the conv kernel's lane mode, "
                  "lane_dispatch='vmap'), the one-card mesh and bf16 on cuda")
            t10 = time.perf_counter()
            lanes_n, lanes_abs, lane_times, lane_launches, idle = \
                lanes_path(torch, conv, card, work)
            launches += lanes_n
            max_abs = max(max_abs, lanes_abs)
            print(f"  phase 10 wall {time.perf_counter() - t10:.2f} s")

            # phase 12 runs inside phase 11, before its suite: after the
            # suite's millions of launches torch.profiler loses device
            # events, and phase 12 (a) times with it
            print("[11/16] (a) the eight configs' tuning grids at full width "
                  "on cuda: the kernel at every grid conv shape")
            t11 = time.perf_counter()
            grid_abs, grid_times, n_train, n_eval = grid_kernels(torch, conv,
                                                                 card)
            max_abs = max(max_abs, grid_abs)
            t11 = time.perf_counter() - t11
            print(f"  (a) took {t11:.1f} s")

            print("[12/16] IITM's 24 members at 64x64 on cuda: the kernel at "
                  "the multi_predictor and stacked shapes, tune_IITM_full "
                  "--predictor multi_predictor at its full grid, --predictor "
                  "stacked train then load; and the weeks: `suite --week "
                  "wk1,wk2`, --resume, a wk1 load and a week mismatch")
            t12 = time.perf_counter()
            (iitm_launches, iitm_abs, iitm_train, iitm_eval,
             n_iitm) = members_weeks_path(torch, conv, card, work)
            launches += iitm_launches
            max_abs = max(max_abs, iitm_abs)
            print(f"  phase 12 wall {time.perf_counter() - t12:.2f} s")

            # phase 14 times with torch.profiler: before the suite too
            print("[14/16] the engine's programs: each lane's epoch and each "
                  "eval forward a memoized CUDA graph, against the "
                  "uncaptured seam")
            prog_nums = programs_path(torch, conv, card)

            print("[11/16] (b) the CLI's `suite --folds 1 --epochs 1 --check` "
                  "of the eight configs at full width on cuda")
            t11b = time.perf_counter()
            suite_launches = suite_path(torch, conv, card, work)
            launches += suite_launches
            print(f"  phase 11 wall {t11 + time.perf_counter() - t11b:.2f} s")

            # last: after its millions of launches nothing is timed
            print("[13/16] the sweep at the reference's depth on cuda: "
                  "tune_ECMWF_com's fast grid at 10 folds, 100 epochs and "
                  "patience 15, serial then 'vmap'")
            depth_launches = depth_path(torch, conv, card, work)
            launches += depth_launches

            print("[15/16] the port's measurement programs on cuda, each a "
                  "subprocess: the bench's three execution models, the "
                  "roofline and the lane regime; and the flag-matrix legs "
                  "--standardize and --batch-size full")
            (measure_launches, flags_abs, bench_rep, bench_last,
             roof) = measure_path(torch, conv, card, work)
            launches += sum(measure_launches.values())
            max_abs = max(max_abs, flags_abs)
        check("jax" not in sys.modules, "jax was imported")
        jax_pkg = [m for m in sys.modules
                   if m == "s2s_ismr_tpu" or m.startswith("s2s_ismr_tpu.")]
        check(not jax_pkg, f"modules of the JAX package were loaded: "
              f"{jax_pkg}")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s")
    from s2s_ismr_tpu_torch import programs
    memo = {"captures": programs.STATS["captures"],
            "capture_s": programs.STATS["capture_s"],
            "build_s": programs.STATS["build_s"],
            "epoch_replays": programs.STATS["train_replays"],
            "forward_replays": programs.STATS["predict_replays"],
            "warmup_launches": conv.WARMUP_LAUNCHES,
            "memo_entries": len(programs._program_memo),
            "pool_bytes": pool_bytes(torch),
            **{f"programs_{k}": v for k, v in prog_nums.items()}}
    fwd, dx = times["fwd"], times["dx"]
    lanes = {}
    for n_lanes, tag in zip(LANES, ("lanes", "lanes20")):
        for mode, prefix in (("fwd", tag), ("dx", f"{tag}_dx")):
            t = lane_times[n_lanes][mode]
            lanes.update({f"{prefix}_ms": t["ms"],
                          f"{prefix}_serial_ms": t["serial_ms"],
                          f"{prefix}_library_ms": t["library_ms"],
                          f"{prefix}_bound_ms": t["bound_ms"]})
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
        "dx_bound_3xtf32_ms": dx["bound_3xtf32_ms"],
        "lanes_L": LANES[0], "lanes20_L": LANES[1], **lanes,
        "lanes_launches": lane_launches,
        "lanes_idle_share": idle["vmap"],
        "serial_idle_share": idle["serial"],
        "grids_shapes": n_train, "grids_eval_shapes": n_eval,
        **{f"grids_{prefix}{key}": grid_times[mode][key]
           for mode, prefix in (("fwd", ""), ("dx", "dx_"))
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "suite_launches": suite_launches,
        "iitm_shapes": n_iitm,
        **{f"iitm_{prefix}{key}": sums[mode][key]
           for prefix, sums, mode in (("", iitm_eval, "fwd"),
                                      ("first_", iitm_train, "fwd"),
                                      ("first_dx_", iitm_train, "dx"))
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "iitm_launches": iitm_launches,
        "depth_launches": depth_launches,
        **{f"{k}_launches": v for k, v in measure_launches.items()},
        "bench_value": bench_last["value"],
        "bench_vs_baseline": bench_last["vs_baseline"],
        **{f"bench_{k.replace('/', '_').replace('-', '_')}_steps_per_s":
           v["steps_per_s"] for k, v in bench_rep["variants"].items()},
        "roofline_per_op_us": roof["per_op_us"],
        "roofline_elementwise_us": roof["elementwise_us"],
        **memo,
        "families": FAMILY_COUNTS}, {
        "name": "batchnorm_train", "route": "cuda",
        "source": "s2s_ismr_tpu_torch/csrc/batchnorm.cu", "replaces": None,
        "launches": sum(BN_RUNS.values()), "runs_checked": len(BN_RUNS),
        "warmup_launches": batchnorm.WARMUP_LAUNCHES,
        "launch_floor_us": bn_floor,
        **{f"{model}_{key}_us": v for model, sums in bn_sums.items()
           for key, v in sums.items()}}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

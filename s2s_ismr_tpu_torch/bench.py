"""Benchmark: U-Net hindcast tuning throughput on the card (port of the
repo's bench.py: the same workload, the same three execution models, the
same last line).

    python -m s2s_ismr_tpu_torch.bench [--fast] [--cpu] [--rounds N]
        [--lanes L] [--epochs E] [--grid H W]

Workload (bench.py:52-77, `build_workload`): the synthetic tune_ECMWF_com
record on 32x32, years 2003-2018 (T = 349), 10 bootstrap folds and 20
fold-major lanes (lane i trains fold i % 10 at lr 1e-3 or 1e-4,
alternating), the U-Net of filters 2, n_blocks 3, ct_kernel 3x3, batch 16,
10 epochs at patience = epochs, so no lane stops early. `--fast` (or
BENCH_FAST=1, as bench.py reads it) cuts it to 2003-2012, 2 folds, 4 lanes
and 3 epochs; `--lanes`, `--epochs` and `--grid` cut it further (a CPU
run at a tiny size). Each lane draws its init and batch orders from a
generator of its own (`sweep.lane_generator`).

Execution models (bench.py:79-103):
  sequential    one lane at a time through engine.train_fold, synchronized
                after each, over min(4, lanes) lanes: the reference's
                Keras model.fit per trial;
  serial-async  every lane's train_fold back to back, one synchronize at the
                end: run_unet_sweep(lane_dispatch='serial'), the shipped
                model (each train_fold still waits on the host for its
                training-row count and its batch orders; the syncs are
                counted and printed);
  vmapped       every lane in one engine.train_lanes call: the kernel's
                lane mode inside one batched program per epoch;
each with the U-Net's conv_backend 'kernel' (the hand-written conv, the
default) and 'torch' (cuDNN). TF32 is off and cuDNN deterministic, as in
the port's float32 checks, so the sequential and serial-async lanes are
bit-equal.

Every mode is warmed before it is timed: train_fold's programs are keyed
by the lane's training batches (engine.fold_key), which may differ
between folds, so a warm-up runs one epoch of every lane a mode times;
its builds are printed apart, and the captures after it counted (none is
expected). The modes then run in turns, `--rounds` rounds (the order
reversed every other round), and each prints its median and spread:
host-clock rates have moved 2x between calls of the same code. Steps are
the optimizer steps the port runs, epochs x train_batches(n_train, 16)
per lane (SweepResult.train_steps counts them so); bench.py counts every
batch of its scan, epochs x ceil(T / 16), which the unit names beside
them.

Before the last line, per mode and backend: lane-epochs/s and steps/s
per round with their median and spread; programs built and seconds
building; conv kernel launches per lane step; host syncs per lane
(torch.cuda.set_sync_debug_mode('warn'), one run of each mode with the
kernel backend, the serial modes over min(4, lanes) lanes; by call
site); from one profiled serial-async run of the first min(2, lanes)
lanes, the device's idle share and device ops per lane step; the card's
name and power limit beside every time; and one JSON line {"bench": ...}
with all of it and each run's best val losses. The last line holds
bench.py's four keys: metric, value (serial-async steps/s, the kernel
backend), unit and vs_baseline (serial-async over sequential).

Without a card the bench raises unless `--cpu` is given; a CPU run
measures the CPU's plain versions and names the device "cpu".
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import statistics
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from . import device as devices
from . import programs, timeutils
from .data import synthetic
from .kernels import conv
from .models import UNet, UNetConfig
from .ops import terciles
from .train import splits
from .train.engine import (TrainSettings, deterministic_cudnn,
                           train_batches, train_fold, train_lanes)
from .train.sweep import lane_generator

METRIC = "unet_tuning_steps_per_sec_per_chip"
MODES = ("sequential", "serial-async", "vmapped")
BACKENDS = ("kernel", "torch")
BATCH = 16
SEQ_LANES = 4        # bench.py:82, the sequential mode's lanes
PROFILE_LANES = 2    # lanes of the profiled serial-async run: a replayed
# lane step is ~600 device events, and the whole sweep's would be millions
FULL = dict(years=(2003, 2018), folds=10, lanes=20, epochs=10)
FAST = dict(years=(2003, 2012), folds=2, lanes=4, epochs=3)


@dataclass
class Workload:
    """bench.py's inputs, lane-major: lane i trains fold fold_idx[i] at
    learning rate lrs[i]."""
    x: torch.Tensor              # (T, H, W, 1) ensemble-mean images
    y: torch.Tensor              # (lanes, T, H, W, 3) one-hot, NaN -> 0
    train: np.ndarray            # (lanes, T) bool
    val: np.ndarray              # (lanes, T) bool
    lrs: np.ndarray              # (lanes,) float32
    fold_idx: np.ndarray         # (lanes,)
    val_rows: int                # the most val rows of any fold
    n_blocks: int
    seed: int

    @property
    def lanes(self):
        return len(self.lrs)

    def config(self, backend="kernel"):
        return UNetConfig(filters=2, n_blocks=self.n_blocks,
                          ct_kernel=(3, 3), conv_backend=backend)

    def settings(self, epochs, patience=None, early_exit=False):
        return TrainSettings(epochs=epochs, batch_size=BATCH,
                             patience=epochs if patience is None else patience,
                             val_rows=self.val_rows, early_exit=early_exit)

    def generator(self, i):
        """Lane i's generator, fresh: its init, then its batch orders."""
        return lane_generator(self.seed, int(self.fold_idx[i]), i)

    def model(self, gen, backend="kernel"):
        return UNet(self.config(backend), self.x.shape[-1], generator=gen,
                    device=self.x.device)

    def lane_steps(self, i, epochs):
        """Optimizer steps lane i runs in `epochs` epochs."""
        return epochs * train_batches(int(self.train[i].sum()), BATCH)


def build_workload(grid_shape, years, n_blocks, folds=10, lanes=20, seed=0,
                   device=None) -> Workload:
    """bench.py's workload (probes/lane_regime_probe.py:34-60) on `device`
    (None: the card): a synthetic hindcast on grid_shape, its bootstrap
    folds, each fold's rolling tercile labels one-hot, and the lanes
    fold-major over alternating learning rates."""
    device = devices.resolve(device)
    b = synthetic.synthetic_hindcast(years=years, seed=seed,
                                     grid_shape=grid_shape).fillna(0.0)
    fm = splits.bootstrap_masks(b.years, n_bootstraps=folds)
    wm = timeutils.week_window_matrix(1)
    y = torch.as_tensor(b.y, device=device)
    labels = torch.stack([terciles.fit_and_label(y, b.weeks, fm.train[f], wm,
                                                 None)[0]
                          for f in range(folds)])
    y_oh = torch.nan_to_num(terciles.one_hot_labels(labels), nan=0.0)
    x = torch.as_tensor(b.ensemble_mean()[..., None], device=device)
    lrs = np.tile([1e-3, 1e-4], lanes // 2 + 1)[:lanes].astype(np.float32)
    fold_idx = np.arange(lanes) % folds
    return Workload(x, y_oh[torch.as_tensor(fold_idx, device=device)],
                    fm.train[fold_idx], fm.val[fold_idx], lrs, fold_idx,
                    int(fm.val.sum(1).max()), n_blocks, seed)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class Run:
    """One run of a mode: its host seconds (ending in a synchronize), each
    lane's best val loss and epochs run, and the optimizer steps run."""
    seconds: float
    best_vloss: list
    epochs: list
    lane_steps: int
    batched_epochs: int = 0      # vmapped: epochs of the batched loop

    @property
    def steps_per_s(self):
        return self.lane_steps / self.seconds

    @property
    def lane_epochs_per_s(self):
        return sum(self.epochs) / self.seconds


def run_mode(wl: Workload, mode, settings, backend="kernel", lanes=None):
    """One timed run of `mode` over the first `lanes` lanes (default: the
    sequential mode's min(4, lanes), the others' all)."""
    dev = wl.x.device
    n = lanes or (min(SEQ_LANES, wl.lanes) if mode == "sequential"
                  else wl.lanes)
    _sync(dev)
    t0 = time.perf_counter()
    if mode == "vmapped":
        gens = [wl.generator(i) for i in range(n)]
        res = train_lanes([wl.model(g, backend) for g in gens], wl.x,
                          wl.y[:n], wl.train[:n], wl.val[:n],
                          wl.lrs[:n].tolist(), gens, settings)
        _sync(dev)
        seconds = time.perf_counter() - t0
        vloss, hist, batched = res.best_vloss, res.hist, res.batched_epochs
    elif mode in ("sequential", "serial-async"):
        out = []
        for i in range(n):
            g = wl.generator(i)
            out.append(train_fold(wl.model(g, backend), wl.x, wl.y[i],
                                  wl.train[i], wl.val[i], float(wl.lrs[i]),
                                  g, settings))
            if mode == "sequential":
                _sync(dev)
        _sync(dev)
        seconds = time.perf_counter() - t0
        vloss = torch.stack([o[1] for o in out])
        hist = torch.stack([o[2] for o in out])
        batched = 0
    else:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    epochs = torch.isfinite(hist).sum(1).tolist()
    return Run(seconds, vloss.tolist(), epochs,
               sum(wl.lane_steps(i, e) for i, e in enumerate(epochs)),
               batched)


def count_syncs(fn):
    """(fn's result, host syncs, {call site: syncs}) of one call of fn
    under torch.cuda.set_sync_debug_mode('warn'): every synchronizing CUDA
    call warns, and the warning names the Python line that made it."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    sites = collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in syncs)
    return out, len(syncs), dict(sites.most_common())


def device_profile(fn):
    """(fn's result, wall s, device events) of one call of fn under
    torch.profiler, CUDA activity only."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return out, wall, events


def median_spread(values):
    """(median, spread): the spread is (max - min) / median."""
    med = statistics.median(values)
    return med, (max(values) - min(values)) / med


def load_kernels(dev, log=print):
    """On the card: build (or load the cached build of) the kernel library
    before anything is timed, and say which."""
    if dev.type != "cuda":
        return
    from .kernels import _build
    info = _build.build()
    _build.library()
    how = (f"built in {info['seconds']:.1f} s" if info["seconds"]
           else "cached")
    log(f"kernel library {os.path.relpath(info['path'])}: {how}")


def card_label(dev):
    """What every time is printed beside: nvidia-smi's name and power
    limit on the card; 'cpu' for a CPU run."""
    return devices.card_line() if dev.type == "cuda" else "cpu"


def run_bench(wl: Workload, epochs, rounds, backends=BACKENDS, log=print):
    """Warm every mode and backend, count the kernel backend's syncs, time
    the modes in turns over `rounds` rounds, and profile one serial-async
    run; returns the report ({"bench": ...}'s value)."""
    dev = wl.x.device
    card = card_label(dev)
    settings = wl.settings(epochs)
    variants = [(m, b) for b in backends for m in MODES]
    rep = {"card": card, "device": (torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu"),
           "lanes": wl.lanes, "epochs": epochs, "T": int(wl.x.shape[0]),
           "grid": list(wl.x.shape[1:3]), "rounds": rounds,
           "nominal_steps_per_lane": epochs * math.ceil(wl.x.shape[0] / BATCH),
           "variants": {}}
    # the warm-up: one epoch of every lane builds every program a timed run
    # replays (a program's key holds no epoch count, and no lane stops early)
    warm = dataclasses.replace(settings, epochs=1)
    for mode, backend in variants:
        since = dict(programs.STATS)
        run = run_mode(wl, mode, warm, backend)
        s = {k: programs.STATS[k] - since[k] for k in since}
        rep["variants"][f"{mode}/{backend}"] = v = {
            "builds": s["misses"], "captures": s["captures"],
            "build_s": s["build_s"], "warm_s": run.seconds,
            "lanes": len(run.epochs), "rounds": []}
        log(f"bench: warm {mode} [{backend}]: {v['lanes']} lanes x 1 epoch "
            f"in {run.seconds:.3f} s; {s['misses']} programs built "
            f"({s['captures']} captured) in {s['build_s']:.3f} s on {card}")
    since = dict(programs.STATS)
    if dev.type == "cuda":
        rep["syncs_per_lane"], rep["sync_sites"] = {}, {}
        for mode in MODES:
            # a serial lane makes the same syncs in either serial mode
            n_lanes = min(SEQ_LANES, wl.lanes) if mode != "vmapped" else None
            run, n, sites = count_syncs(
                lambda: run_mode(wl, mode, settings, "kernel", n_lanes))
            lanes = len(run.epochs)
            rep["syncs_per_lane"][mode] = n / lanes
            rep["sync_sites"][mode] = sites
            log(f"bench: host syncs {mode} [kernel]: {n} over {lanes} lanes "
                f"({n / lanes:.2f} per lane); by site: "
                + ", ".join(f"{k} x{c}" for k, c in sites.items()))
    for r in range(rounds):
        for mode, backend in (variants if r % 2 == 0 else variants[::-1]):
            before = conv.LAUNCHES
            run = run_mode(wl, mode, settings, backend)
            rep["variants"][f"{mode}/{backend}"]["rounds"].append({
                "seconds": run.seconds, "steps_per_s": run.steps_per_s,
                "lane_epochs_per_s": run.lane_epochs_per_s,
                "launches": conv.LAUNCHES - before,
                "best_vloss": run.best_vloss, "epochs": run.epochs,
                "lane_steps": run.lane_steps})
    rep["captures_after_warmup"] = programs.STATS["captures"] - \
        since["captures"]
    log(f"bench: captures after the warm-up: "
        f"{rep['captures_after_warmup']}")
    for mode, backend in variants:
        v = rep["variants"][f"{mode}/{backend}"]
        rs = v["rounds"]
        v["lane_steps"] = rs[0]["lane_steps"]
        v["steps_per_s"], v["spread"] = median_spread(
            [r["steps_per_s"] for r in rs])
        v["lane_epochs_per_s"], _ = median_spread(
            [r["lane_epochs_per_s"] for r in rs])
        v["launches_per_step"] = rs[0]["launches"] / rs[0]["lane_steps"]
        v["best_vloss"] = rs[0]["best_vloss"]
        log(f"bench: {mode} [{backend}]: {v['lanes']} lanes, "
            f"{rs[0]['lane_steps']} steps; steps/s "
            f"{[round(r['steps_per_s'], 1) for r in rs]} median "
            f"{v['steps_per_s']:.1f} spread {v['spread']:.3f}; lane-epochs/s "
            f"{[round(r['lane_epochs_per_s'], 2) for r in rs]}; conv launches "
            f"per lane step {v['launches_per_step']:.2f} on {card}")
    if dev.type == "cuda":
        n = min(PROFILE_LANES, wl.lanes)
        run, wall, events = device_profile(
            lambda: run_mode(wl, "serial-async", settings, "kernel", lanes=n))
        busy = sum(e.time_range.elapsed_us() for e in events) / 1e6
        rep["profile"] = {"lanes": n, "wall_s": wall, "busy_s": busy,
                          "idle_share": 1 - busy / wall,
                          "device_ops_per_step": len(events) / run.lane_steps,
                          "device_ms_per_step": busy * 1e3 / run.lane_steps}
        log(f"bench: profiled serial-async [kernel], {n} lanes, "
            f"{run.lane_steps} steps: idle share "
            f"{rep['profile']['idle_share']:.3f}, "
            f"{rep['profile']['device_ops_per_step']:.1f} device ops and "
            f"{rep['profile']['device_ms_per_step']:.4f} device ms per lane "
            f"step on {card}")
    rep["launches"] = conv.LAUNCHES
    return rep


def last_line(rep):
    """bench.py's line: the shipped model's steps/s (serial-async, kernel
    backend) and its speedup over the sequential model."""
    v = rep["variants"]
    seq = v["sequential/kernel"]["steps_per_s"]
    asy = v["serial-async/kernel"]["steps_per_s"]
    vm = v["vmapped/kernel"]["steps_per_s"]
    steps = v["serial-async/kernel"]["lane_steps"]
    return {"metric": METRIC, "value": round(asy, 1),
            "unit": f"steps/s ({rep['device']}, {rep['lanes']} lanes x "
                    f"{rep['epochs']} epochs = {steps} steps run; bench.py "
                    f"counts {rep['lanes']} x {rep['nominal_steps_per_lane']}"
                    f", seq={seq:.1f}/s, vmap={vm:.1f}/s)",
            "vs_baseline": round(asy / seq, 2)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="2003-2012, 2 folds, 4 lanes, 3 epochs "
                         "(also BENCH_FAST=1)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain versions; no device "
                         "numbers)")
    ap.add_argument("--rounds", type=int, default=3,
                    help="timed rounds of every mode, in turns")
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--grid", type=int, nargs=2, default=(32, 32),
                    metavar=("H", "W"))
    args = ap.parse_args(argv)
    fast = args.fast or os.environ.get("BENCH_FAST", "") not in ("", "0")
    size = dict(FAST if fast else FULL)
    size.update({k: getattr(args, k) for k in ("lanes", "epochs")
                 if getattr(args, k)})
    device = devices.resolve("cpu" if args.cpu else None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    load_kernels(torch.device(device), log=lambda s: print(f"bench: {s}"))
    t0 = time.perf_counter()
    wl = build_workload(tuple(args.grid), size["years"], 3, size["folds"],
                        size["lanes"], device=device)
    print(f"bench: workload {tuple(wl.x.shape)}, {wl.lanes} lanes over "
          f"{size['folds']} folds, {size['epochs']} epochs, val rows "
          f"{wl.val_rows}; built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    with deterministic_cudnn():
        rep = run_bench(wl, size["epochs"], args.rounds,
                        log=lambda s: print(s, flush=True))
    print(json.dumps({"bench": rep}))
    print(json.dumps(last_line(rep)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

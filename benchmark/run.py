"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The cell (`cells/CELL.json`) names a
configuration (`configs/`, the deployment: data, folds, the trial bucket,
epochs and patience) and a traffic mix (`traffic/`: how the sweep's lanes
are dispatched); the harness lists none of them in code.

Set-up: torch and CUDA, the program's kernel library (built with nvcc on
a checkout's first run, then loaded), the inputs made from the seed
(workload.py), and one sweep call of one epoch, which builds and captures
every program the window replays, the winner forwards' included. Each
phase is logged with its wall seconds, this process's CPU seconds and the
host's steal seconds (/proc/stat), so that a slow set-up shows whether
the process worked longer or waited. The window then
calls the program's tuning sweep, `run_unet_sweep` with the cell's
`lane_dispatch`, again and again, each call training lanes of its own
initial weights and batch orders, and starts a new call only while under
`--seconds`; it ends on a synchronize. `lane_steps_per_s` is every lane
step of the window's calls over the window's seconds; `setup_s` runs from
the process's start to the window's.

With `--trace 1` the window runs the same, then: one sweep call under
torch.cuda.set_sync_debug_mode('warn') (host syncs per lane), and one
sweep call over the cell's profiled slice under torch.profiler, whose
count of conv kernel events must equal the count the shapes give (else the
run fails: the profiler dropped events). The per-layer metrics are the
readers in `metrics/`, each a file.

After the window, the check (check.py) holds a sample of the window's
answers against the plain reference. Standard error ends with each number
compared and its limit; the last line of standard output is the result.
`--cpu` (the benchmark's own tests only) runs on the CPU, where the
program takes its plain versions and nothing device-side is measured.
`--control tf32` (the benchmark's own tests only) puts the reference with
TF32 on in the program's place: no program runs, the answers of the folds
a one-call window would keep come from the lower-precision reference, and
the check must come out not correct. A cell that compares its first
epoch (check.EARLY) keeps the set-up call's answers of the folds the
check draws, and the control answers those too.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import sys
import time


def _process_seconds():
    """Seconds since this process started (Linux /proc), else None."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def host_clock():
    """(wall s, this process's CPU s, the host's steal s since boot)."""
    t = os.times()
    try:
        with open("/proc/stat") as fh:
            steal = int(fh.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        steal = 0.0
    return time.perf_counter(), t.user + t.system, steal


_T0 = time.perf_counter() - (_process_seconds() or 0.0)
_CLOCK0 = host_clock()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import check, counts, peaks, reference, trace, workload  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "s2s_ismr_tpu")


class RunError(Exception):
    """A run that must print no result."""


def load_json(root, kind, name):
    path = os.path.join(root, kind, f"{name}.json")
    if not os.path.exists(path):
        raise RunError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def metric_readers(root):
    """{name: module} of every metrics/<name>.py."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "metrics", "*.py"))):
        name = os.path.basename(path)[:-3]
        if name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's, optax's or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Phases:
    """Set-up phases: the wall, CPU and steal seconds of each, logged."""

    def __init__(self, log):
        self.log, self.rows = log, {}
        self.last = (_T0, 0.0, _CLOCK0[2])

    def mark(self, name):
        now = host_clock()
        d = [a - b for a, b in zip(now, self.last)]
        self.last = now
        self.rows[name] = d
        self.log(f"bench: set-up {name}: {d[0]:.2f} s wall, {d[1]:.2f} s "
                 f"cpu, {d[2]:.2f} s host steal")


def card_line():
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


class Program:
    """The system under test: the port's tuning sweep over the cell's
    inputs. Every call hands each lane its initial weights and batch
    orders from the seed through the sweep's `lane_overrides`."""

    def __init__(self, cfg, traffic, inputs, device):
        from s2s_ismr_tpu_torch.train import sweep
        self.sweep = sweep
        self.cfg, self.inputs, self.device = cfg, inputs, device
        self.dispatch = traffic["lane_dispatch"]
        b = cfg["bucket"]
        self.grid = sweep.TuningGrid(
            n_blocks=tuple(b["n_blocks"]), n_filters=tuple(b["n_filters"]),
            ct_kernels=tuple(tuple(k) for k in b["ct_kernels"]),
            batch_sizes=tuple(b["batch_sizes"]),
            learning_rates=tuple(b["learning_rates"]),
            patience=cfg["patience"])
        x, y = inputs.x, inputs.y_onehot
        self.specs = [reference.unet_spec(t, x.shape[-1], y.shape[-1])
                      for t in inputs.trials]

    def call(self, call, epochs=None, folds=None):
        """One sweep call (its index keys the lanes' inputs) over `folds`
        (default all) at `epochs` (default the configuration's)."""
        inp = self.inputs
        epochs = epochs or self.cfg["epochs"]
        fs = list(range(inp.train.shape[0])) if folds is None else folds
        T = inp.x.shape[0]

        def overrides(f, t):
            fold = fs[f]
            return (workload.lane_init(self.specs[t], inp.seed, call, fold,
                                       t, self.device),
                    workload.lane_orders(inp.seed, call, fold, t, epochs, T))

        y = inp.y_onehot if folds is None else inp.y_onehot[fs]
        return self.sweep.run_unet_sweep(
            inp.x, y, inp.train[fs], inp.val[fs], self.grid, epochs=epochs,
            base_seed=workload.derive_seed(inp.seed, 4, call) % (1 << 31),
            device=self.device, lane_overrides=overrides,
            lane_dispatch=self.dispatch)


def keep_answers(res, call, folds):
    """{(call, fold): (val losses per trial, winner index, predictions)}
    of a sweep call's folds `folds`, copied for the check."""
    return {(call, f): (res.val_loss_table[f].copy(),
                        res.best_trial[f].index, res.predictions[f].clone())
            for f in folds}


def call_flops(cfg, inputs, res, folds):
    """Model FLOP of a sweep call's lane epochs (counts.lane_epoch_flops)."""
    h, w = cfg["grid"]
    tot = 0
    for i, f in enumerate(folds):
        for t in inputs.trials:
            tot += int(res.epochs_table[i, t.index]) * counts.lane_epoch_flops(
                t, h, w, int(inputs.train[f].sum()), int(inputs.val[f].sum()))
    return tot


def expected_launches(cfg, inputs, res, folds, batched):
    """The conv kernel's launches the shapes give for a sweep call."""
    h, w = cfg["grid"]
    (trial,) = {(t.batch_size, t.ct_kernel, t.filters, t.n_blocks): t
                for t in inputs.trials}.values()
    n_real = {f: counts.n_real(inputs.train[f], trial.batch_size)
              for f in folds}
    lanes = [f for f in folds for _ in inputs.trials]
    val_rows = int(max(inputs.val[f].sum() for f in folds))
    if batched:
        epochs = int(res.timings["batched_epochs"])
    else:
        epochs = [int(res.epochs_table[i, t.index])
                  for i in range(len(folds)) for t in inputs.trials]
    return counts.sweep_launches(trial, h, w, lanes, epochs, n_real,
                                 val_rows, inputs.x.shape[0], folds, batched)


def run(args, log):
    root = args.root or HERE
    cell = load_json(root, "cells", args.workload)
    cfg = load_json(root, "configs", cell["config"])
    traffic = load_json(root, "traffic", cell["traffic"])
    if not cell.get("limits"):
        raise RunError(f"cell {args.workload!r} gives no limit: it would "
                       f"compare nothing")
    try:
        workload.predictor(cfg)
    except ValueError as e:
        raise RunError(f"configuration {cell['config']!r}: {e}") from e
    if args.cpu:
        device = "cpu"
    else:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark measures the card "
                           "and does not fall back to the CPU")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"the cell needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} present")
        device = "cuda"
    # the configuration's precision: float32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = Phases(log)
    if not args.control:
        try:
            from s2s_ismr_tpu_torch import programs
            from s2s_ismr_tpu_torch.kernels import conv as pconv
        except ImportError as e:
            raise RunError(f"the program is not importable here: {e}") from e
    phases.mark("imports")
    card = card_line() if device == "cuda" else "cpu"
    log(f"bench: {args.workload} seed {args.seed} on {card}; host "
        f"{os.cpu_count()} cpus, load {os.getloadavg()[0]:.2f}")
    if device == "cuda":
        torch.empty(1, device=device)
        torch.cuda.synchronize()
    phases.mark("card")
    if device == "cuda" and not args.control:
        from s2s_ismr_tpu_torch.kernels import _build
        info = _build.build()
        _build.library()
        log(f"bench: kernel library {os.path.relpath(info['path'])} "
            f"{'built in %.1f s' % info['seconds'] if info['seconds'] else 'cached'}")
        phases.mark("library")
    inputs = workload.make_inputs(cfg, args.seed, device)
    if device == "cuda":
        torch.cuda.synchronize()
    log(f"bench: inputs {tuple(inputs.x.shape)} {inputs.predictor}, "
        f"{inputs.train.shape[0]} folds x {len(inputs.trials)} trials")
    phases.mark("inputs")
    F = inputs.train.shape[0]
    all_folds = list(range(F))
    if args.control:
        return control_run(args, cell, cfg, inputs, device, log)
    prog = Program(cfg, traffic, inputs, device)

    # set-up: one epoch of one call builds every program the window runs;
    # where the cell compares its first epoch, its answers are kept
    built = programs.STATS["build_s"]
    res = prog.call(check.SETUP_CALL, epochs=1)
    early_kept, early_answers = {}, {}
    if check.early(cell):
        early_kept = {check.SETUP_CALL: check.preselect(
            args.seed, check.SETUP_CALL, F)}
        early_answers = keep_answers(res, check.SETUP_CALL,
                                     early_kept[check.SETUP_CALL])
    del res
    if device == "cuda":
        torch.cuda.synchronize()
    build_s = programs.STATS["build_s"] - built
    phases.mark("programs")
    setup_s = time.perf_counter() - _T0
    log(f"bench: set-up {setup_s:.2f} s, programs built in {build_s:.2f} s")

    # the window
    calls, kept, answers, finite = [], {}, {}, []
    t0 = time.perf_counter()
    clock, captures = host_clock(), programs.STATS["captures"]
    while True:
        c = len(calls)
        res = prog.call(c)
        kept[c] = check.preselect(args.seed, c, F)
        answers.update(keep_answers(res, c, kept[c]))
        finite.append(torch.isfinite(res.predictions).flatten(1).all(1))
        calls.append({"steps": res.train_steps, "vloss": res.val_loss_table,
                      "flops": call_flops(cfg, inputs, res, all_folds),
                      "execute_s": res.timings["execute_s"],
                      "collect_s": res.timings["collect_s"]})
        now = host_clock()
        log(f"bench: call {c}: {res.train_steps} lane steps in "
            f"{res.timings['execute_s']:.3f} + {res.timings['collect_s']:.3f}"
            f" s, {now[1] - clock[1]:.2f} s cpu, {now[2] - clock[2]:.2f} s "
            f"host steal, {programs.STATS['captures'] - captures} captures, "
            f"ending at {time.time():.2f}")
        clock, captures = now, programs.STATS["captures"]
        del res
        if time.perf_counter() - t0 >= args.seconds:
            break
    if device == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    steps = sum(c["steps"] for c in calls)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    lanes_per_call = F * len(inputs.trials)
    attempted = lanes_per_call * len(calls)
    failed = 0
    for c, ok in zip(calls, finite):
        failed += int((~np.isfinite(c["vloss"])).sum())
        failed += int((~ok).sum())
    log(f"bench: window {window_s:.3f} s, {len(calls)} calls, {steps} lane "
        f"steps, {steps / window_s:.2f} lane steps/s on {card}")
    bad = forbidden_modules()
    if bad:
        raise RunError(f"loaded after the window: {', '.join(bad)}")

    rec = {"cell": cell, "config": cfg, "traffic": traffic, "card": card,
           "window": {"seconds": window_s, "steps": steps,
                      "calls": len(calls),
                      "flops": sum(c["flops"] for c in calls),
                      "execute_s": sum(c["execute_s"] for c in calls),
                      "collect_s": sum(c["collect_s"] for c in calls)},
           "setup": {"seconds": setup_s, "build_s": build_s,
                     "phases": phases.rows},
           "peaks": {"flops": peaks.FLOAT32_3XTF32,
                     "bytes": peaks.HBM_BYTES},
           "syncs": None, "profile": None}
    breakdown = None
    if args.trace and device == "cuda":
        nxt = len(calls)
        _, n_sync, sites = trace.count_syncs(lambda: prog.call(nxt))
        rec["syncs"] = {"count": n_sync, "lanes": lanes_per_call,
                        "sites": sites}
        log(f"bench: host syncs {n_sync} over {lanes_per_call} lanes; by "
            f"site: {sites}")
        pf = cell["profile"]["folds"]
        pe = cell["profile"]["epochs"]
        prog.call(nxt + 1, epochs=1, folds=pf)
        launches0 = pconv.LAUNCHES
        got = trace.profile(lambda: prog.call(nxt + 2, epochs=pe, folds=pf))
        res = got.pop("out")
        want = expected_launches(cfg, inputs, res, pf,
                                 traffic["lane_dispatch"] == "vmap")
        n_want = sum(want.values())
        log(f"bench: profiled {len(pf)} folds x {pe} epochs: "
            f"{got['device_events']} device events, {got['conv_events']} "
            f"conv kernel events (shapes give {n_want}; the program counted "
            f"{pconv.LAUNCHES - launches0}), wall {got['wall_s']:.3f} s, "
            f"busy {got['busy_s']:.3f} s")
        if got["conv_events"] != n_want:
            raise RunError(
                f"the trace holds {got['conv_events']} conv kernel events, "
                f"the shapes give {n_want}: the profiler dropped or the "
                f"program added launches, so no trace number is reported")
        rec["profile"] = dict(got, lane_steps=res.train_steps,
                              least_conv_s=counts.least_time(want),
                              conv_launches=n_want)
        breakdown = {"device_ops": got["device_ops"],
                     "idle_gaps": got["idle_gaps"]}
        del res

    # the check, after the window, with the program's outputs kept
    t_chk = time.perf_counter()
    readings = check.compare(inputs, kept, answers, cfg["epochs"],
                             cfg["patience"], log)
    if early_answers:
        readings.update(check.compare(inputs, early_kept, early_answers, 1,
                                      cfg["patience"], log, check.EARLY))
    log(f"bench: check {time.perf_counter() - t_chk:.2f} s; readings "
        f"{readings}")

    if args.trace:
        metrics = {}
        for name, mod in metric_readers(root).items():
            v = mod.read(rec)
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
    else:
        metrics = {"lane_steps_per_s": {"value": steps / window_s,
                                        "unit": "steps/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    dev = device_line(cell, device, peak)
    if rec["profile"] is not None:
        dev["busy_s"] = rec["profile"]["busy_s"]
        dev["window_s"] = rec["profile"]["wall_s"]
    return result(cell, readings, failed, attempted, metrics, dev,
                  breakdown, log)


def device_line(cell, device, peak):
    return {"platform": "gpu" if device == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
            "count": cell["chips"] if device == "cuda" else 0,
            "memory_peak_bytes": peak}


def result(cell, readings, failed, attempted, metrics, dev, breakdown,
           log):
    """The last line: each reading the cell gives a limit is compared, and
    printed last beside its limit."""
    checks = {k: (v, cell["limits"][k]) for k, v in readings.items()
              if k in cell["limits"]}
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    bad = forbidden_modules()
    if bad:
        raise RunError(f"loaded: {', '.join(bad)}")
    for k, (v, lim) in checks.items():
        log(f"{k} {v!r} limit {lim!r}")
    return out


def control_run(args, cell, cfg, inputs, device, log):
    """The lower-precision control: the reference with TF32 on answers in
    the program's place for the folds a one-call window keeps."""
    F = inputs.train.shape[0]
    kept = {0: check.preselect(args.seed, 0, F)}
    t = time.perf_counter()
    answers = check.control_answers(inputs, kept, cfg["epochs"],
                                    cfg["patience"])
    log(f"bench: control answers in {time.perf_counter() - t:.2f} s")
    readings = check.compare(inputs, kept, answers, cfg["epochs"],
                             cfg["patience"], log)
    if check.early(cell):
        kept = {check.SETUP_CALL: check.preselect(args.seed,
                                                  check.SETUP_CALL, F)}
        answers = check.control_answers(inputs, kept, 1, cfg["patience"])
        readings.update(check.compare(inputs, kept, answers, 1,
                                      cfg["patience"], log, check.EARLY))
    log(f"bench: control readings {readings}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return result(cell, readings, 0, F * len(inputs.trials), {},
                  device_line(cell, device, peak), None, log)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the benchmark's own tests)")
    ap.add_argument("--root", default=None,
                    help="the directory of configs/, cells/, traffic/ and "
                         "metrics/ (default: this one)")
    ap.add_argument("--control", choices=("tf32",), default=None,
                    help="the lower-precision control: the reference with "
                         "TF32 on in cuDNN and matmuls, in the program's "
                         "place")
    args = ap.parse_args(argv)

    def log(s):
        print(s, file=sys.stderr, flush=True)

    try:
        out = run(args, log)
    except RunError as e:
        log(f"bench: no result: {e}")
        return 2
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

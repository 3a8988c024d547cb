"""Serial against batched lanes on the card (port of
probes/lane_regime_probe.py).

    python -m s2s_ismr_tpu_torch.probes.lane_regime [--cpu] [--turns N]
        [--out PATH]

Two workloads, each the bench's (bench.build_workload) on its own grid:
ECMWF_com_32 (32x32, 2003-2018, n_blocks 3, 20 lanes) at L in {2, 3, 4,
8, 20} lanes and IITM_full_64 (64x64, 2003-2022, n_blocks 4, 10 lanes) at
L in {2, 10}, 20 epochs, patience 5, early exit: each formulation pays its
own stopping (the serial lanes stop one by one, the batched loop runs to
its last lane's stop). For each L, `serial xL` (the first L lanes through
engine.train_fold one after another, one synchronize at the end: the
bench's serial-async mode) against `vmapL` (the same lanes in one
engine.train_lanes call: the kernel's lane mode in one batched program
per epoch), in `--turns` turns, the order reversed every other turn.
Every program a timed run replays is built before it: one epoch of all
lanes serially builds every fold's train_fold program, and a warm-up of
vmapL its batched programs (one epoch when the L lanes have the same
training batches, so the epoch's step count never changes; else the
whole run, which is deterministic: a timed run stops where its warm-up
stopped). Each row counts the captures of its timed runs (none is
expected). Prints the probe's table (formulation, lanes, wall s as the median
of the turns, lane steps actually run, lane steps/s, wall / serial), the
batched loop's epochs, the peak device memory of each formulation, and
the largest |val loss| difference between vmap and serial at the full
lane count; the card's name and power limit beside it. Writes the rows as
JSON to --out.

Not ported: the probe's `scan{lanes}` formulation (one program looping
over the stacked lanes, probes/lane_regime_probe.py:80-85). Under CUDA
graphs a lane's early exit inside one captured program needs conditional
graph nodes (ROADMAP A).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics

import torch

from .. import bench, programs
from .. import device as devices
from ..kernels import conv
from ..train.engine import deterministic_cudnn

EPOCHS, PATIENCE = 20, 5
SHAPES = {
    "ECMWF_com_32": dict(grid_shape=(32, 32), years=(2003, 2018),
                         n_blocks=3, lanes=20, Ls=(2, 3, 4, 8, 20)),
    "IITM_full_64": dict(grid_shape=(64, 64), years=(2003, 2022),
                         n_blocks=4, lanes=10, Ls=(2, 10)),
}
FORMS = {"serial": "serial-async", "vmap": "vmapped"}


def timed(wl, form, L, settings):
    """(bench.Run, peak device bytes) of one run of formulation `form`
    ('serial' or 'vmap') over the first L lanes."""
    cuda = wl.x.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(wl.x.device)
    run = bench.run_mode(wl, FORMS[form], settings, lanes=L)
    peak = torch.cuda.max_memory_allocated(wl.x.device) if cuda else 0
    return run, peak


def compare(wl, L, settings, turns, forms=tuple(FORMS)):
    """serial xL against vmapL (or the `forms` named) in `turns` turns,
    vmapL warmed first (the serial lanes' programs are built by the
    probe's warm-up). Returns {form: [bench.Run of each turn]}, the peak
    device bytes of each form's last run and the captures of its timed
    runs."""
    runs, peaks, caps = {f: [] for f in forms}, {}, dict.fromkeys(forms, 0)
    if "vmap" in forms:
        # train_lanes builds a new program when the epoch's step count
        # changes, which happens only when the lanes' training batches
        # differ and the longest ones stop first: then the warm-up runs the
        # whole run, else one epoch
        n_real = {wl.lane_steps(i, 1) for i in range(L)}
        timed(wl, "vmap", L, settings if len(n_real) > 1
              else dataclasses.replace(settings, epochs=1))
    for t in range(turns):
        for form in (forms if t % 2 == 0 else forms[::-1]):
            before = programs.STATS["captures"]
            run, peaks[form] = timed(wl, form, L, settings)
            caps[form] += programs.STATS["captures"] - before
            runs[form].append(run)
    return runs, peaks, caps


def probe(name, spec, device, turns, card, log=print):
    """The table of one workload: rows (formulation, lanes, wall s, lane
    steps, steps/s, wall / serial, batched epochs, peak MiB) and the
    largest |val loss| difference between vmap and serial at the full lane
    count."""
    wl = bench.build_workload(spec["grid_shape"], spec["years"],
                              spec["n_blocks"], lanes=spec["lanes"],
                              device=device)
    st = wl.settings(EPOCHS, PATIENCE, early_exit=True)
    rows, agree = [], None
    # the warm-up of every serial xL: one epoch of all lanes builds every
    # fold's program (its key holds no epoch count)
    timed(wl, "serial", wl.lanes, dataclasses.replace(st, epochs=1))
    results = [(1, *compare(wl, 1, st, turns, ("serial",)))]
    for L in spec["Ls"]:
        runs, peaks, caps = compare(wl, L, st, turns)
        results.append((L, runs, peaks, caps))
        if L == spec["lanes"]:
            s, v = runs["serial"][0], runs["vmap"][0]
            agree = max(abs(a - b) for a, b in zip(s.best_vloss,
                                                   v.best_vloss))
            stops = (s.epochs, v.epochs)
    for L, runs, peaks, caps in results:
        serial_wall = statistics.median(r.seconds for r in runs["serial"])
        for form in ("vmap", "serial"):
            if form not in runs:
                continue
            rs = runs[form]
            wall = statistics.median(r.seconds for r in rs)
            rows.append({"formulation": f"{form}{L}" if form == "vmap"
                         else f"serial x{L}", "lanes": L, "wall_s": wall,
                         "walls": [r.seconds for r in rs],
                         "steps": rs[0].lane_steps,
                         "steps_per_s": rs[0].lane_steps / wall,
                         "wall_over_serial": wall / serial_wall,
                         "batched_epochs": rs[0].batched_epochs,
                         "epochs": rs[0].epochs,
                         "best_vloss": rs[0].best_vloss,
                         "peak_mib": peaks[form] / 2**20,
                         "captures": caps[form]})
    log(f"\n[{name}] epochs={EPOCHS} patience={PATIENCE} early_exit=True "
        f"x={tuple(wl.x.shape)} turns={turns} on {card}")
    log(f"{'formulation':<14}{'lanes':>6}{'wall s':>9}{'steps':>8}"
        f"{'steps/s':>9}{'wall/serial':>12}{'epochs':>8}{'peak MiB':>10}"
        f"{'captures':>10}")
    for r in rows:
        ep = r["batched_epochs"] if r["formulation"].startswith("vmap") \
            else sum(r["epochs"])
        log(f"{r['formulation']:<14}{r['lanes']:>6}{r['wall_s']:>9.3f}"
            f"{r['steps']:>8}{r['steps_per_s']:>9.1f}"
            f"{r['wall_over_serial']:>12.2f}{ep:>8}{r['peak_mib']:>10.1f}"
            f"{r['captures']:>10}")
    if agree is None:
        log("max |dvloss| vmap-vs-serial: n/a")
    else:
        log(f"max |dvloss| vmap-vs-serial @ {spec['lanes']} lanes: "
            f"{agree:.2e}; stop epochs equal: {stops[0] == stops[1]}")
    return {"rows": rows, "max_dvloss": agree,
            "stops_equal": None if agree is None else stops[0] == stops[1],
            "T": int(wl.x.shape[0])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default="lane_regime.json")
    args = ap.parse_args(argv)
    device = devices.resolve("cpu" if args.cpu else None)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card_label(dev)
    bench.load_kernels(dev, log=lambda s: print(f"lane_regime: {s}"))
    results = {}
    with deterministic_cudnn():
        for name, spec in SHAPES.items():
            results[name] = probe(name, spec, dev, args.turns, card,
                                  log=lambda s: print(s, flush=True))
    out = {"card": card, "epochs": EPOCHS, "patience": PATIENCE,
           "turns": args.turns, "shapes": results,
           "launches": conv.LAUNCHES}
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

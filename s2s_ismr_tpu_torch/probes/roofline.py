"""The op-latency roofline of the bench's one-lane training step on the
card (port of probes/roofline_r5.py).

    python -m s2s_ismr_tpu_torch.probes.roofline [--fast] [--cpu]
                                                 [--out PATH]

(1) Census. Lane 0 of the bench's workload (fold 0, the kernel backend)
    trains one epoch through engine.train_fold, which builds the epoch's
    program (a CUDA graph). One replay of that program is profiled
    (torch.profiler, CUDA activity): its device ops and the conv kernel's
    launches among them. The same body then runs once uncaptured (the
    engine's `_uncaptured` seam), profiled with the CPU ops and their
    shapes, each minibatch step (`engine.train_step`) and the val forward
    (`engine.eval_rows`) inside a profiler scope of its own. Each device op
    goes to the kind of the CPU op that launched it: the conv kernel's
    forward (`Conv3x3BiasAct`) and dx mode (`Conv3x3Dx`) by map level, the
    weight gradient's pad, patch copy and matmul and the bias gradient's
    sum (inside `Conv3x3BiasActBackward`), cuDNN's convs (the transposed
    convs and the 1x1 head), the other reductions (`aten::sum` and the
    like) and all others; by scope: the minibatch steps, the val forward
    and the rest of the epoch (its batch orders, val loss and best-epoch
    update), the last two amortized over the epoch's steps; beside each
    kind's count, its device time in that run. On the CPU the conv calls
    are counted the same way (there are no device ops).
(2) Per-op latency. Chains of K1 = 8 and K2 = 32 dependent conv kernel
    launches (each reads the one before; the allocator hands the chain two
    buffers in turn), each captured in a CUDA graph and replayed, at the
    U-Net levels' shapes of roofline_r5.py; the latency of one launch is
    the difference of the two replays' times over K2 - K1. One chain of a
    trivial elementwise op (an add on the H4 level's tensor) gives the
    floor of every other op.
(3) Ceiling (roofline_r5.py:239-275). Each kind's count per step times its
    latency: the step's convs at their level's latency (the dx mode at the
    forward's), the weight-gradient matmuls at the mean conv latency (as
    roofline_r5.py priced the wgrad convs), the val forward's convs
    amortized, every other op at the elementwise floor. The conv floor
    (every non-conv op free) and the serialized sum (nothing overlapped)
    bracket the measured step, taken from the bench's sequential and
    serial-async modes in the same process; the achieved fraction is the
    conv floor over the measured step.

Writes the report as JSON to --out and prints it; the card's name and
power limit stand beside every time.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import statistics
import time

import torch

from .. import bench, programs
from ..kernels import conv
from ..train import engine

LEVEL_SHAPES = ((16, 32, 32, 8), (16, 16, 16, 16), (16, 8, 8, 32),
                (16, 4, 4, 64))
K1, K2 = 8, 32
REPLAYS = 200
TURNS = 3
STEP, VAL = "roofline.step", "roofline.val_forward"
REDUCTIONS = {"aten::sum", "aten::mean", "aten::var", "aten::var_mean",
              "aten::std", "aten::amax", "aten::amin", "aten::max",
              "aten::min", "aten::norm", "aten::linalg_vector_norm",
              "aten::logsumexp", "aten::prod", "aten::all", "aten::any",
              "aten::argmax", "aten::argmin", "aten::_softmax",
              "aten::_log_softmax", "aten::cumsum"}


@contextlib.contextmanager
def scoped_steps():
    """Inside the block every engine.train_step and engine.eval_rows call
    runs under a profiler scope (STEP, VAL)."""
    from torch.profiler import record_function
    real_step, real_eval = engine.train_step, engine.eval_rows

    def step(*args, **kw):
        with record_function(STEP):
            return real_step(*args, **kw)

    def val(*args, **kw):
        with record_function(VAL):
            return real_eval(*args, **kw)
    engine.train_step, engine.eval_rows = step, val
    try:
        yield
    finally:
        engine.train_step, engine.eval_rows = real_step, real_eval


def chain(e):
    """e and its CPU-op ancestors, innermost first."""
    out = []
    while e is not None:
        out.append(e)
        e = e.cpu_parent
    return out


def scope(names):
    """'step', 'val' or 'epoch' of an op whose chain has these names (a
    backward op runs on autograd's thread, inside a step)."""
    if STEP in names or any(n.startswith("autograd::engine::evaluate_function")
                            for n in names):
        return "step"
    return "val" if VAL in names else "epoch"


def kind(ops):
    """The census kind of the device ops launched by ops[0] (ops: its
    chain, innermost first)."""
    names = [o.name for o in ops]
    for o in ops:
        if o.name in ("Conv3x3BiasAct", "Conv3x3Dx"):
            mode = "fwd" if o.name == "Conv3x3BiasAct" else "dx"
            return f"conv_{mode}_H{o.input_shapes[0][1]}"
    if "Conv3x3BiasActBackward" in names:
        if "aten::constant_pad_nd" in names or "aten::pad" in names:
            return "wgrad_pad"
        if "aten::matmul" in names or "aten::mm" in names:
            return "wgrad_matmul"
        if "aten::sum" in names:
            return "db_sum"
        return "wgrad_copy"
    if any("conv" in n for n in names):
        return "torch_conv"
    return "reductions" if REDUCTIONS & set(names) else "other"


def census(events, n_steps):
    """Counts per lane step from a profiled run of the scoped epoch body:
    {"calls": {scope: {kind: CPU calls}}, "device": {scope: {kind: device
    ops}}, "device_us": {scope: {kind: their device us}}}, the val and
    epoch scopes amortized over the n_steps steps. Calls count each conv
    Function call and wgrad matmul once; device ops are the device events
    each CPU op launched (none on the CPU)."""
    calls = collections.defaultdict(collections.Counter)
    device = collections.defaultdict(collections.Counter)
    device_us = collections.defaultdict(collections.Counter)
    for e in events:
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        ops = chain(e)
        names = [o.name for o in ops]
        sc = scope(names)
        if e.name in ("Conv3x3BiasAct", "Conv3x3Dx", "aten::matmul"):
            k = kind(ops)
            if k.startswith("conv") or k == "wgrad_matmul":
                calls[sc][k] += 1
        if e.kernels:
            k = kind(ops)
            device[sc][k] += len(e.kernels)
            device_us[sc][k] += sum(kern.duration for kern in e.kernels)
    return {part: {sc: {k: v / n_steps for k, v in sorted(c.items())}
                   for sc, c in table.items()}
            for part, table in (("calls", calls), ("device", device),
                                ("device_us", device_us))}


def conv_census(c):
    """roofline_r5.py's conv_census from census(): the step's forward and
    dx launches by level, their sum by level, the wgrad matmuls per step,
    and the val forward's convs by level, amortized per step."""
    def levels(calls, prefix):
        # {'H32': n, ...}, the largest maps first
        found = {k.split("_")[2]: v for k, v in calls.items()
                 if k.startswith(prefix)}
        return dict(sorted(found.items(), key=lambda kv: -int(kv[0][1:])))
    step = c["calls"].get("step", {})
    fwd, dx = levels(step, "conv_fwd"), levels(step, "conv_dx")
    return {"fwd": fwd, "dx": dx,
            "step": {h: fwd.get(h, 0) + dx.get(h, 0) for h in fwd},
            "per_step": sum(fwd.values()) + sum(dx.values()),
            "wgrad": step.get("wgrad_matmul", 0),
            "val": levels(c["calls"].get("val", {}), "conv_fwd")}


def ceiling(cc, device_per_step, per_op_us, elementwise_us, step_us):
    """roofline_r5.py:239-275 on the port's census: cc is conv_census()
    (val convs amortized per step), device_per_step the device ops per
    lane step (all scopes), per_op_us {level 'H32': us}, step_us the
    measured serial-async step. Returns the report's ceiling fields."""
    mean = statistics.fmean(per_op_us.values())
    conv_us = sum(n * per_op_us.get(h, mean) for h, n in cc["step"].items())
    wgrad_us = cc["wgrad"] * mean
    val_us = sum(n * per_op_us.get(h, mean) for h, n in cc["val"].items())
    n_conv = cc["per_step"] + cc["wgrad"] + sum(cc["val"].values())
    other_us = max(0.0, device_per_step - n_conv) * elementwise_us
    floor_us = conv_us + wgrad_us + val_us
    serial_us = floor_us + other_us
    return {"ceiling_components_us": {
                "step_convs": conv_us, "wgrads": wgrad_us,
                "val_fwd_amortized": val_us,
                "other_ops_at_min_latency": other_us},
            "conv_floor_step_us": floor_us,
            "conv_floor_steps_per_s": 1e6 / floor_us,
            "serialized_sum_step_us": serial_us,
            "serialized_sum_steps_per_s": 1e6 / serial_us,
            "achieved_fraction_of_conv_floor": floor_us / step_us,
            "nonconv_latency_hidden_fraction":
                1.0 - (step_us - floor_us) / max(other_us, 1e-9)}


def epoch_census(wl, log=print):
    """(1): lane 0's epoch, one profiled replay and one profiled scoped
    run of the same body uncaptured. Returns the census part of the
    report."""
    from torch.profiler import ProfilerActivity, profile
    dev = wl.x.device
    cuda = dev.type == "cuda"
    st = wl.settings(1)
    g = wl.generator(0)
    t0 = time.perf_counter()
    engine.train_fold(wl.model(g), wl.x, wl.y[0], wl.train[0], wl.val[0],
                      float(wl.lrs[0]), g, st)
    build_s = time.perf_counter() - t0
    prog = programs.last()
    n = prog.n_real
    out = {"n_steps": n, "build_s": build_s,
           "val_chunks": -(-wl.val_rows // engine.row_chunk(wl.x))}
    if cuda:
        captured = sum(prog.graphs[i][1] for i in prog.schedule())
        _, wall, events = bench.device_profile(prog.run)
        n_conv = sum(conv.is_kernel_event(e.name) for e in events)
        out["replay"] = {"device_ops": len(events), "conv_launches": n_conv,
                         "captured_launches": captured,
                         "wall_ms": wall * 1e3,
                         "busy_ms": sum(e.time_range.elapsed_us()
                                        for e in events) / 1e3}
        log(f"roofline: one replay of lane 0's epoch ({n} steps): "
            f"{len(events)} device ops, {n_conv} conv kernel launches "
            f"(the program captured {captured}), "
            f"{out['replay']['busy_ms']:.4f} device ms in "
            f"{out['replay']['wall_ms']:.3f} ms")
    g = wl.generator(0)
    engine.train_fold(wl.model(g), wl.x, wl.y[0], wl.train[0], wl.val[0],
                      float(wl.lrs[0]), g, st, _uncaptured=True)
    seam = programs.last()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with scoped_steps(), profile(activities=acts, record_shapes=True) as prof:
        seam.run()
        if cuda:
            torch.cuda.synchronize(dev)
    c = census(prof.events(), n)
    out["calls_per_step"] = c["calls"]
    out["conv_census"] = conv_census(c)
    if cuda:
        dev_ops = c["device"]
        total = sum(sum(v.values()) for v in dev_ops.values())
        out["device_ops_per_step"] = dev_ops
        out["device_ops_per_step_total"] = total
        out["seam_device_ops"] = total * n
        # the uncaptured body's device time by kind: the same kernels as
        # the replay's, launched one by one
        out["device_us_per_step"] = c["device_us"]
        out["device_us_per_step_total"] = sum(
            sum(v.values()) for v in c["device_us"].values())
        log(f"roofline: the body uncaptured: {total * n:.0f} device ops "
            f"(the replay {out['replay']['device_ops']})")
    return out


def _replay_us(graph, reps):
    """Mean device time of one replay of graph over reps replays (CUDA
    events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    graph.replay()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / reps


def chain_graph(fn, x, k):
    """A CUDA graph of k dependent calls of fn from x (warmed on a side
    stream first) and the conv launches its capture recorded."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.no_grad():
        y = x
        for _ in range(k):
            y = fn(y)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with conv.tally(stream) as launches, torch.no_grad(), \
            torch.cuda.graph(graph, stream=stream):
        y = x
        for _ in range(k):
            y = fn(y)
    return graph, len(launches)


def chain_latency(fn, x, reps=REPLAYS, turns=TURNS):
    """(us per op, us per replay at K1 and K2, launches captured at K1 and
    K2): the difference of the K2 and K1 chains' replays over K2 - K1, the
    median of `turns` turns."""
    graphs = {k: chain_graph(fn, x, k) for k in (K1, K2)}
    times = {K1: [], K2: []}
    for t in range(turns):
        for k in ((K1, K2) if t % 2 == 0 else (K2, K1)):
            times[k].append(_replay_us(graphs[k][0], reps))
    med = {k: statistics.median(v) for k, v in times.items()}
    return ((med[K2] - med[K1]) / (K2 - K1), med,
            {k: graphs[k][1] for k in graphs})


def op_latencies(card, log=print):
    """(2): per-op latency of the conv kernel at each level's shape and of
    an elementwise add."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    per_op, chains = {}, {}
    for shape in LEVEL_SHAPES:
        n, h, w, c = shape
        x = torch.randn(shape, generator=gen, device="cuda") * 0.1
        k = torch.randn((3, 3, c, c), generator=gen, device="cuda") \
            / (9 * c) ** 0.5
        b = torch.zeros(c, device="cuda")
        tile = conv.TILES[conv.launch_tile((n, h, w, c, c))]
        us, walls, launches = chain_latency(
            lambda a: conv.conv3x3_bias_act(a, k, b), x)
        name = f"H{h}_C{c}"
        per_op[name] = us
        chains[name] = {"replay_us": walls, "launches": launches,
                        "family": conv.FAMILIES[tile[0]], "tile": tile}
        note = "" if us > 0 else " (K2 - K1 not positive)"
        log(f"roofline: conv chain {shape}: {us:.3f} us per launch{note} "
            f"(replays {walls[K1]:.2f} / {walls[K2]:.2f} us at K = {K1} / "
            f"{K2}, launches captured {launches[K1]} / {launches[K2]}; "
            f"every launch the {conv.FAMILIES[tile[0]]} tile {tile}) on "
            f"{card}")
    x = torch.zeros(LEVEL_SHAPES[-1], device="cuda")
    elem, walls, _ = chain_latency(lambda a: a + 1.0, x)
    log(f"roofline: elementwise chain {LEVEL_SHAPES[-1]}: {elem:.3f} us per "
        f"op (replays {walls[K1]:.2f} / {walls[K2]:.2f} us) on {card}")
    return per_op, elem, chains


def measured_steps(wl, epochs, rounds=TURNS):
    """Median steps/s of the bench's sequential (one lane at a time) and
    serial-async modes in turns, each warmed by one epoch of its lanes."""
    st = wl.settings(epochs)
    rates = {"sequential": [], "serial-async": []}
    for mode in rates:
        bench.run_mode(wl, mode, dataclasses.replace(st, epochs=1))
    for r in range(rounds):
        for mode in (list(rates) if r % 2 == 0 else list(rates)[::-1]):
            rates[mode].append(bench.run_mode(wl, mode, st).steps_per_s)
    return {m: statistics.median(v) for m, v in rates.items()}, rates


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="the bench's fast workload")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU: the census's conv calls only")
    ap.add_argument("--out", default="roofline.json")
    args = ap.parse_args(argv)
    from .. import device as devices
    size = bench.FAST if args.fast else bench.FULL
    dev = torch.device(devices.resolve("cpu" if args.cpu else None))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = bench.card_label(dev)
    bench.load_kernels(dev, log=lambda s: print(f"roofline: {s}"))
    wl = bench.build_workload((32, 32), size["years"], 3, size["folds"],
                              size["lanes"], device=dev)
    report = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"), "card": card}
    with engine.deterministic_cudnn():
        ce = epoch_census(wl, log=lambda s: print(s, flush=True))
        report["census"] = ce
        cc = ce["conv_census"]
        report["conv_census"] = cc
        print(f"roofline: conv census per lane step: forward {cc['fwd']}, "
              f"dx {cc['dx']}, wgrad matmuls {cc['wgrad']}; val forward "
              f"{cc['val']} per step amortized over {ce['n_steps']} steps",
              flush=True)
        if dev.type == "cuda":
            for sc, kinds in ce["device_ops_per_step"].items():
                us = ce["device_us_per_step"][sc]
                print(f"roofline: device ops (device us) per lane step, "
                      f"{sc}: " + ", ".join(f"{k} {v:.2f} ({us[k]:.2f})"
                                            for k, v in kinds.items()),
                      flush=True)
            per_op, elem, chains = op_latencies(
                card, log=lambda s: print(s, flush=True))
            report["per_op_us"] = per_op
            report["per_op_us_mean"] = statistics.fmean(per_op.values())
            report["elementwise_us"] = elem
            report["chains"] = chains
            rates, turns = measured_steps(wl, size["epochs"])
            report["steps_per_s_turns"] = turns
            report["single_lane_steps_per_s"] = rates["sequential"]
            report["single_lane_step_us"] = 1e6 / rates["sequential"]
            report["serial_async_steps_per_s"] = rates["serial-async"]
            report["serial_async_step_us"] = 1e6 / rates["serial-async"]
            lvl = {k.split("_")[0]: v for k, v in per_op.items()}
            report.update(ceiling(cc, ce["device_ops_per_step_total"], lvl,
                                  elem, report["serial_async_step_us"]))
        report["launches"] = conv.LAUNCHES
    print(json.dumps(report, indent=1))
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

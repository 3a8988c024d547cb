"""The port's span recorder (`s2s_ismr_tpu_torch.profiling.span`, `call`,
`calls`) on the CPU: the spans of a tuning sweep call and their counts,
self times and nesting, results bit-equal without records, the spans as
torch.profiler ranges (also in `profiling.trace`'s Chrome JSON and around `StageTimer`
stages), a mesh's thread spans, and the benchmark's readers of them and
of the set-up call's captured steps (`benchmark/metrics/`)."""

import collections
import contextlib
import itertools
import json
import math
import os

import numpy as np
import pytest
import torch

from s2s_ismr_tpu_torch import profiling, programs
from s2s_ismr_tpu_torch.parallel import mesh as pmesh
from s2s_ismr_tpu_torch.train import sweep as tsweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3
GRID = tsweep.TuningGrid(n_blocks=(2,), n_filters=(1,), ct_kernels=((2, 2),),
                         batch_sizes=(16,), learning_rates=(1e-3, 1e-4),
                         patience=1)
SPANS = ("sweep.call", "sweep.execute", "sweep.lane_models",
         "sweep.overrides", "engine.load", "programs.build", "engine.wait",
         "engine.epoch", "programs.train_replay", "programs.graph_launch",
         "engine.best", "sweep.collect", "sweep.winners",
         "programs.predict_replay")
# parent -> its child spans in one thread
CHILDREN = {"sweep.call": ("sweep.execute", "sweep.collect"),
            "sweep.execute": ("sweep.lane_models", "sweep.overrides",
                              "engine.load", "engine.wait", "engine.epoch",
                              "programs.train_replay", "engine.best"),
            "sweep.collect": ("sweep.winners", "programs.predict_replay"),
            "programs.train_replay": ("programs.graph_launch",)}
READERS = ("sweep.lane_prep_share", "engine.host_ms_per_lane_step",
           "programs.train_replay_ms", "programs.graph_launch_ms")


@pytest.fixture(scope="module")
def data():
    """x (T, 8, 8, 1), one-hot labels and masks of two folds."""
    rng = np.random.default_rng(3)
    T, F = 48, 2
    x = rng.standard_normal((T, 8, 8, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (F, T, 8, 8))]
    val = np.zeros((F, T), bool)
    val[0, :10], val[1, -10:] = True, True
    return x, y, ~val, val


def overrides(x):
    """Each lane's init and batch orders drawn from its own generator, so
    that the lanes differ from one call to the next only by these."""
    def lane(f, ti):
        g = torch.Generator().manual_seed(100 * f + ti)
        m = tsweep.UNet(tsweep.UNetConfig(filters=1, n_blocks=2,
                                          ct_kernel=(2, 2)), 1, generator=g)
        perms = torch.stack([torch.randperm(x.shape[0], generator=g)
                             for _ in range(EPOCHS)])
        return m.state_dict(), perms
    return lane


def sweep(data, **kw):
    x, y, tm, vm = data
    return tsweep.run_unet_sweep(x, y, tm, vm, GRID, epochs=EPOCHS,
                                 device="cpu", lane_overrides=overrides(x),
                                 **kw)


def last_calls(n):
    return profiling.calls()[-n:]


def counters(res, captured):
    """A call's counters: its lane steps, and the steps of the training
    programs it built (`captured`, STATS' captured_steps added), if any."""
    return {"lane_steps": res.train_steps,
            **({"captured_steps": captured} if captured else {})}


def waits(epochs_run):
    """engine.wait's count for lanes (or batched runs) of these epochs: a
    stop check before every epoch but the first, the one that ends a loop
    cut short, and the read of the epochs run after the loop."""
    return sum(e - 1 + (e < EPOCHS) + 1 for e in epochs_run)


@pytest.mark.parametrize("dispatch", ["serial", "vmap"])
def test_sweep_call_spans_and_counts(data, dispatch):
    misses, steps = (programs.STATS[k] for k in ("misses", "captured_steps"))
    res = sweep(data, lane_dispatch=dispatch)
    built = programs.STATS["misses"] - misses
    (rec,) = last_calls(1)
    sp, F = rec["spans"], res.epochs_table.shape[0]
    lanes = res.epochs_table.size
    assert set(sp) == set(SPANS) - ({"programs.build"} if not built else
                                    set())
    n = {k: v["count"] for k, v in sp.items()}
    if dispatch == "serial":
        epochs = int(res.epochs_table.sum())
        per_load = lanes
        assert n["engine.wait"] == waits(res.epochs_table.ravel())
    else:
        epochs = res.timings["batched_epochs"]
        per_load = 1
        assert n["engine.wait"] == waits([epochs])
    assert n["engine.epoch"] == n["programs.train_replay"] == epochs
    # every epoch here is at most engine.EPOCH_CHUNK steps: one launch
    assert n["programs.graph_launch"] == epochs
    assert n["engine.load"] == n["engine.best"] == per_load
    assert n["sweep.overrides"] == lanes
    assert n["sweep.lane_models"] == 1                 # one bucket
    assert n["sweep.winners"] == n["programs.predict_replay"] == F
    assert n.get("programs.build", 0) == built
    assert n["sweep.call"] == n["sweep.execute"] == n["sweep.collect"] == 1
    assert rec["counters"] == counters(
        res, programs.STATS["captured_steps"] - steps)
    assert res.timings["execute_s"] == sp["sweep.execute"]["total_s"]
    assert res.timings["collect_s"] == sp["sweep.collect"]["total_s"]
    assert res.timings["spans"] == {k: v["total_s"] for k, v in sp.items()}


def test_call_ids_rise_by_one(data):
    before = profiling.calls()[-1]["id"] if profiling.calls() else -1
    for _ in range(2):
        sweep(data, lane_dispatch="serial")
    a, b = last_calls(2)
    assert before < a["id"] and b["id"] == a["id"] + 1


@pytest.mark.parametrize("dispatch", ["serial", "vmap"])
def test_self_times_and_children(data, dispatch):
    sweep(data, lane_dispatch=dispatch)
    (rec,) = last_calls(1)
    sp = rec["spans"]
    for v in sp.values():
        assert v["self_s"] >= 0 and v["self_s"] <= v["total_s"]
    for parent, kids in CHILDREN.items():
        covered = sum(sp[k]["total_s"] for k in kids if k in sp)
        assert covered <= sp[parent]["total_s"]
    # sweep.call's only children are execute and collect
    call = sp["sweep.call"]
    assert math.isclose(call["self_s"], call["total_s"] - sum(
        sp[k]["total_s"] for k in CHILDREN["sweep.call"]), abs_tol=1e-8)


@pytest.mark.parametrize("dispatch", ["serial", "vmap"])
def test_results_bit_equal_without_records(data, monkeypatch, dispatch):
    """Spans touch no tensor: with no record carried they only time
    themselves, and the sweep's results stay bit for bit."""
    on = sweep(data, lane_dispatch=dispatch)
    assert on.timings["spans"]
    monkeypatch.setattr(profiling, "carried",
                        lambda rec: contextlib.nullcontext())
    off = sweep(data, lane_dispatch=dispatch)
    assert off.timings["spans"] == {} and off.timings["execute_s"] > 0
    np.testing.assert_array_equal(on.val_loss_table, off.val_loss_table)
    assert torch.equal(on.predictions, off.predictions)


def nested_in_call(events):
    """{span name: occurrences} of events (name, start, end) lying inside
    a sweep.call event."""
    calls = [(s, e) for n, s, e in events if n == "sweep.call"]
    assert calls
    inside = collections.Counter()
    for n, s, e in events:
        if n in SPANS and any(a <= s and e <= b for a, b in calls):
            inside[n] += 1
    return inside


def test_spans_are_profiler_ranges(data):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = sweep(data, lane_dispatch="serial")
    kineto = prof.profiler.kineto_results.events()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in kineto]
    inside = nested_in_call(events)
    (rec,) = last_calls(1)
    for name, v in rec["spans"].items():
        assert inside[name] == v["count"], name
    # ops' scope: a user-scope range would also span its kernels on the
    # device timeline under CUDA activity
    user = torch._C._profiler.RecordScope.USER_SCOPE
    assert not [e for e in kineto if e.name() in SPANS and e.scope() == user]
    assert inside["engine.epoch"] == int(res.epochs_table.sum())


def test_trace_json_holds_stages_and_spans(data, tmp_path):
    timer = profiling.StageTimer()
    with profiling.trace(str(tmp_path), device="cpu") as tr, \
            timer.stage("nn"):
        sweep(data, lane_dispatch="vmap")
    with open(tr.path) as fh:
        evs = [e for e in json.load(fh)["traceEvents"]
               if e.get("ph") == "X"]
    events = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in evs]
    (stage,) = [(s, e) for n, s, e in events if n == "stage.nn"]
    inside = nested_in_call(events)
    assert set(inside) >= set(SPANS) - {"programs.build"}
    assert all(stage[0] <= s and e <= stage[1] for n, s, e in events
               if n == "sweep.call")
    assert set(timer.summary()["stages_s"]) == {"nn"}


def test_mesh_thread_spans_land_in_the_callers_record(data):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    steps = programs.STATS["captured_steps"]
    try:
        res = sweep(data, mesh=pmesh.sweep_mesh(devices=["cpu"] * 2))
    finally:
        torch.set_num_threads(threads)
    (rec,) = last_calls(1)
    n = {k: v["count"] for k, v in rec["spans"].items()}
    lanes = res.epochs_table.size                    # 4 lanes, no pad
    assert n["engine.epoch"] == n["programs.train_replay"] == \
        int(res.epochs_table.sum())
    assert n["engine.load"] == n["sweep.lane_models"] == lanes
    assert n["sweep.call"] == 1
    assert rec["counters"] == counters(
        res, programs.STATS["captured_steps"] - steps)
    assert profiling.current() is None


def readers(names=READERS):
    from benchmark import run as bench_run
    got = bench_run.metric_readers(os.path.join(REPO, "benchmark"))
    return [got[name] for name in names]


def cell(name):
    with open(os.path.join(REPO, "benchmark", "cells", name + ".json")) as fh:
        return json.load(fh)


@pytest.fixture
def window(data, monkeypatch):
    """A fresh numbering: a set-up call (id 0), then two window calls;
    the harness's record of the window, in the cell ecmwf32_serial."""
    monkeypatch.setattr(profiling, "_call_ids", itertools.count())
    monkeypatch.setattr(profiling, "_calls", collections.deque(maxlen=8))
    sweep(data, lane_dispatch="serial")
    steps = sum(sweep(data, lane_dispatch=d).train_steps
                for d in ("serial", "vmap"))
    return {"window": {"calls": 2, "steps": steps},
            "cell": cell("ecmwf32_serial")}


def test_readers_read_the_window_calls(window):
    for mod in readers():
        v = mod.read(window)
        assert v is not None and math.isfinite(v) and v > 0, mod.UNIT
    assert readers()[0].read(window) < 100.0


def test_readers_refuse_other_calls(window, monkeypatch):
    mods = readers()
    short = dict(window, window=dict(window["window"], calls=3))  # no 3
    wrong = dict(window, window=dict(window["window"],
                                     steps=window["window"]["steps"] + 1))
    for rec in (short, wrong):
        assert [m.read(rec) for m in mods] == [None] * len(mods)
    kept = profiling.calls()
    monkeypatch.setattr(profiling, "calls",
                        lambda: [c for c in kept if c["id"] != 2])
    assert [m.read(window) for m in mods] == [None] * len(mods)
    monkeypatch.delattr(profiling, "calls")       # a program without spans
    assert [m.read(window) for m in mods] == [None] * len(mods)


def test_launch_reader_reads_within_the_replay(window):
    replay, launch = (m.read(window) for m in readers(
        ("programs.train_replay_ms", "programs.graph_launch_ms")))
    assert 0 < launch <= replay


def test_captured_steps_reader_reads_the_setup_call(data, monkeypatch):
    """The set-up call (id 0) builds every program of a fresh memo: the
    reader gives the steps they captured, which STATS counts too; nothing
    without that call's record or without records at all."""
    monkeypatch.setattr(profiling, "_call_ids", itertools.count())
    monkeypatch.setattr(profiling, "_calls", collections.deque(maxlen=8))
    monkeypatch.setattr(programs, "_program_memo", programs._ProgramMemo())
    steps = programs.STATS["captured_steps"]
    sweep(data, lane_dispatch="serial")
    sweep(data, lane_dispatch="serial")
    (mod,) = readers(("programs.captured_steps",))
    built = programs.STATS["captured_steps"] - steps
    assert built > 0 and mod.read({}) == built
    kept = profiling.calls()
    assert [c["counters"].get("captured_steps") for c in kept] == [built,
                                                                   None]
    monkeypatch.setattr(profiling, "calls",
                        lambda: [c for c in kept if c["id"] != 0])
    assert mod.read({}) is None
    monkeypatch.delattr(profiling, "calls")       # a program without spans
    assert mod.read({}) is None

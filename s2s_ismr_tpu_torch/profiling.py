"""Profiler traces, per-stage wall clock and program spans of a run.

The port's copy of s2s_ismr_tpu/profiling.py: `trace` is a torch.profiler
context where the JAX package's is a jax.profiler one; `StageTimer` is a
copy whose stages are also spans, so the port imports nothing of the JAX
package.

Spans (`span`) time the program's host work where it happens: the sweep,
its lanes, their epochs and the programs' replays. They sit outside every
captured CUDA graph body, at the replay boundary, so they hold under graph
replay. Each `run_unet_sweep` call opens a call record (`call`), numbered
from 0 in the process; every span opened inside it, in its thread or in a
mesh's device threads that carry it (`carried`), adds its duration, its
self time (the duration less what its child spans in the same thread
cover) and one to its count under its name; `count` adds to a counter of
the open record. The last `CALLS_KEPT` closed
records are `calls()`. While a torch profiler records, each span is also a
profiler range, so it shows in the profiler's trace on its clock, as an
op: a function-scope RecordFunction, as an aten op's. A user-scope one
(`torch.profiler.record_function`) would also put a range over the span's
kernels on the device timeline, which a reader of device activity takes
for device work.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field as dfield
from typing import Dict, Optional

import torch

TRACE_FILE = "trace.json"

CALLS_KEPT = 1024

_calls = collections.deque(maxlen=CALLS_KEPT)
_call_ids = itertools.count()
_local = threading.local()      # .rec: the open call record, .stack: spans


class CallRecord:
    """One call's spans ({name: [total ns, self ns, count]}) and counters,
    filled from every thread that carries it."""

    def __init__(self, call_id):
        self.id = call_id
        self.spans = {}
        self.counters = {}
        self._lock = threading.Lock()

    def add(self, name, total_ns, self_ns):
        with self._lock:
            s = self.spans.get(name)
            if s is None:
                self.spans[name] = [total_ns, self_ns, 1]
            else:
                s[0] += total_ns
                s[1] += self_ns
                s[2] += 1

    def count(self, name, value):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def totals(self):
        """{span name: total seconds}."""
        with self._lock:
            return {n: s[0] / 1e9 for n, s in self.spans.items()}

    def as_dict(self):
        with self._lock:
            return {"id": self.id,
                    "spans": {n: {"total_s": t / 1e9, "self_s": o / 1e9,
                                  "count": c}
                              for n, (t, o, c) in self.spans.items()},
                    "counters": dict(self.counters)}


class span:
    """Times the block under `name` (`seconds` after it exits) and, inside
    a call record, adds it there; a profiler range while one records."""

    __slots__ = ("name", "ns", "_t0", "_child", "_rec", "_range")

    def __init__(self, name):
        self.name = name
        self.ns = 0

    @property
    def seconds(self):
        return self.ns / 1e9

    def __enter__(self):
        self._range = None
        if torch.autograd._profiler_enabled():
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self._rec = getattr(_local, "rec", None)
        if self._rec is not None:
            self._child = 0
            _local.stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.ns = time.perf_counter_ns() - self._t0
        if self._rec is not None:
            stack = _local.stack
            stack.pop()
            if stack:
                stack[-1]._child += self.ns
            self._rec.add(self.name, self.ns, self.ns - self._child)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


@contextlib.contextmanager
def carried(rec):
    """Inside the block this thread's spans add to `rec` (a record that
    current() gave another thread), with a span stack of their own."""
    saved = (getattr(_local, "rec", None), getattr(_local, "stack", None))
    _local.rec, _local.stack = rec, []
    try:
        yield
    finally:
        _local.rec, _local.stack = saved


@contextlib.contextmanager
def call(name):
    """A call record around the block, opened by the span `name`; yields
    the record, which joins calls() on exit."""
    rec = CallRecord(next(_call_ids))
    try:
        with carried(rec), span(name):
            yield rec
    finally:
        _calls.append(rec)


def current():
    """This thread's open call record, or None."""
    return getattr(_local, "rec", None)


def count(name, value):
    """Adds `value` to the counter `name` of this thread's open call
    record, if one is open."""
    rec = current()
    if rec is not None:
        rec.count(name, value)


def calls():
    """The closed call records kept, oldest first: dicts of id, spans
    ({name: {total_s, self_s, count}}) and counters."""
    return [r.as_dict() for r in list(_calls)]


@dataclass
class Trace:
    """Where a `trace` wrote, filled when its context exits: the Chrome
    trace's path, its size in bytes, and the seconds from the end of the
    traced block to the file on disk (collecting the device activity and
    writing the JSON)."""
    path: str
    bytes: int = 0
    write_s: float = 0.0


@contextlib.contextmanager
def trace(trace_dir: Optional[str], log=print, device=None):
    """torch.profiler trace of the block into `trace_dir`/trace.json (a
    Chrome trace: open it in chrome://tracing or ui.perfetto.dev); a no-op
    yielding None when trace_dir is None or empty.

    It records CPU activity (torch ops), and CUDA activity (kernels and
    copies) when `device` (None: the card) is a CUDA device. Yields a
    `Trace` filled when the context exits.

    log: where the write-cost notice lands when writing takes over 1 s;
    pipelines pass their stage logger so the message stays in-stream.
    """
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import device as devices
    activities = [ProfilerActivity.CPU]
    if torch.device(devices.resolve(device)).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    rec = Trace(os.path.join(trace_dir, TRACE_FILE))
    t_stop = None
    with profile(activities=activities) as prof:
        try:
            yield rec
        finally:
            t_stop = time.perf_counter()
    # collecting the device activity and writing the JSON are not free
    # (tens of MB for a fast tune run's NN stage): surface the cost, so a
    # profiled run's wall clock is explainable
    prof.export_chrome_trace(rec.path)
    rec.write_s = time.perf_counter() - t_stop
    rec.bytes = os.path.getsize(rec.path)
    if rec.write_s > 1.0:
        log(f"[trace] wrote {rec.path} ({rec.bytes} bytes) in "
            f"{rec.write_s:.1f}s (excluded from stage timers)")


@dataclass
class StageTimer:
    """Wall-clock per pipeline stage + derived steps/sec, JSON-seriable."""
    stages: Dict[str, float] = dfield(default_factory=dict)
    counters: Dict[str, float] = dfield(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        sp = span(f"stage.{name}")
        try:
            with sp:
                yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + sp.seconds

    def count(self, name: str, value: float):
        self.counters[name] = self.counters.get(name, 0.0) + value

    def steps_per_sec(self, steps_counter="train_steps", stage="nn"):
        s = self.counters.get(steps_counter, 0.0)
        t = self.stages.get(stage, 0.0)
        return s / t if t > 0 else float("nan")

    def summary(self) -> dict:
        out = {"stages_s": {k: round(v, 3) for k, v in self.stages.items()},
               "counters": dict(self.counters)}
        if "train_steps" in self.counters and "nn" in self.stages:
            out["train_steps_per_sec"] = round(self.steps_per_sec(), 1)
        return out

    def dump(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=1)
        return path

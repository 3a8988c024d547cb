"""Profiler traces and per-stage wall clock of a pipeline run.

The port's copy of s2s_ismr_tpu/profiling.py: `trace` is a torch.profiler
context where the JAX package's is a jax.profiler one; `StageTimer` is a
plain copy, so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field as dfield
from typing import Dict, Optional

TRACE_FILE = "trace.json"


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
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)

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

"""Per-stage wall clock and steps/sec of a pipeline run.

The port's own copy of `StageTimer` from s2s_ismr_tpu/profiling.py, so the
port imports nothing of the JAX package. That module's `trace` (a
jax.profiler context) has no counterpart here yet: its torch.profiler port
is ROADMAP queue A item 16.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field as dfield
from typing import Dict


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

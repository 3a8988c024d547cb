"""The check catches a broken timed path: a run of the tiny CPU cell with
a fault planted in the program underneath comes out `correct: false`.
The faults a sweep cell can have: a step that leaves the state unchanged,
half of each batch left out (the loss's mean over the rest), and an answer
altered where it is produced (every lane's best val loss, one lane's of
each call, a fold's winner, a winner's prediction). One card, so no
exchange between chips to leave out."""

import pytest

from .util import run_cell, tiny_args

UNCHANGED = """
from s2s_ismr_tpu_torch.train import engine
_update = engine.Adam.update
def update(self, g, state):
    u, new = _update(self, g, state)
    return u * 0, state
engine.Adam.update = update
"""

HALF_BATCH = """
from s2s_ismr_tpu_torch.train import engine
_loss = engine._LOSSES["categorical_crossentropy"]
def half(out, y, w):
    n = out.shape[0] // 2
    return _loss(out[:n], y[:n], w[:n])
engine._LOSSES["categorical_crossentropy"] = half
"""

PREDICTION = """
from s2s_ismr_tpu_torch.train import sweep
_predict = sweep.predict
def predict(*a, **k):
    out = _predict(*a, **k)
    out[3, 2, 1, 0] += 5e-2
    return out
sweep.predict = predict
"""

VLOSS = """
from s2s_ismr_tpu_torch.train import sweep
_fold, _lanes = sweep.train_fold, sweep.train_lanes
def train_fold(*a, **k):
    best, v, hist = _fold(*a, **k)
    return best, v * 1.001, hist
def train_lanes(*a, **k):
    res = _lanes(*a, **k)
    res.best_vloss = res.best_vloss * 1.001
    return res
sweep.train_fold, sweep.train_lanes = train_fold, train_lanes
"""


ONE_LANE = """
import torch
from s2s_ismr_tpu_torch.train import sweep
_sweep, _fold, _lanes = sweep.run_unet_sweep, sweep.train_fold, sweep.train_lanes
seen = [0]
def run_unet_sweep(*a, **k):
    seen[0] = 0
    return _sweep(*a, **k)
def train_fold(*a, **k):
    best, v, hist = _fold(*a, **k)
    seen[0] += 1
    return best, (v * 1.001 if seen[0] == 1 else v), hist
def train_lanes(*a, **k):
    res = _lanes(*a, **k)
    scale = torch.ones_like(res.best_vloss)
    scale[0] = 1.001
    res.best_vloss = res.best_vloss * scale
    return res
sweep.run_unet_sweep = run_unet_sweep
sweep.train_fold, sweep.train_lanes = train_fold, train_lanes
"""

WINNER = """
import numpy
from s2s_ismr_tpu_torch.train import sweep
class _Numpy:
    def __getattr__(self, name):
        return getattr(numpy, name)
    @staticmethod
    def argmin(a, axis=None):
        return numpy.argmax(a, axis=axis)
sweep.np = _Numpy()
"""


# the state left unchanged in some sweep calls only: the set-up call (the
# harness's first) or every later one, the window's
IN_CALLS = """
from s2s_ismr_tpu_torch.train import engine, sweep
_sweep, _update = sweep.run_unet_sweep, engine.Adam.update
calls = [0]
def run_unet_sweep(*a, **k):
    calls[0] += 1
    return _sweep(*a, **k)
def update(self, g, state):
    u, new = _update(self, g, state)
    return (u * 0, state) if broken(calls[0]) else (u, new)
sweep.run_unet_sweep, engine.Adam.update = run_unet_sweep, update
"""
SETUP_ONLY = IN_CALLS + "broken = lambda n: n == 1\n"
WINDOW_ONLY = IN_CALLS + "broken = lambda n: n > 1\n"


@pytest.mark.parametrize("cell", ["tiny_serial", "tiny_vmap",
                                  "tiny_stacked_serial", "tiny_early_serial"])
@pytest.mark.parametrize("fault", [UNCHANGED, HALF_BATCH, PREDICTION, VLOSS,
                                   ONE_LANE, WINNER],
                         ids=["state_unchanged", "half_batch",
                              "prediction_altered", "vloss_altered",
                              "one_lane_vloss_altered", "winner_altered"])
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    rc, out, err = run_cell(tiny_args(tiny_root, cell), prelude=fault)
    assert rc == 0, err
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("fault,early", [(SETUP_ONLY, True),
                                         (WINDOW_ONLY, False)],
                         ids=["setup_call_only", "window_calls_only"])
def test_a_fault_in_some_calls_is_not_correct(tiny_root, fault, early):
    """Only the numbers of the broken calls pass their limits."""
    rc, out, err = run_cell(tiny_args(tiny_root, "tiny_early_serial"),
                            prelude=fault)
    assert rc == 0, err
    assert out["correct"] is False, out["checks"]
    failing = [k for k, c in out["checks"].items()
               if c["value"] > c["limit"]]
    assert failing and all(k.startswith("epoch1_") == early
                           for k in failing), failing

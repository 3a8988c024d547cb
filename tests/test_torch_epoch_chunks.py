"""The engine's chunked epoch (`engine._ChunkedFoldProgram`) on the CPU,
with the chunk (`engine.EPOCH_CHUNK`) cut small so that short epochs take
the chunked path: the chunk sequence (a prologue, the chunk n // K times,
the single step n % K times, the epilogue) against the whole-epoch body,
bit for bit; one program shared by every count of steps past the chunk;
the spans and counters of what it launched and built; and a tiny stacked
sweep (the benchmark's `tiny_stacked` recipe) through `run_unet_sweep`
against the benchmark's plain reference (`benchmark/reference.py`) on the
weights and batch orders the benchmark hands both.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch

from s2s_ismr_tpu_torch import profiling, programs
from s2s_ismr_tpu_torch.models import UNet, UNetConfig
from s2s_ismr_tpu_torch.train import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3                       # the chunk, patched
WHOLE = 10 ** 6             # a chunk no epoch reaches: the whole-epoch path
T, SIDE, BS = 60, 8, 4
SEED = 123456789012


@pytest.fixture(autouse=True)
def _fresh_memo():
    programs._program_memo.clear()
    yield
    programs._program_memo.clear()


@pytest.fixture(scope="module")
def data():
    """x (T, 8, 8, 1) and one-hot targets, from numpy's seed 7."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(T, SIDE, SIDE, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (T, SIDE, SIDE))]
    return torch.tensor(x), torch.tensor(y)


def masks(n):
    """Train rows for n real batches of BS (the last one ragged when n >
    1), val rows the last 12."""
    train = np.zeros(T, bool)
    train[:n * BS - (n > 1)] = True
    val = np.zeros(T, bool)
    val[-12:] = True
    return train, val


def lane(data, n, chunk, monkeypatch, epochs=3):
    """train_fold of one lane of n real steps with the chunk `chunk`:
    (best state, best val loss, history, Adam count, the program)."""
    monkeypatch.setattr(engine, "EPOCH_CHUNK", chunk)
    x, y = data
    train, val = masks(n)
    model = UNet(UNetConfig(filters=1, n_blocks=2), 1,
                 generator=torch.Generator().manual_seed(11))
    settings = engine.TrainSettings(epochs=epochs, batch_size=BS,
                                    patience=2, val_rows=12,
                                    early_exit=True)
    best, v, hist = engine.train_fold(model, x, y, train, val, 1e-3,
                                      torch.Generator().manual_seed(12),
                                      settings)
    prog = programs.last()
    return best, v, hist, prog.lane.opt_state[0].clone(), prog


@pytest.mark.parametrize("n", [K - 1, K, K + 1, 2 * K + 3])
def test_chunked_epoch_equals_the_whole_epoch(data, n, monkeypatch):
    a = lane(data, n, K, monkeypatch)
    b = lane(data, n, WHOLE, monkeypatch)
    assert engine.train_batches(int(masks(n)[0].sum()), BS) == n
    assert isinstance(a[4], engine._ChunkedFoldProgram) == (n > K)
    assert not isinstance(b[4], engine._ChunkedFoldProgram)
    assert list(a[0]) == list(b[0])
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[2], b[2])
    assert int(a[3]) == int(b[3]) == 3 * n      # every step of 3 epochs


def test_one_program_for_every_count_past_the_chunk(data, monkeypatch):
    misses = programs.STATS["misses"]
    progs = [lane(data, n, K, monkeypatch)[4] for n in (K + 1, 2 * K + 3)]
    assert progs[0] is progs[1]
    assert programs.STATS["misses"] - misses == 1
    settings = engine.TrainSettings(batch_size=BS)
    keys = [engine.fold_key(progs[0].model, *data, n, 12, settings)
            for n in (K - 1, K, K + 1, 5 * K)]
    assert keys[2] == keys[3] and len({keys[0], keys[1], keys[2]}) == 3


@pytest.mark.parametrize("n", [K, 2 * K + 3])
def test_launch_spans_and_captured_steps(data, n, monkeypatch):
    """Each epoch one programs.train_replay, inside which the segments
    its schedule names run once each (a graph launch each on the card),
    each in one programs.graph_launch: the prologue, the chunk n // K
    times, the single step n % K times, the epilogue; the whole body where
    n <= K. The build's captured_steps the steps its segments hold, K + 1
    chunked, n whole; a second lane through the same program builds
    nothing."""
    ran = collections.Counter()

    def counted(cls, name):
        orig = getattr(cls, name)

        def seg(self, *args):
            ran[(name, *args)] += 1
            return orig(self, *args)
        monkeypatch.setattr(cls, name, seg)

    counted(engine._ChunkedFoldProgram, "_prologue")
    counted(engine._ChunkedFoldProgram, "_steps")
    counted(engine._FoldProgram, "_epilogue")
    steps = programs.STATS["captured_steps"]
    with profiling.call("sweep.call") as rec:
        progs = [lane(data, n, K, monkeypatch)[4] for _ in range(2)]
    got = rec.as_dict()
    count = {k: v["count"] for k, v in got["spans"].items()}
    epochs = 2 * 3
    assert count["programs.train_replay"] == epochs
    per_epoch = 1 + n // K + n % K + 1 if n > K else 1
    assert count["programs.graph_launch"] == epochs * per_epoch
    launch, replay = (got["spans"][k]["total_s"] for k in
                      ("programs.graph_launch", "programs.train_replay"))
    assert 0 < launch <= replay
    if n > K:
        assert progs[0].schedule() == ((0,) + (1,) * (n // K)
                                       + (2,) * (n % K) + (3,))
        assert ran == +collections.Counter({
            ("_prologue",): epochs, ("_steps", K): epochs * (n // K),
            ("_steps", 1): epochs * (n % K), ("_epilogue",): epochs})
    else:
        assert progs[0].schedule() == (0,)
        assert ran == {("_epilogue",): epochs}
    built = K + 1 if n > K else n
    assert got["counters"] == {"captured_steps": built}
    assert programs.STATS["captured_steps"] - steps == built
    assert count["programs.build"] == 1


def tiny_stacked():
    path = os.path.join(REPO, "benchmark", "tests", "tiny", "configs",
                        "tiny_stacked.json")
    with open(path) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def stacked():
    """The tiny stacked recipe's inputs on the CPU (T = 525 rows: 3
    members x 175 dates; 459 train rows a fold, 29 batches of 16)."""
    from benchmark import workload
    cfg = tiny_stacked()
    return cfg, workload.make_inputs(cfg, SEED, "cpu")


def stacked_sweep(stacked, chunk, monkeypatch):
    from benchmark import run as bench_run
    monkeypatch.setattr(engine, "EPOCH_CHUNK", chunk)
    cfg, inputs = stacked
    return bench_run.Program(cfg, {"lane_dispatch": "serial"}, inputs,
                             "cpu").call(0)


def test_stacked_sweep_matches_the_plain_reference(stacked, monkeypatch):
    """Chunked (K = 8: 3 chunks and 5 single steps an epoch) against the
    reference, fold by fold. Tolerances: a lane's best val loss within 1e-5
    relative and a winner's probabilities within 1e-5, about 100x and 25x
    what the two read apart here (1.2e-7, 4.2e-7): float32 sum order over
    58 Adam steps, the reference's BatchNorm and crossentropy written
    apart from the port's; the winner exactly (its trials' val losses lie
    over 2e-3 apart)."""
    from benchmark import check
    cfg, inputs = stacked
    assert inputs.predictor == "stacked" and inputs.x.shape[0] == 525
    res = stacked_sweep(stacked, 8, monkeypatch)
    for f in range(inputs.train.shape[0]):
        losses, win, pred = check.reference_fold(inputs, 0, f, cfg["epochs"],
                                                 cfg["patience"])
        np.testing.assert_allclose(res.val_loss_table[f], losses, rtol=1e-5)
        assert res.best_trial[f].index == win
        torch.testing.assert_close(res.predictions[f], pred, rtol=0,
                                   atol=1e-5)
    assert res.train_steps == 2 * 2 * 2 * 29


def test_stacked_sweep_chunked_equals_whole(stacked, monkeypatch):
    a = stacked_sweep(stacked, 8, monkeypatch)
    b = stacked_sweep(stacked, WHOLE, monkeypatch)
    np.testing.assert_array_equal(a.val_loss_table, b.val_loss_table)
    assert torch.equal(a.predictions, b.predictions)
    assert [t.index for t in a.best_trial] == [t.index for t in b.best_trial]

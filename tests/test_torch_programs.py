"""The port's program memo and programs (s2s_ismr_tpu_torch/programs.py).

Mirrors tests/test_programs.py where the two memos share a contract:
test_memo_hit_after_compile_only_from_avals,
test_memo_keys_split_on_tag_statics_and_avals,
test_inflight_compile_is_shared_not_duplicated and
test_failed_compile_propagates_and_key_is_retryable. The JAX file's
foreground-priority tests (test_background_compile_defers_to_foreground_
priority, test_background_memo_hit_skips_the_gate_wait,
test_foreground_priority_gate_is_depth_counted) have no counterpart: the
gate orders XLA compiles on a remote compile server, and the port has
neither that server nor background builds (programs.py's docstring).

Beyond the mirrors: what splits a key and what does not (the learning
rate is an input), the FIFO bound, and reuse. On the CPU a program's body
runs uncaptured over the same buffers a CUDA graph replays, so a lane run
through a program another lane used must be bit-equal to the lane through
a fresh program (`_uncaptured=True` builds one), serial and batched, also
after a lane that stopped early; and one such lane matches JAX's
train_fold at the engine test's tolerances (rtol 1e-4 on val losses,
atol 1e-4 on parameters: Adam amplifies float32 sum-order differences).
Small: 8x8 maps, T = 80, a U-Net of filters 1 and n_blocks 2.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.train import engine as jengine
from s2s_ismr_tpu_torch import programs
from s2s_ismr_tpu_torch.models import UNet, UNetConfig
from s2s_ismr_tpu_torch.models.convert import from_flax, load_flax
from s2s_ismr_tpu_torch.models.mlp import MLP
from s2s_ismr_tpu_torch.train import engine

T, SIDE = 80, 8
SMALL = dict(filters=1, n_blocks=2)


@pytest.fixture(autouse=True)
def _fresh_memo():
    programs._program_memo.clear()
    programs.reset_stats()
    yield
    programs._program_memo.clear()


@pytest.fixture(scope="module")
def data():
    """x (T, 8, 8, 1), one-hot targets of two folds and their masks, from
    numpy's seed 5."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(T, SIDE, SIDE, 1)).astype(np.float32)
    cls = rng.integers(0, 3, size=(2, T, SIDE, SIDE))
    y = np.eye(3, dtype=np.float32)[cls]
    train = np.zeros((2, T), bool)
    val = np.zeros((2, T), bool)
    train[0, :56], val[0, 56:70] = True, True
    train[1, 10:60], val[1, 60:] = True, True
    return torch.tensor(x), torch.tensor(y), train, val


def settings(**kw):
    base = dict(epochs=4, batch_size=16, patience=2, val_rows=24,
                early_exit=True)
    return engine.TrainSettings(**{**base, **kw})


def unet(seed, **cfg):
    return UNet(UNetConfig(**{**SMALL, **cfg}), 1,
                generator=torch.Generator().manual_seed(seed))


def lane(data, fold, lr, seed=0, fresh=False, rate=0.0, st=None):
    """train_fold of one lane (fold, lr), its init and batch orders from
    `seed`; fresh: through a program of its own."""
    x, y, train, val = data
    return engine.train_fold(
        unet(seed, dropout_rate=rate), x, y[fold], train[fold], val[fold], lr,
        torch.Generator().manual_seed(seed + 100), st or settings(),
        dropout_generator=torch.Generator().manual_seed(seed + 200),
        _uncaptured=fresh)


def assert_lane_equal(a, b):
    (sa, va, ha), (sb, vb, hb) = a, b
    assert list(sa) == list(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(va, vb)
    torch.testing.assert_close(ha, hb, rtol=0, atol=0, equal_nan=True)


def test_memo_hit_after_compile_only_from_avals():
    """Mirrors test_programs.py::test_memo_hit_after_compile_only_from_avals:
    a program built once is served from the memo to the next caller with
    the same key, without a second build (the port builds on first use;
    it has no compile-only prefetch to warm the memo from avals)."""
    builds = []

    def build():
        builds.append(1)
        return object()

    first = programs.memoized(("t", (4,)), build)
    assert programs.memoized(("t", (4,)), build) is first
    assert len(builds) == 1
    assert programs.STATS["misses"] == 1 and programs.STATS["hits"] == 1


def test_memo_keys_split_on_tag_statics_and_avals(data):
    """Mirrors test_programs.py::test_memo_keys_split_on_tag_statics_and_
    avals: the program's tag, its statics and its input shapes each
    split the key; repeats add nothing."""
    x, y, train, val = data
    m = unet(0)
    st = settings()

    def n_entries():
        return len(programs._program_memo)

    for key in (engine.fold_key(m, x, y[0], 4, 24, st),
                engine.fold_key(m, x[:64], y[0, :64], 4, 24, st),
                engine.lanes_key(m, x, y, [4, 4], 24, st),
                engine.fold_key(m, x, y[0], 3, 24, st)):
        programs.memoized(key, object)
    assert n_entries() == 4
    for key in (engine.fold_key(m, x, y[0], 4, 24, st),
                engine.lanes_key(m, x, y, [4, 4], 24, st)):
        programs.memoized(key, object)
    assert n_entries() == 4 and programs.STATS["misses"] == 4


def test_inflight_compile_is_shared_not_duplicated():
    """Mirrors test_programs.py::test_inflight_compile_is_shared_not_
    duplicated: two threads asking for one key build one program; the
    second waits for the first's build."""
    builds, release = [], threading.Event()

    def slow():
        builds.append(1)
        release.wait(10.0)
        return object()

    outs = []
    t1 = threading.Thread(
        target=lambda: outs.append(programs.memoized("slow", slow)))
    t2 = threading.Thread(
        target=lambda: outs.append(programs.memoized("slow", slow)))
    t1.start()
    for _ in range(200):
        if builds:
            break
        time.sleep(0.01)
    t2.start()
    time.sleep(0.2)
    release.set()
    t1.join(30.0)
    t2.join(30.0)
    assert not (t1.is_alive() or t2.is_alive())
    assert len(builds) == 1 and len(outs) == 2 and outs[0] is outs[1]


def test_failed_compile_propagates_and_key_is_retryable():
    """Mirrors test_programs.py::test_failed_compile_propagates_and_key_is_
    retryable: a build's error reaches the caller, and the key is released,
    so a later call builds again instead of waiting forever."""
    calls = []

    def bad():
        calls.append(1)
        raise ValueError("build-time failure")

    for _ in range(2):
        with pytest.raises(ValueError):
            programs.memoized("bad", bad)
    assert len(calls) == 2 and len(programs._program_memo) == 0


def test_trials_differing_only_in_lr_share_one_program(data):
    """The learning rate is an input (JAX: a traced per-lane scalar): two
    trials of one bucket and fold build one program."""
    lane(data, 0, 1e-3)
    lane(data, 0, 1e-4)
    assert len(programs._program_memo) == 1
    assert programs.STATS["misses"] == 1 and programs.STATS["hits"] == 1


@pytest.mark.parametrize("what", ["n_real", "batch_size", "val_rows",
                                  "dropout", "lanes", "device", "cudnn",
                                  "tf32"])
def test_key_splits(data, what):
    """Each static that fixes a captured program splits its key: the real
    steps per epoch, the batch size, the val rows, the dropout rate, the
    lane count, the device and the cuDNN / TF32 flags in force."""
    x, y, _, _ = data
    m, st = unet(0), settings()
    base = engine.fold_key(m, x, y[0], 4, 24, st)
    if what == "n_real":
        other = engine.fold_key(m, x, y[0], 3, 24, st)
    elif what == "batch_size":
        other = engine.fold_key(m, x, y[0], 4, 24, settings(batch_size=8))
    elif what == "val_rows":
        other = engine.fold_key(m, x, y[0], 4, 20, st)
    elif what == "dropout":
        other = engine.fold_key(unet(0, dropout_rate=0.2), x, y[0], 4, 24,
                                st)
    elif what == "lanes":
        base = engine.lanes_key(m, x, y, [4, 4], 24, st)
        other = engine.lanes_key(m, x, y[:1], [4], 24, st)
    elif what == "device":
        other = engine.fold_key(m, x.to("meta"), y[0].to("meta"), 4, 24, st)
    else:
        flag = (torch.backends.cudnn if what == "cudnn"
                else torch.backends.cuda.matmul)
        name = "deterministic" if what == "cudnn" else "allow_tf32"
        prev = getattr(flag, name)
        setattr(flag, name, not prev)
        try:
            other = engine.fold_key(m, x, y[0], 4, 24, st)
        finally:
            setattr(flag, name, prev)
    assert other != base
    assert engine.fold_key(unet(7), x, y[0], 4, 24, st) == \
        engine.fold_key(m, x, y[0], 4, 24, st)


def test_fifo_bound_evicts_oldest():
    memo = programs._ProgramMemo(max_entries=2)
    for k in "abc":
        memo.put(k, k.upper())
    assert memo.get("a") is None and memo.get("b") == "B" \
        and memo.get("c") == "C" and len(memo) == 2


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_serial_lanes_through_one_program_equal_fresh(data, rate):
    """Lanes one after another through one program, the second after a
    lane that stopped early (lr 0.3, patience 1 at 6 epochs), each
    bit-equal to the lane through a program of its own (with dropout: the
    lane's own generator drawn in the same order)."""
    st = settings(epochs=6, patience=1)
    first = lane(data, 0, 0.3, seed=1, rate=rate, st=st)
    assert torch.isfinite(first[2]).sum() < st.epochs, "no early stop"
    second = lane(data, 1, 1e-3, seed=2, rate=rate, st=st)
    again = lane(data, 0, 0.3, seed=1, rate=rate, st=st)
    assert len(programs._program_memo) == 1
    assert programs.STATS["hits"] == 2
    assert_lane_equal(second, lane(data, 1, 1e-3, seed=2, rate=rate,
                                   fresh=True, st=st))
    assert_lane_equal(again, first)


def test_mlp_lane_through_one_program_equal_fresh(data):
    """The mlp (dropout 0.3, BatchNorm on dense features) reused across
    folds, bit-equal to a fresh program."""
    x, y, train, val = data
    st = settings(epochs=3)

    def run(fold, seed, fresh=False):
        model = MLP((SIDE, SIDE), 1,
                    generator=torch.Generator().manual_seed(seed))
        return engine.train_fold(
            model, x, y[fold], train[fold], val[fold], 1e-3,
            torch.Generator().manual_seed(seed), st,
            dropout_generator=torch.Generator().manual_seed(seed + 1),
            _uncaptured=fresh)

    run(0, 3)
    assert_lane_equal(run(1, 4), run(1, 4, fresh=True))
    assert len(programs._program_memo) == 1


def test_batched_lanes_through_one_program_equal_fresh(data):
    """train_lanes of 2 folds x 2 learning rates, twice through the memo's
    programs (the second run reuses every program, the lanes stopping at
    different epochs) and once through fresh ones: bit-equal."""
    x, y, train, val = data
    st = settings(epochs=6, patience=1)
    lrs = [0.3, 1e-3, 0.1, 1e-4]
    fs = [0, 0, 1, 1]

    def run(seed, fresh=False):
        models = [unet(seed + i) for i in range(4)]
        gens = [torch.Generator().manual_seed(seed + 10 + i)
                for i in range(4)]
        return engine.train_lanes(models, x, y[fs], train[fs], val[fs], lrs,
                                  gens, st, _uncaptured=fresh)

    run(0)
    n_built = programs.STATS["misses"]
    got = run(5)
    assert programs.STATS["misses"] == n_built, "a program was rebuilt"
    want = run(5, fresh=True)
    stops = torch.isfinite(got.hist).sum(1)
    assert len(set(stops.tolist())) > 1, "the lanes stopped together"
    assert (got.batched_steps, got.batched_epochs) == \
        (want.batched_steps, want.batched_epochs)
    torch.testing.assert_close(got.hist, want.hist, rtol=0, atol=0,
                               equal_nan=True)
    assert torch.equal(got.best_vloss, want.best_vloss)
    for a, b in zip(got.best, want.best):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_predict_is_memoized_and_exact(data):
    """predict's program is keyed by the model's structure and the rows:
    two winners of one architecture share it, and each equals the model's
    own eval forward bit for bit."""
    x = data[0]
    a, b = unet(1), unet(2)
    pa, pb = engine.predict(a, None, x), engine.predict(b, None, x)
    assert len(programs._program_memo) == 1
    with torch.no_grad():
        assert torch.equal(pa, a(x, train=False))
        assert torch.equal(pb, b(x, train=False))
    assert torch.equal(engine.predict(a, b.state_dict(), x), pb)
    engine.predict(a, None, x[:40])
    assert len(programs._program_memo) == 2


def test_reused_program_lane_matches_jax(data):
    """A lane run on a program another lane used, against JAX's
    train_fold with the same flax init and batch orders."""
    x, y, train, val = data
    st = settings(epochs=3, patience=3)
    lane(data, 1, 1e-2, seed=3, st=st)
    jm = JaxUNet(JaxUNetConfig(**SMALL))
    init = jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.key(7), jnp.asarray(x[:1].numpy()))
    key = jax.random.key(11)
    js = jengine.TrainSettings(epochs=3, batch_size=16, patience=3,
                               val_rows=24, early_exit=True)
    jbest, jv, jh = jax.jit(lambda: jengine.train_fold(
        jm, jnp.asarray(x.numpy()), jnp.asarray(y[0].numpy()),
        jnp.asarray(train[0]), jnp.asarray(val[0]), 1e-3, key, js,
        init_variables=init))()
    key_, _ = jax.random.split(key)
    perms = np.stack([np.asarray(jax.random.permutation(
        jax.random.split(ek)[0], T)) for ek in jax.random.split(key_, 3)])
    tbest, tv, th = engine.train_fold(
        load_flax(UNet(UNetConfig(**SMALL)), init), x, y[0], train[0],
        val[0], 1e-3, None, st, epoch_perms=perms.astype(np.int64))
    assert programs.STATS["hits"] == 1
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4)
    want = from_flax(jax.device_get(jbest))
    for name, v in tbest.items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=1e-4,
                                   err_msg=name)

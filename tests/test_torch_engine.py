"""Port vs JAX: the training engine.

Mirrors tests/test_engine.py. Both engines start from the same flax
initialisation (converted) and see the same batch orders: the JAX
per-epoch permutations are recomputed here from the JAX key exactly as
s2s_ismr_tpu/train/engine.py draws them and fed to the port through
`epoch_perms`. Best val loss agrees at rtol 1e-4 and best parameters at
atol 1e-4 (Adam amplifies float32 sum-order differences over the steps).
The fold comparisons run with the engine's epoch chunk as shipped (one
program an epoch) and cut to 3 steps, so that the fold's epochs of more
than 3 batches run as the chunked program's segments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.ops import terciles
from s2s_ismr_tpu.train import engine as jengine
from s2s_ismr_tpu_torch import programs, timeutils
from s2s_ismr_tpu_torch.data import synthetic
from s2s_ismr_tpu_torch.grid import Domain
from s2s_ismr_tpu_torch.models import UNet, UNetConfig
from s2s_ismr_tpu_torch.models.convert import from_flax, load_flax
from s2s_ismr_tpu_torch.train import engine as tengine
from s2s_ismr_tpu_torch.train import splits
from s2s_ismr_tpu_torch.train.losses import categorical_crossentropy

SMALL = dict(filters=1, n_blocks=2)
CHUNKS = [tengine.EPOCH_CHUNK, 3]      # as shipped; cut below the epoch


@pytest.fixture(scope="module")
def setup():
    b = synthetic.synthetic_hindcast(years=(2003, 2012), seed=9, signal=0.8,
                                     domain=Domain(67, 98, 7, 38), step=2.0)
    b = b.fillna(0.0)
    fm = splits.bootstrap_masks(b.years, n_bootstraps=3)
    wm = timeutils.week_window_matrix(1)
    labels, _, _ = terciles.fit_and_label(b.y, b.weeks, fm.train[0], wm, None)
    y_oh = np.nan_to_num(np.asarray(terciles.one_hot_labels(labels)), nan=0.0)
    x = b.ensemble_mean()[..., None].astype(np.float32)
    jm = JaxUNet(JaxUNetConfig(**SMALL))
    init = jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.key(7), jnp.asarray(x[:1]))
    return x, y_oh.astype(np.float32), fm, jm, init


def jax_epoch_perms(key, epochs, T):
    """engine.py:108, 164-168, 193: the per-epoch permutations."""
    key, _ = jax.random.split(key)
    perms = []
    for ekey in jax.random.split(key, epochs):
        ekey, _ = jax.random.split(ekey)
        perms.append(np.asarray(jax.random.permutation(ekey, T)))
    return np.stack(perms).astype(np.int64)


def run_both(setup, settings_kw, lr=1e-3, seed=42):
    x, y_oh, fm, jm, init = setup
    js = jengine.TrainSettings(**settings_kw)
    ts = tengine.TrainSettings(**settings_kw)
    key = jax.random.key(seed)
    jbest, jv, jh = jax.jit(lambda: jengine.train_fold(
        jm, jnp.asarray(x), jnp.asarray(y_oh), jnp.asarray(fm.train[0]),
        jnp.asarray(fm.val[0]), lr, key, js, init_variables=init))()
    model = load_flax(UNet(UNetConfig(**SMALL)), init)
    tbest, tv, th = tengine.train_fold(
        model, torch.tensor(x), torch.tensor(y_oh), fm.train[0], fm.val[0],
        lr, None, ts, epoch_perms=jax_epoch_perms(key, js.epochs, x.shape[0]))
    return (jbest, float(jv), np.asarray(jh)), (tbest, float(tv), th.numpy())


def test_adam_matches_optax(rng):
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = optax.flatten(optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-7,
                                           eps_root=0.0))
    state = tx.init(params)
    opt = tengine.Adam(0.9, 0.999, 1e-7)
    flat = torch.cat([torch.tensor(params[k]).reshape(-1) for k in "ab"])
    tstate = opt.init(flat)
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        u, state = tx.update(g, state, params)
        tu, tstate = opt.update(
            torch.cat([torch.tensor(g[k]).reshape(-1) for k in "ab"]),
            tstate)
        want = np.concatenate([np.asarray(u[k]).reshape(-1) for k in "ab"])
        np.testing.assert_allclose(tu.numpy(), want, rtol=1e-6)
    assert int(tstate[0]) == 3


def _lane(setup):
    x, y_oh, fm, jm, init = setup
    model = load_flax(UNet(UNetConfig(**SMALL)), init)
    lane = tengine.LaneState.create(model, tengine.TrainSettings(), "cpu")
    return lane, torch.tensor(x[:8]), torch.tensor(y_oh[:8])


def _snapshot(lane):
    return [t.clone() for t in (lane.flat, lane.stats, *lane.opt_state)]


@pytest.mark.parametrize("bad", ["zero_weight", "nan_batch"])
def test_gated_step_is_noop(setup, bad):
    lane, xb, yb = _lane(setup)
    wb = torch.ones(8)
    if bad == "zero_weight":
        wb = torch.zeros(8)
    else:
        xb = xb.clone()
        xb[0, 0, 0, 0] = float("nan")
    before = _snapshot(lane)
    loss = tengine.train_step(lane, xb, yb, wb, 1e-3,
                              categorical_crossentropy)
    for a, b in zip(before, _snapshot(lane)):
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True)
    assert int(lane.opt_state[0]) == 0
    if bad == "nan_batch":
        assert not torch.isfinite(loss)


def test_good_step_updates(setup):
    lane, xb, yb = _lane(setup)
    before = _snapshot(lane)
    tengine.train_step(lane, xb, yb, torch.ones(8), 1e-3,
                       categorical_crossentropy)
    assert int(lane.opt_state[0]) == 1
    assert not torch.equal(before[0], lane.flat)
    assert not torch.equal(before[1], lane.stats)


def chunked(chunk):
    """Whether the port's last program ran the chunked epoch, which it must
    where the chunk is cut below the fold's batches."""
    prog = programs.last()
    ran = isinstance(prog, tengine._ChunkedFoldProgram)
    assert ran == (prog.n_real > chunk)
    return ran


@pytest.mark.parametrize("chunk", CHUNKS)
def test_train_fold_matches_jax(setup, chunk, monkeypatch):
    monkeypatch.setattr(tengine, "EPOCH_CHUNK", chunk)
    x, _, fm, _, _ = setup
    kw = dict(epochs=3, batch_size=16, patience=3,
              val_rows=int(fm.val[0].sum()) + 2)
    (jbest, jv, jh), (tbest, tv, th) = run_both(setup, kw)
    assert chunked(chunk) == (chunk == 3)
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    np.testing.assert_allclose(th, jh, rtol=1e-4)
    want = from_flax(jax.device_get(jbest))
    assert set(want) == set(tbest)
    for name, v in tbest.items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_early_exit_stops_at_same_epoch(setup, chunk, monkeypatch):
    monkeypatch.setattr(tengine, "EPOCH_CHUNK", chunk)
    kw = dict(epochs=8, batch_size=16, patience=1, early_exit=True)
    (_, jv, jh), (_, tv, th) = run_both(setup, kw, lr=3e-2, seed=1)
    assert chunked(chunk) == (chunk == 3)
    n_j, n_t = int(np.isfinite(jh).sum()), int(np.isfinite(th).sum())
    assert n_j == n_t < kw["epochs"]
    np.testing.assert_allclose(th[:n_t], jh[:n_j], rtol=1e-4)
    assert np.isnan(th[n_t:]).all()
    np.testing.assert_allclose(tv, jv, rtol=1e-4)


def test_empty_train_mask_is_noop(setup):
    x, y_oh, fm, _, init = setup
    model = load_flax(UNet(UNetConfig(**SMALL)), init)
    st = tengine.TrainSettings(epochs=2, batch_size=16, patience=5)
    best, vloss, _ = tengine.train_fold(
        model, torch.tensor(x), torch.tensor(y_oh), np.zeros(len(x), bool),
        fm.val[0], 1e-3, torch.Generator().manual_seed(1), st)
    for name, v in from_flax(init).items():
        torch.testing.assert_close(best[name], v, rtol=0, atol=0)
    assert torch.isfinite(vloss)


def test_nonfinite_lr_guard(setup):
    x, y_oh, fm, _, init = setup
    model = load_flax(UNet(UNetConfig(**SMALL)), init)
    st = tengine.TrainSettings(epochs=2, batch_size=8, patience=3)
    best, _, _ = tengine.train_fold(
        model, torch.tensor(x), torch.tensor(y_oh), fm.train[0], fm.val[0],
        1e12, torch.Generator().manual_seed(0), st)
    assert all(torch.isfinite(v).all() for v in best.values())
    assert torch.isfinite(tengine.predict(model, best, torch.tensor(x))).all()


def test_val_rows_compaction_exact(setup):
    x, y_oh, fm, _, init = setup
    hists = []
    for val_rows in (None, int(fm.val[0].sum()) + 3):
        model = load_flax(UNet(UNetConfig(**SMALL)), init)
        st = tengine.TrainSettings(epochs=2, batch_size=16, patience=4,
                                   val_rows=val_rows)
        _, _, h = tengine.train_fold(
            model, torch.tensor(x), torch.tensor(y_oh), fm.train[0],
            fm.val[0], 1e-3, torch.Generator().manual_seed(1), st)
        hists.append(h.numpy())
    np.testing.assert_allclose(hists[1], hists[0], rtol=1e-6, atol=1e-6)

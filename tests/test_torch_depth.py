"""Port vs JAX at the reference's depth: 100 epochs with early stopping at
the published patience (15 in `_COM_GRID`, 10 in `_BLOCKS_GRID`).

Mirrors tests/test_engine.py::test_early_exit_identical_results and
::test_early_exit_vmapped_lanes, tests/test_sweep_serial.py::
test_serial_lane_indexing_pinned_against_independent_training and
::test_serial_matches_vmap, and tests/test_run_cli.py::
test_week_override_pipeline_end_to_end, each at 100 epochs where those
run 3-14. Both sides start every lane from the same flax initialisation
(converted) and see the same batch orders: JAX's lane keys are recomputed
here as s2s_ismr_tpu/train/sweep.py and engine.py draw them and fed to the
port through `epoch_perms` / `lane_overrides`.

Size, cut for time (the port trains eagerly on the CPU): ten years
(2003-2012, the fewest that give the 0.2 / 0.1 bootstrap split a test
year) of July-August weeks, T = 88, on an 8x8 grid; three folds. The
engine cases train the U-Net of test_torch_engine.py (filters 1,
n_blocks 2); the sweep and pipeline cases run tune_ECMWF_com's fast grid
(n_blocks 3, filters 2, ct_kernel 2 / 3, batch 16, lr 1e-3) at 3 folds,
100 epochs and patience 15, the published width of its U-Nets on a
coarser grid and a shorter record than its 32x32, T = 349 (held on the
card by chip_smoke.py phase 13).

The last tests read chip_smoke.py phase 13's expectations file
(s2s_ismr_tpu_torch/expected/depth_rpss_h100.json) as the phase does.

Tolerances (float32): val losses and histories at rtol 1e-4,
test_torch_engine.py's tolerance for 8 epochs (the drift measured here,
printed by each test, is 4e-6-5e-6 relative at the engine cases' stop
epochs and up to 1.6e-5 in the sweep's best val losses); best weights
within atol 1e-4; winner predictions within 1e-3, RPSS maps within 1e-4
and their means within 1e-5 (measured gaps ~3e-5 and ~1.4e-6 on test
years of 9 samples). Stop epochs and winners must be equal: each
assertion message gives the smallest margin a decision hinged on (an
improvement against the best so far, or the winner against the
runner-up; measured 4.7e-5 and 5.7e-3), to tell a real flip from drift.
"""

import json
import os
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.ops import terciles as jterciles
from s2s_ismr_tpu.pipelines import configs as jconfigs
from s2s_ismr_tpu.pipelines import tune as jtune
from s2s_ismr_tpu.programs import _ProgramMemo
from s2s_ismr_tpu.train import engine as jengine
from s2s_ismr_tpu.train import sweep as jsweep
from s2s_ismr_tpu_torch import run, timeutils
from s2s_ismr_tpu_torch.data import synthetic
from s2s_ismr_tpu_torch.models import UNet, UNetConfig
from s2s_ismr_tpu_torch.models.convert import from_flax, load_flax
from s2s_ismr_tpu_torch.pipelines import configs as tconfigs
from s2s_ismr_tpu_torch.pipelines import tune as ttune
from s2s_ismr_tpu_torch.train import engine as tengine
from s2s_ismr_tpu_torch.train import splits
from s2s_ismr_tpu_torch.train import sweep as tsweep

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

SEED, EPOCHS, RTOL = 42, 100, 1e-4
SMALL = dict(filters=1, n_blocks=2)
CUT = dict(years=(2003, 2012), season="Jul-Aug", synthetic_grid=(8, 8))


def quiet(*a):
    pass


@partial(jax.jit, static_argnums=(1, 2))
def jax_epoch_perms(key, epochs, T):
    """engine.py:108, 164-168, 193: the per-epoch permutations (vmapped
    over the epoch keys: the same values as drawing them one by one)."""
    key, _ = jax.random.split(key)
    return jax.vmap(lambda k: jax.random.permutation(
        jax.random.split(k)[0], T))(jax.random.split(key, epochs))


def perms(key, T):
    return np.asarray(jax_epoch_perms(key, EPOCHS, T)).astype(np.int64)


def decision_margin(hist):
    """The smallest |val loss - best so far| over the epochs a lane ran:
    how close its improve / wait decisions came to a tie."""
    h = hist[np.isfinite(hist)]
    best = np.minimum.accumulate(h)
    return float(np.abs(h[1:] - best[:-1]).min())


def stop_epoch(hist):
    return int(np.isfinite(hist).sum())


@pytest.fixture(scope="module")
def data():
    """x (88, 8, 8, 1), per-fold one-hot labels and three folds."""
    b = synthetic.synthetic_hindcast(
        years=CUT["years"], season=CUT["season"], seed=9, signal=0.8,
        grid_shape=CUT["synthetic_grid"]).fillna(0.0)
    fm = splits.bootstrap_masks(b.years, n_bootstraps=3)
    wm = timeutils.week_window_matrix(1)
    y_oh = np.stack([np.nan_to_num(np.asarray(jterciles.one_hot_labels(
        jterciles.fit_and_label(b.y, b.weeks, fm.train[f], wm, None)[0])),
        nan=0.0) for f in range(fm.n_folds)]).astype(np.float32)
    x = b.ensemble_mean()[..., None].astype(np.float32)
    assert x.shape == (88, 8, 8, 1)
    return x, y_oh, fm


@pytest.mark.parametrize("patience", [15, 10])
def test_train_fold_early_exit_at_depth_matches_jax(data, patience):
    """train_fold, 100 epochs, early exit at patience 15 and 10 (mirrors
    tests/test_engine.py::test_early_exit_identical_results): the same
    stop epoch, the history equal up to it and NaN after it, the best val
    loss and the best epoch's weights."""
    x, y_oh, fm = data
    kw = dict(epochs=EPOCHS, batch_size=16, patience=patience,
              val_rows=int(fm.val[0].sum()), early_exit=True)
    jm = JaxUNet(JaxUNetConfig(**SMALL))
    key = jax.random.key(SEED)
    init = jax.jit(lambda k: jm.init(k, jnp.asarray(x[:1]), train=False))(
        jax.random.split(key)[1])
    jbest, jv, jh = jax.jit(lambda: jengine.train_fold(
        jm, jnp.asarray(x), jnp.asarray(y_oh[0]), jnp.asarray(fm.train[0]),
        jnp.asarray(fm.val[0]), 1e-3, key, jengine.TrainSettings(**kw),
        init_variables=init))()
    jh = np.asarray(jh)
    model = load_flax(UNet(UNetConfig(**SMALL)), init)
    tbest, tv, th = tengine.train_fold(
        model, torch.tensor(x), torch.tensor(y_oh[0]), fm.train[0],
        fm.val[0], 1e-3, None, tengine.TrainSettings(**kw),
        epoch_perms=perms(key, x.shape[0]))
    th = th.numpy()

    n_j, n_t = stop_epoch(jh), stop_epoch(th)
    best_epoch = int(np.argmin(jh[:n_j]))
    margin = decision_margin(jh)
    drift = abs(th[n_t - 1] / jh[n_j - 1] - 1)
    print(f"patience {patience}: stop epoch {n_t} (best {best_epoch}), "
          f"relative drift at the stop epoch {drift:.2e}, smallest "
          f"decision margin {margin:.2e}")
    assert n_t == n_j, (f"stop epochs: port {n_t}, JAX {n_j}; smallest "
                        f"decision margin {margin:.2e}")
    # ran past its patience at least once before stopping short of 100
    assert best_epoch >= patience and n_t == best_epoch + patience + 1 \
        < EPOCHS
    np.testing.assert_allclose(th[:n_t], jh[:n_j], rtol=RTOL)
    assert np.isnan(th[n_t:]).all() and np.isnan(jh[n_j:]).all()
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)
    want = from_flax(jax.device_get(jbest))
    assert set(want) == set(tbest)
    for name, v in tbest.items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=1e-4,
                                   err_msg=name)


# ------------------------------------------------- the sweep and run_pipeline
def depth_config(mod):
    """tune_ECMWF_com's fast grid at 3 folds, 100 epochs and the published
    patience 15, on the cut record."""
    fast = mod.get_config("tune_ECMWF_com").fast_variant(n_bootstraps=3,
                                                         epochs=EPOCHS)
    return replace(fast, tuning=replace(fast.tuning, patience=15), **CUT)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's run_pipeline and the port's, then the port's run_unet_sweep
    with lane_dispatch='vmap' on the inputs the port's run_pipeline gave
    its (serial) sweep. JAX's per-lane histories are read by a callback
    around its train_fold (fresh program memo, so every lane program is
    traced with it); the port's sweep gets JAX's lane init and batch
    orders."""
    root = tmp_path_factory.mktemp("depth")
    trials = jsweep.enumerate_trials(depth_config(jconfigs).tuning)
    lane_of = {tuple(np.asarray(jax.random.key_data(
        jsweep._lane_keys(SEED, f, t.index))).tolist()): (f, t.index)
        for f in range(3) for t in trials}
    jhist = {}

    def record(key_data, hist):
        jhist[lane_of[tuple(np.asarray(key_data).tolist())]] = \
            np.asarray(hist)

    def recording_fold(model, x, y, tm, vm, lr, key, settings, **kw):
        out = jengine.train_fold(model, x, y, tm, vm, lr, key, settings, **kw)
        jax.debug.callback(record, jax.random.key_data(key), out[2])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsweep, "train_fold", recording_fold)
        mp.setattr(jsweep, "_program_memo", _ProgramMemo())
        jout = jtune.run_pipeline(depth_config(jconfigs),
                                  out_root=str(root / "jax"), log=quiet)

    real, calls = ttune.run_unet_sweep, []
    init = {t.index: jax.jit(lambda k, v, t=t: JaxUNet(JaxUNetConfig(
        filters=t.filters, n_blocks=t.n_blocks, ct_kernel=t.ct_kernel)).init(
            jax.random.split(k)[1], v, train=False)) for t in trials}

    def jax_lanes(x):
        def overrides(f, ti):
            key = jsweep._lane_keys(SEED, f, ti)
            return (from_flax(init[ti](key, jnp.asarray(x[:1]))),
                    perms(key, x.shape[0]))
        return overrides

    def sweep(x, *args, **kw):
        calls.append((x, args, kw))
        return real(x, *args, lane_overrides=jax_lanes(np.asarray(x)), **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttune, "run_unet_sweep", sweep)
        tout = ttune.run_pipeline(depth_config(tconfigs),
                                  out_root=str(root / "port"), log=quiet,
                                  device="cpu")
    (x, args, kw), = calls
    vmap = tsweep.run_unet_sweep(
        x, *args, **{**kw, "lane_dispatch": "vmap"},
        lane_overrides=jax_lanes(np.asarray(x)))
    return jout, tout, vmap, jhist


def test_jax_lanes_recorded(runs):
    """Every JAX lane reported its history once: 3 folds x 2 trials, and
    the lanes stop at different epochs, some well before 100."""
    _, _, _, jhist = runs
    stops = {k: stop_epoch(h) for k, h in jhist.items()}
    assert sorted(stops) == [(f, t) for f in range(3) for t in range(2)]
    assert len(set(stops.values())) >= 3 and min(stops.values()) < EPOCHS


def _jax_tables(jout, jhist):
    js = jout.nn.sweeps["ECMWF"]
    F, R = js.val_loss_table.shape
    stops = np.array([[stop_epoch(jhist[f, t]) for t in range(R)]
                      for f in range(F)])
    return js, stops


def _winner_margin(table):
    s = np.sort(table, axis=1)
    return float((s[:, 1] - s[:, 0]).min())


@pytest.mark.parametrize("mode", ["serial", "vmap"])
def test_sweep_at_depth_matches_jax(runs, mode):
    """The sweep at depth, 3 folds x 2 trials, each lane stopping on
    patience 15 (mirrors tests/test_sweep_serial.py::
    test_serial_lane_indexing_pinned_against_independent_training and,
    for 'vmap', tests/test_engine.py::test_early_exit_vmapped_lanes): every
    lane's stop epoch, the val-loss table, each fold's winner; under
    'vmap' each bucket runs to its last lane's stop while its finished
    lanes stay frozen (their epochs and val losses are serial's)."""
    jout, tout, vmap, jhist = runs
    js, jstops = _jax_tables(jout, jhist)
    res = tout.nn.sweeps["ECMWF"] if mode == "serial" else vmap
    assert res.timings["lane_dispatch"] == mode
    lane_margin = min(decision_margin(h) for h in jhist.values())
    drift = np.abs(res.val_loss_table / js.val_loss_table - 1).max()
    print(f"{mode}: stop epochs {res.epochs_table.tolist()}; largest "
          f"relative val-loss drift {drift:.2e}; smallest decision margin "
          f"{lane_margin:.2e}, winner margin "
          f"{_winner_margin(js.val_loss_table):.2e}")
    np.testing.assert_array_equal(
        res.epochs_table, jstops, err_msg=f"smallest decision margin "
        f"{lane_margin:.2e}")
    np.testing.assert_allclose(res.val_loss_table, js.val_loss_table,
                               rtol=RTOL)
    assert [t.index for t in res.best_trial] == \
        [t.index for t in js.best_trial], (
        f"winners differ; smallest winner margin "
        f"{_winner_margin(js.val_loss_table):.2e}")
    np.testing.assert_allclose(res.predictions.numpy(),
                               np.asarray(js.predictions), atol=1e-3)
    if mode == "vmap":
        # one bucket per trial here (ct_kernel 2 and 3), its 3 folds batched
        assert res.timings["batched_epochs"] == int(jstops.max(0).sum())
        assert (jstops < jstops.max(0)).any(), "no lane finished early"
        serial = tout.nn.sweeps["ECMWF"]
        np.testing.assert_array_equal(res.epochs_table, serial.epochs_table)
        np.testing.assert_allclose(res.val_loss_table,
                                   serial.val_loss_table, rtol=RTOL)


def test_run_pipeline_at_depth_matches_jax(runs):
    """run_pipeline of both packages on tune_ECMWF_com's fast grid at 3
    folds, 100 epochs and patience 15 (mirrors tests/test_run_cli.py::
    test_week_override_pipeline_end_to_end): the winners per fold, the
    epochs run, the test RPSS maps and their means."""
    jout, tout, _, jhist = runs
    js, jstops = _jax_tables(jout, jhist)
    assert tout.nn.best_hparams == jout.nn.best_hparams
    assert tout.nn.epochs_run == int(jstops.sum())
    # JAX counts every batch of T (ceil(88 / 16) = 6), the port the 4
    # that hold a training sample (61-62 train rows)
    assert js.train_steps == 6 * tout.nn.epochs_run
    rj, rt = jout.nn.rpss_test.values, tout.nn.rpss_test.values
    np.testing.assert_array_equal(np.isnan(rt), np.isnan(rj))
    gap = float(np.nanmax(np.abs(rt - rj)))
    mj, mt = float(np.nanmean(rj)), float(np.nanmean(rt))
    print(f"test RPSS mean JAX {mj!r} port {mt!r}; largest pixel gap "
          f"{gap:.2e}")
    np.testing.assert_allclose(rt, rj, atol=1e-4)
    np.testing.assert_allclose(mt, mj, atol=1e-5)


# ------------------------------------------- phase 13's expectations file
DEPTH_FILE = os.path.join(os.path.dirname(run.__file__), "expected",
                          "depth_rpss_h100.json")


@pytest.fixture(scope="module")
def depth_doc():
    with open(DEPTH_FILE) as fh:
        return json.load(fh)


def test_depth_file_is_the_one_phase_13_checks(depth_doc):
    """The file ships with the package where chip_smoke looks for it; its
    fingerprint is that of phase 13's settings (tune_ECMWF_com's fast grid,
    10 folds, 100 epochs, patience 15); per fold a winner among the 2
    trials and an RPSS mean, per lane an epoch count that a stop on
    patience 15 allows, and at least one lane stopped before epoch 100."""
    assert chip_smoke.depth_expected_path() == DEPTH_FILE
    cfg = chip_smoke.depth_config()
    fp = depth_doc["fingerprint"]
    assert fp == chip_smoke.depth_fingerprint(cfg)
    assert (fp["n_bootstraps"], fp["epochs"], fp["patience"],
            len(fp["trials"])) == (10, 100, 15, 2)
    assert set(depth_doc) == {"_comment", "backend", "tolerance",
                              "fingerprint", "winners", "stop_epochs",
                              "rpss_test"}
    assert depth_doc["backend"] in depth_doc["_comment"]
    assert depth_doc["tolerance"] >= 1e-5
    assert len(depth_doc["winners"]) == len(depth_doc["rpss_test"]) == 10
    assert set(depth_doc["winners"]) <= {0, 1}
    assert all(np.isfinite(v) for v in depth_doc["rpss_test"])
    ep = np.array(depth_doc["stop_epochs"])
    assert ep.shape == (10, 2) and (ep >= 16).all() and (ep <= 100).all()
    assert (ep < 100).any()


def test_check_depth_passes_on_the_files_own_numbers(depth_doc):
    got = {k: depth_doc[k] for k in ("fingerprint", "winners",
                                     "stop_epochs", "rpss_test")}
    assert chip_smoke.check_depth(got, depth_doc) == []


@pytest.mark.parametrize("change", ["winners", "stop_epochs", "rpss_test",
                                    "fingerprint"])
def test_check_depth_fails_on_a_changed_number(depth_doc, change):
    """A run whose winner, stop epoch, RPSS (by twice the tolerance) or
    settings differ from the file's fails, naming what differs."""
    got = json.loads(json.dumps({k: depth_doc[k] for k in (
        "fingerprint", "winners", "stop_epochs", "rpss_test")}))
    if change == "winners":
        got["winners"][3] = 1 - got["winners"][3]
    elif change == "stop_epochs":
        got["stop_epochs"][7][1] += 1
    elif change == "rpss_test":
        got["rpss_test"][5] += 2 * depth_doc["tolerance"]
    else:
        got["fingerprint"]["patience"] = 5
    failures = chip_smoke.check_depth(got, depth_doc)
    assert len(failures) == 1
    assert ("settings" if change == "fingerprint" else change) in failures[0]

"""Port vs JAX: the NN branch of the tune pipeline as a whole.

The slice is the hindcast tuning run of tune_ECMWF_com (fast variant) on a
16x16 synthetic grid with ten years: bootstrap folds, per-fold rolling
tercile labels, trials in the reference's product order, one lane trained
with the same init and batch orders on both sides, winner forward, RPSS.
Mirrors tests/test_sweep_serial.py and the NN-branch checks of
tests/test_run_cli.py. Port calls name their device (`device="cpu"`).
"""

import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.ops import metrics as jmetrics
from s2s_ismr_tpu.pipelines import configs as jconfigs
from s2s_ismr_tpu.pipelines import tune as jtune
from s2s_ismr_tpu.train import engine as jengine
from s2s_ismr_tpu.train import sweep as jsweep
from s2s_ismr_tpu_torch.models import UNet, UNetConfig
from s2s_ismr_tpu_torch.models.convert import load_flax
from s2s_ismr_tpu_torch.ops import metrics as tmetrics
from s2s_ismr_tpu_torch.pipelines import configs as tconfigs
from s2s_ismr_tpu_torch.pipelines import tune as ttune
from s2s_ismr_tpu_torch.train import engine as tengine
from s2s_ismr_tpu_torch.train import sweep as tsweep

EPOCHS = 2


def jax_epoch_perms(key, epochs, T):
    """s2s_ismr_tpu/train/engine.py:108, 164-168, 193: the per-epoch
    permutations the JAX engine draws from `key`."""
    key, _ = jax.random.split(key)
    perms = []
    for ekey in jax.random.split(key, epochs):
        ekey, _ = jax.random.split(ekey)
        perms.append(np.asarray(jax.random.permutation(ekey, T)))
    return np.stack(perms).astype(np.int64)


def _cfg(mod):
    return replace(mod.get_config("tune_ECMWF_com").fast_variant(
        epochs=EPOCHS), years=(2003, 2012))


@pytest.fixture(scope="module")
def setups():
    jcfg, tcfg = _cfg(jconfigs), _cfg(tconfigs)
    jb = jtune.load_bundles(jcfg, synthetic_step=2)
    tb = ttune.load_bundles(tcfg, synthetic_step=2)
    quiet = lambda s: None  # noqa: E731
    return (jcfg, jb, jtune._nn_setup(jcfg, jb, quiet),
            tcfg, tb, ttune._nn_setup(tcfg, tb, quiet, device="cpu"))


@pytest.mark.parametrize("name", sorted(jconfigs.CONFIGS))
def test_configs_equal_field_for_field(name):
    j, t = jconfigs.get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.fast_variant()) == \
        dataclasses.asdict(j.fast_variant())


@pytest.mark.parametrize("name", ["tune_ECMWF_com", "tune_GEFS_com"])
def test_trials_in_reference_product_order(name):
    grid_j = jconfigs.get_config(name).tuning
    grid_t = tconfigs.get_config(name).tuning
    tj, tt = jsweep.enumerate_trials(grid_j), tsweep.enumerate_trials(grid_t)
    assert [dataclasses.astuple(t) for t in tt] == \
        [dataclasses.astuple(t) for t in tj]
    assert list(tsweep.bucket_trials(tt)) == list(jsweep.bucket_trials(tj))


def test_bundles_identical(setups):
    _, jb, _, _, tb, _ = setups
    for n in jb:
        np.testing.assert_array_equal(tb[n].x, jb[n].x)
        np.testing.assert_array_equal(tb[n].y, jb[n].y)
        assert tb[n].x.shape[2:] == (16, 16)


def test_apply_pad_matches_jax():
    """tune_ECMWF_full's 23 -> 24 row pad (tune_ECMWF_full.py:50-57)."""
    jcfg = replace(jconfigs.get_config("tune_ECMWF_full"), years=(2003, 2004))
    tcfg = replace(tconfigs.get_config("tune_ECMWF_full"), years=(2003, 2004))
    b = ttune.load_bundles(tcfg)["ECMWF"]
    j, t = jtune._apply_pad(jcfg, b), ttune._apply_pad(tcfg, b)
    assert t.y.shape[1:] == (24, 24) and t.lats[-1] == 40.5
    for name in ("x", "y", "lats", "lons"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def test_nn_setup_labels_masks_onehot_exact(setups):
    _, _, js, _, _, ts = setups
    jn, _, _, jfm, jlab, jyoh, _ = js
    tn, _, _, tfm, tlab, tyoh, _ = ts
    assert tn == jn
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(getattr(tfm, split),
                                      getattr(jfm, split))
    np.testing.assert_array_equal(tlab, jlab)
    np.testing.assert_array_equal(tyoh.numpy(), np.asarray(jyoh))


def test_one_lane_rpss_matches_jax(setups):
    """JAX train_fold -> predict -> rpss vs the port's counterparts with
    the same init and batch orders."""
    jcfg, _, js, _, _, ts = setups
    _, jfilled, _, fm, jlab, jyoh, _ = js
    _, tfilled, _, _, tlab, tyoh, _ = ts
    trial = jsweep.enumerate_trials(jcfg.tuning)[0]
    x = jfilled["ECMWF"].predictor_images()
    kw = dict(epochs=EPOCHS, batch_size=trial.batch_size,
              patience=jcfg.tuning.patience,
              val_rows=int(fm.val.sum(1).max()), early_exit=True)
    jm = JaxUNet(JaxUNetConfig(filters=trial.filters,
                               n_blocks=trial.n_blocks,
                               ct_kernel=trial.ct_kernel))
    init = jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.key(0), jnp.asarray(x[:1]))
    key = jax.random.key(123)

    def jax_lane():
        best, _, _ = jengine.train_fold(
            jm, jnp.asarray(x), jyoh[0], jnp.asarray(fm.train[0]),
            jnp.asarray(fm.val[0]), trial.lr, key,
            jengine.TrainSettings(**kw), init_variables=init)
        preds = jengine.predict(jm, best, jnp.asarray(x))
        climo = jmetrics.climo_forecast(jfilled["ECMWF"].ensemble_mean())
        return jmetrics.rpss(climo, preds, jnp.asarray(jlab[0]),
                             jnp.asarray(fm.test[0]))
    want = np.asarray(jax.jit(jax_lane)())

    model = load_flax(UNet(UNetConfig(filters=trial.filters,
                                      n_blocks=trial.n_blocks,
                                      ct_kernel=trial.ct_kernel)), init)
    xt = torch.tensor(x)
    tengine.train_fold(model, xt, tyoh[0], fm.train[0], fm.val[0], trial.lr,
                       None, tengine.TrainSettings(**kw),
                       epoch_perms=jax_epoch_perms(key, EPOCHS, len(x)))
    preds = tengine.predict(model, None, xt)
    climo = tmetrics.climo_forecast(tfilled["ECMWF"].ensemble_mean())
    got = tmetrics.rpss(climo, preds, tlab[0], fm.test[0]).numpy()
    assert np.isfinite(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_run_nn_branch_end_to_end(setups):
    _, jb, js, tcfg, tb, _ = setups
    jlab = js[4]
    F, T = jlab.shape[:2]
    res = ttune.run_nn_branch(tcfg, tb, log=lambda s: None, device="cpu")
    land = jb["ECMWF"].valid_pixels()
    for split in (res.rpss_train, res.rpss_val, res.rpss_test):
        assert split.values.shape == (F, 16, 16)
        assert split.dims == ("bootstrap", "Y", "X")
        assert np.isfinite(split.values[:, land]).all()
    assert tuple(res.predictions.shape) == (F, T, 16, 16, 3)
    assert torch.isfinite(res.predictions).all()
    np.testing.assert_allclose(res.predictions.sum(-1).numpy(), 1.0,
                               atol=1e-5)
    sw = res.sweeps["ECMWF"]
    assert sw.val_loss_table.shape == (F, 2)
    assert np.isfinite(sw.val_loss_table).all()
    np.testing.assert_array_equal(sw.best_val_loss,
                                  sw.val_loss_table.min(1))
    assert sw.train_steps > 0 and sw.epochs_run <= F * 2 * EPOCHS
    assert len(res.best_hparams) == F


@pytest.mark.parametrize("change", [
    dict(architecture="cnn"), dict(output="deterministic"),
    dict(predictor="stacked"), dict(predictor="multi_predictor")])
def test_branch_modes_end_to_end(setups, change):
    """The NN branch's other modes (test_output_predictor_modes.py,
    test_training_type_train.py): the cnn's fixed training, the
    deterministic head scored through fold-edge categorization, members
    as extra rows, members as channels. Finite RPSS on land; one-hot
    rows for the deterministic head."""
    _, jb, _, tcfg, tb, _ = setups
    cfg = replace(tcfg, **change)
    if cfg.predictor == "stacked":
        # 11 members x T rows: fewer, larger batches keep the CPU run short
        cfg = replace(cfg, tuning=replace(cfg.tuning, batch_sizes=(64,)))
    res = ttune.run_nn_branch(cfg, tb, log=lambda s: None, device="cpu")
    F = res.masks.n_folds
    rows = tb["ECMWF"].n_t * (tb["ECMWF"].n_m if cfg.predictor == "stacked"
                              else 1)
    assert tuple(res.predictions.shape) == (F, rows, 16, 16, 3)
    land = jb["ECMWF"].valid_pixels()
    for split in (res.rpss_train, res.rpss_val, res.rpss_test):
        assert np.isfinite(split.values[:, land]).all()
    assert res.train_steps > 0 and res.epochs_run > 0
    if cfg.output == "deterministic":
        p = res.predictions.numpy()
        ok = np.isfinite(p).all(-1)
        assert set(np.unique(p[ok])) <= {0.0, 1.0}
        np.testing.assert_array_equal(p[ok].sum(-1), 1.0)
    if cfg.architecture == "cnn":
        assert not res.sweeps and set(res.fixed_winners) == {"ECMWF"}
        assert res.best_hparams[0]["ECMWF"]["architecture"] == "cnn"
    else:
        assert list(res.sweeps) == ["ECMWF"]

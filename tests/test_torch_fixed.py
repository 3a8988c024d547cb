"""Port vs JAX: the fixed training, the deterministic head, the eval row
chunks and the entry points' default device.

Mirrors tests/test_training_type_train.py (run_fixed_training for the
U-Net, cnn and mlp), tests/test_output_predictor_modes.py (the
deterministic sweep and its fold-edge categorization) and
tests/test_batch_size.py::test_full_batch_is_one_step_per_epoch. Both
sides start every lane from the same flax initialisation (converted) and
see the same batch orders: the JAX lane keys are recomputed here exactly as
s2s_ismr_tpu/train/sweep.py and engine.py draw them and fed to the port
through `lane_overrides`. Per-fold val losses and predictions agree within
atol 1e-5 (float32 sum order over two epochs of Adam; the deterministic
head's val loss, a squared error near 78 where a float32 ulp is 7.6e-6,
within rtol 1e-6); the categorization is exact.

The lanes train at lr 1e-4 and batch 32, values of tune_ECMWF_com's grid.
At lr 1e-3, or at batch 16 whose last batch holds 9 of the 153 train rows
(BatchNorm statistics over so few rows are ill-conditioned in float32),
float32 noise in the first Adam steps grows past 1e-5 within an epoch on
either side; the forward of one set of weights agrees within ~5e-6.
Every port call names its device: the library defaults to the card, which
tests/conftest.py hides.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2s_ismr_tpu.models import CNN as JaxCNN
from s2s_ismr_tpu.models import MLP as JaxMLP
from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.ops import terciles as jterciles
from s2s_ismr_tpu.pipelines import configs as jconfigs
from s2s_ismr_tpu.pipelines import tune as jtune
from s2s_ismr_tpu.train import sweep as jsweep
from s2s_ismr_tpu_torch import timeutils
from s2s_ismr_tpu_torch.data import synthetic
from s2s_ismr_tpu_torch.grid import Domain
from s2s_ismr_tpu_torch.models import CNN, MLP, UNet, UNetConfig
from s2s_ismr_tpu_torch.models.convert import from_flax
from s2s_ismr_tpu_torch.pipelines import configs as tconfigs
from s2s_ismr_tpu_torch.pipelines import tune as ttune
from s2s_ismr_tpu_torch.train import checkpoint as tcheckpoint
from s2s_ismr_tpu_torch.train import engine as tengine
from s2s_ismr_tpu_torch.train import splits
from s2s_ismr_tpu_torch.train import sweep as tsweep

EPOCHS = 2
SEED = 42
LR, BS = 1e-4, 32
UNET_SMALL = dict(filters=1, n_blocks=2)


@pytest.fixture(scope="module")
def data():
    """x (T, 16, 16, 1), per-fold one-hot labels, raw targets (NaN over
    the ocean) and two folds of a ten-year synthetic bundle."""
    raw = synthetic.synthetic_hindcast(years=(2003, 2012), seed=9, signal=0.8,
                                       domain=Domain(67, 98, 7, 38), step=2.0)
    b = raw.fillna(0.0)
    fm = splits.bootstrap_masks(b.years, n_bootstraps=2)
    wm = timeutils.week_window_matrix(1)
    y_oh = np.stack([np.nan_to_num(np.asarray(jterciles.one_hot_labels(
        jterciles.fit_and_label(b.y, b.weeks, fm.train[f], wm, None)[0])),
        nan=0.0) for f in range(fm.n_folds)]).astype(np.float32)
    x = b.ensemble_mean()[..., None].astype(np.float32)
    y_det = np.broadcast_to(raw.y[None, ..., None],
                            (fm.n_folds,) + raw.y.shape + (1,)).copy()
    assert np.isnan(y_det).any()
    return x, y_oh, y_det, fm


def jax_epoch_perms(key, epochs, T):
    """engine.py:108, 164-168, 193: the per-epoch permutations."""
    key, _ = jax.random.split(key)
    perms = []
    for ekey in jax.random.split(key, epochs):
        ekey, _ = jax.random.split(ekey)
        perms.append(np.asarray(jax.random.permutation(ekey, T)))
    return np.stack(perms).astype(np.int64)


def jax_lanes(jmodel, x):
    """lane_overrides(fold, trial) -> (the flax init JAX's lane draws,
    converted; its batch orders) from _lane_keys(SEED, fold, trial)."""
    init = jax.jit(lambda k, v: jmodel.init(k, v, train=False))

    def overrides(f, ti):
        key = jsweep._lane_keys(SEED, f, ti)
        _, init_key = jax.random.split(key)
        return (from_flax(init(init_key, jnp.asarray(x[:1]))),
                jax_epoch_perms(key, EPOCHS, x.shape[0]))
    return overrides


ARCHS = {
    "unet": (lambda: JaxUNet(JaxUNetConfig(**UNET_SMALL)),
             lambda g: UNet(UNetConfig(**UNET_SMALL), 1, generator=g)),
    "cnn": (lambda: JaxCNN(),
            lambda g: CNN(generator=g)),
    "mlp": (lambda: JaxMLP(spatial_shape=(16, 16), dropout_rate=0.0),
            lambda g: MLP((16, 16), dropout_rate=0.0, generator=g)),
}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_run_fixed_training_matches_jax(data, arch):
    """training_type='train' (no early exit): every fold's best val loss
    and winner predictions."""
    x, y_oh, _, fm = data
    jmodel, factory = ARCHS[arch][0](), ARCHS[arch][1]
    kw = dict(lr=LR, batch_size=BS, epochs=EPOCHS, patience=5,
              base_seed=SEED, early_exit=False)
    jv, jp, jvars = jsweep.run_fixed_training(
        jmodel, x, y_oh, fm.train, fm.val, **kw)
    res = tsweep.run_fixed_training(
        factory, x, y_oh, fm.train, fm.val, device="cpu",
        lane_overrides=jax_lanes(jmodel, x), **kw)
    assert res.val_loss.shape == (fm.n_folds,)
    np.testing.assert_allclose(res.val_loss, np.asarray(jv), atol=1e-5)
    assert res.predictions.shape == (fm.n_folds,) + x.shape[:3] + (3,)
    np.testing.assert_allclose(res.predictions.numpy(), np.asarray(jp),
                               atol=1e-5)
    assert len(res.winner_variables) == len(jvars) == fm.n_folds
    assert set(res.winner_variables[0]) == set(from_flax(jvars[0]))
    # every epoch ran: steps are the folds' batches of train rows
    assert res.epochs_run == fm.n_folds * EPOCHS
    assert res.train_steps == sum(
        EPOCHS * tengine.train_batches(int(m.sum()), BS) for m in fm.train)


def test_fixed_training_early_exit_and_default_seeds(data):
    """With early exit on and the port's own lane generators, the fixed
    training is deterministic and counts the epochs it ran."""
    x, y_oh, _, fm = data
    kw = dict(lr=5e-2, batch_size=32, epochs=6, patience=1, device="cpu")
    a = tsweep.run_fixed_training(ARCHS["cnn"][1], x, y_oh, fm.train,
                                  fm.val, **kw)
    b = tsweep.run_fixed_training(ARCHS["cnn"][1], x, y_oh, fm.train,
                                  fm.val, **kw)
    assert torch.equal(a.predictions, b.predictions)
    np.testing.assert_array_equal(a.val_loss, b.val_loss)
    assert fm.n_folds * 2 <= a.epochs_run <= fm.n_folds * 6


def test_deterministic_sweep_matches_jax(data):
    """run_unet_sweep(output='deterministic'): the ReLU head trained on
    NaN-masked MSE of raw targets, two trials (lr 1e-4, 3e-5) per fold;
    val-loss table, winners and (F, T, H, W, 1) predictions."""
    x, _, y_det, fm = data
    grid_kw = dict(n_blocks=(2,), n_filters=(1,), ct_kernels=((2, 2),),
                   batch_sizes=(BS,), learning_rates=(LR, 3e-5),
                   patience=5)
    j = jsweep.run_unet_sweep(x, y_det, fm.train, fm.val,
                              jsweep.TuningGrid(**grid_kw), epochs=EPOCHS,
                              base_seed=SEED, output="deterministic")
    jm = JaxUNet(JaxUNetConfig(**UNET_SMALL, ct_kernel=(2, 2),
                               output="deterministic"))
    t = tsweep.run_unet_sweep(x, y_det, fm.train, fm.val,
                              tsweep.TuningGrid(**grid_kw), epochs=EPOCHS,
                              base_seed=SEED, output="deterministic",
                              device="cpu", lane_overrides=jax_lanes(jm, x))
    assert np.isfinite(t.val_loss_table).all()
    np.testing.assert_allclose(t.val_loss_table, j.val_loss_table,
                               rtol=1e-6)
    assert [tr.index for tr in t.best_trial] == \
        [tr.index for tr in j.best_trial]
    assert all(c.output == "deterministic" for c in t.winner_configs)
    assert t.predictions.shape == (fm.n_folds,) + x.shape[:3] + (1,)
    assert (t.predictions >= 0).all()                     # ReLU head
    np.testing.assert_allclose(t.predictions.numpy(),
                               np.asarray(j.predictions), atol=1e-5)


def test_deterministic_to_probs_exact():
    """Each fold's precip predictions categorized with that fold's
    rolling tercile edges, one-hot, NaN rows where the label is NaN:
    identical to JAX's."""
    cfg_j = replace(jconfigs.get_config("tune_ECMWF_com").fast_variant(),
                    years=(2003, 2012))
    cfg_t = replace(tconfigs.get_config("tune_ECMWF_com").fast_variant(),
                    years=(2003, 2012))
    bundles = ttune.load_bundles(cfg_t, synthetic_step=2.0)
    quiet = lambda s: None  # noqa: E731
    js = jtune._nn_setup(cfg_j, bundles, quiet)
    ts = ttune._nn_setup(cfg_t, bundles, quiet, device="cpu")
    b = bundles["ECMWF"]
    rng = np.random.default_rng(0)
    preds = (np.nan_to_num(b.y)[None, ..., None]
             * rng.uniform(0.5, 1.5, (2,) + b.y.shape + (1,))
             ).astype(np.float32)
    want = np.asarray(jtune._deterministic_to_probs(preds, b.weeks, js[6]))
    got = ttune._deterministic_to_probs(torch.tensor(preds), b.weeks, ts[6])
    assert got.shape == preds.shape[:-1] + (3,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0.0, 1.0}
    np.testing.assert_array_equal(want.sum(-1), 1.0)


def test_full_batch_is_one_step_per_epoch(data):
    """test_batch_size.py::test_full_batch_is_one_step_per_epoch: bs = T is
    one optimizer step per epoch; the masked weights still restrict
    learning to the train rows (loss finite, parameters move)."""
    x, y_oh, _, fm = data
    T = x.shape[0]
    assert tengine.train_batches(int(fm.train[0].sum()), T) == 1
    res = tsweep.run_fixed_training(ARCHS["unet"][1], x, y_oh, fm.train[:1],
                                    fm.val[:1], batch_size=T, epochs=3,
                                    patience=3, early_exit=False,
                                    device="cpu")
    assert res.train_steps == 3 and res.epochs_run == 3
    assert np.isfinite(res.val_loss).all()
    init = ARCHS["unet"][1](tsweep.lane_generator(42, 0, 0)).state_dict()
    assert any(not torch.equal(v, init[k])
               for k, v in res.winner_variables[0].items())


# ------------------------------------------------------------ row chunks
@pytest.mark.parametrize("arch, atol", [("unet", 0), ("cnn", 0),
                                        ("mlp", 1e-5)])
def test_predict_row_chunks_equal_one_forward(data, arch, atol,
                                             monkeypatch):
    """predict over more rows than one chunk gives the unchunked forward's
    values (eval rows are independent): exactly on the convs' plain path;
    the MLP's CPU matmul blocks its sums by the row count, so its chunks
    agree to float32 rounding (its forward launches no conv kernel). The
    kernel's pixel limit is lowered so 23 rows of 16x16 need chunks."""
    x = torch.tensor(data[0][:23])
    model = ARCHS[arch][1](torch.Generator().manual_seed(1))
    with torch.no_grad():
        whole = model(x, train=False)
    for rows in (5, 23, 100):
        monkeypatch.setattr(tengine, "MAX_PIXELS", rows * 16 * 16)
        assert tengine.row_chunk(x) == rows
        torch.testing.assert_close(tengine.predict(model, None, x), whole,
                                   rtol=0, atol=atol)


def test_row_chunk_keeps_launches_within_the_kernel_limit():
    from s2s_ismr_tpu_torch.kernels.conv import MAX_PIXELS
    for hw, rows in (((32, 32), 1953), ((64, 64), 488), ((16, 16), 7812)):
        x = torch.zeros((1, *hw, 1))
        assert tengine.row_chunk(x) == rows
        assert rows * hw[0] * hw[1] <= MAX_PIXELS
    # the stacked ECMWF winner forward, 11 x 349 rows on 32x32: two chunks
    assert -(-3839 // tengine.row_chunk(torch.zeros(1, 32, 32, 1))) == 2


# ------------------------------------------------------- default device
def _entry_points(tmp_path):
    cfg = tconfigs.get_config("tune_ECMWF_com").fast_variant()
    x, y, m = np.zeros((4, 8, 8, 1), np.float32), np.zeros(
        (1, 4, 8, 8, 3), np.float32), np.ones((1, 4), bool)
    return {
        "run_pipeline": lambda: ttune.run_pipeline(cfg, log=print),
        "run_nn_branch": lambda: ttune.run_nn_branch(cfg, {}),
        "run_elr_branch": lambda: ttune.run_elr_branch(cfg, {}),
        "run_nn_branch_load": lambda: ttune.run_nn_branch_load(cfg, {}),
        "run_unet_sweep": lambda: tsweep.run_unet_sweep(
            x, y, m, m, cfg.tuning),
        "run_fixed_training": lambda: tsweep.run_fixed_training(
            ARCHS["cnn"][1], x, y, m, m),
        "build_winner": lambda: tsweep.build_winner(UNetConfig(), {}, 1),
        "load_winner": lambda: tcheckpoint.load_winner(str(tmp_path),
                                                       "wk3-4", 0),
        "load_variables": lambda: tcheckpoint.load_variables(
            str(tmp_path / "m.pt")),
    }


@pytest.mark.parametrize("name", [
    "run_pipeline", "run_nn_branch", "run_elr_branch", "run_nn_branch_load",
    "run_unet_sweep", "run_fixed_training", "build_winner", "load_winner",
    "load_variables"])
def test_entry_point_without_device_raises_without_a_card(tmp_path, name):
    """device=None means the card: with every GPU hidden (conftest) the
    entry point raises, telling the caller to pass device='cpu', before
    any work; it never runs on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points(tmp_path)[name]()

"""Port vs JAX: the multi_predictor and stacked predictors at IITM's member
count.

Mirrors tests/test_output_predictor_modes.py (test_pipeline_multi_predictor:
the members as input channels) and the stacked run of
tests/test_torch_modes.py at the 24 members of IITM, on tune_IITM_com's
domain at step 2 (16x16), 2003-2007 (a 0.2 test share, so that five years
split into 3 train, 1 val and 1 test year), n_blocks 3, filters 2: the
multi_predictor U-Net's first conv takes C = 24, and the stacked predictor
tiles the record's 109 rows to 24 x 109 = 2,616. Both sides start every
lane from the same flax initialisation and see the same batch orders, as
in tests/test_torch_fixed.py, whose `jax_lanes` recomputes JAX's lane
keys and feeds them to the port through `lane_overrides`. The val losses and predictions agree
within atol 1e-5, test_torch_fixed.py's tolerance (float32 sum order over
two epochs of Adam at lr 1e-4); the tiled tercile labels and their one-hot
are identical, also when the port sorts the tiled record a slice of
pixels at a time.

The multi_predictor sweep runs on standardized bundles (the pipelines'
`standardize` option). On the raw members (precipitation up to 28, mean
8.4) the 24-channel first conv's sums and the BatchNorm after it round
differently under XLA's CPU conv and torch's: on ten years (2003-2012),
port and JAX drift apart by 1.6e-5 in val loss (5.7e-5 in predictions)
within one epoch, while the
port's two conv paths agree within 2.4e-7 (1.1e-6), and at a tenth of
the scale, or on 1 or 4 of the members, port and JAX agree within 2.4e-7
(3.6e-6). The stacked predictor has one channel and trains on raw values.
The JAX side takes ~45 s on one process, most of it XLA compiles.
"""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.pipelines import configs as jconfigs
from s2s_ismr_tpu.pipelines import tune as jtune
from s2s_ismr_tpu.train import sweep as jsweep
from s2s_ismr_tpu_torch import timeutils
from s2s_ismr_tpu_torch.models import UNet, UNetConfig
from s2s_ismr_tpu_torch.ops import terciles as tterciles
from s2s_ismr_tpu_torch.pipelines import configs as tconfigs
from s2s_ismr_tpu_torch.pipelines import tune as ttune
from s2s_ismr_tpu_torch.train import sweep as tsweep
from test_torch_fixed import BS, EPOCHS, LR, SEED, jax_lanes

# The suite runs in several xdist worker processes on few cores: share the
# cores among them, or torch's intra-op threads oversubscribe the machine.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

MEMBERS = 24
ATOL = 1e-5


def quiet(*a):
    pass


def _cfg(pkg, predictor):
    return replace(pkg.get_config("tune_IITM_com"), years=(2003, 2007),
                   n_bootstraps=2, nn_frac_test=0.2, predictor=predictor)


@pytest.fixture(scope="module")
def bundles():
    b = ttune.load_bundles(_cfg(tconfigs, "mean"), synthetic_step=2.0)
    assert b["IITM"].n_m == MEMBERS and b["IITM"].shape_yx == (16, 16)
    return b


def setups(bundles, predictor):
    """The NN preamble of both packages on the same bundles."""
    return (jtune._nn_setup(_cfg(jconfigs, predictor), bundles, quiet),
            ttune._nn_setup(_cfg(tconfigs, predictor), bundles, quiet,
                            device="cpu"))


@pytest.fixture(scope="module")
def stacked(bundles):
    return setups(bundles, "stacked")


def first_trial():
    """The U-Net of the grid's first trial, as training_type='train' runs
    it: n_blocks 3, filters 2, ct_kernel 2."""
    t0 = tsweep.enumerate_trials(_cfg(tconfigs, "stacked").tuning)[0]
    assert (t0.n_blocks, t0.filters) == (3, 2)
    return dict(filters=t0.filters, n_blocks=t0.n_blocks,
                ct_kernel=t0.ct_kernel)


def test_multi_predictor_sweep_matches_jax(bundles):
    """run_unet_sweep on the 24 members as channels (C = 24 into the first
    conv), the grid's first trial in each fold: val-loss table, winners
    and predictions against JAX's sweep."""
    std = {n: b.standardize() for n, b in bundles.items()}
    js, ts = setups(std, "multi_predictor")
    x = ts[1]["IITM"].predictor_images("multi_predictor")
    assert x.shape[-1] == MEMBERS
    y_oh, fm = np.asarray(js[5]), ts[3]
    np.testing.assert_array_equal(ts[5].numpy(), y_oh)
    ucfg = first_trial()
    grid_kw = dict(n_blocks=(ucfg["n_blocks"],), n_filters=(ucfg["filters"],),
                   ct_kernels=(ucfg["ct_kernel"],), batch_sizes=(BS,),
                   learning_rates=(LR,), patience=5)
    j = jsweep.run_unet_sweep(x, y_oh, fm.train, fm.val,
                              jsweep.TuningGrid(**grid_kw), epochs=EPOCHS,
                              base_seed=SEED)
    t = tsweep.run_unet_sweep(
        x, y_oh, fm.train, fm.val, tsweep.TuningGrid(**grid_kw),
        epochs=EPOCHS, base_seed=SEED, device="cpu",
        lane_overrides=jax_lanes(JaxUNet(JaxUNetConfig(**ucfg)), x))
    assert np.isfinite(t.val_loss_table).all()
    np.testing.assert_allclose(t.val_loss_table, j.val_loss_table,
                               atol=ATOL)
    assert [tr.index for tr in t.best_trial] == \
        [tr.index for tr in j.best_trial]
    w = t.winner_variables[0]["down1_conv1.conv.kernel"]
    assert w.shape[2] == MEMBERS
    assert t.predictions.shape == (fm.n_folds,) + x.shape[:3] + (3,)
    np.testing.assert_allclose(t.predictions.numpy(),
                               np.asarray(j.predictions), atol=ATOL)


@pytest.mark.parametrize("passes", [1, 7])
def test_stacked_labels_match_jax_exactly(bundles, stacked, passes,
                                          monkeypatch):
    """The stacked preamble tiles y and the time axis 24 times; the folds'
    rolling tercile labels on that axis, their one-hot and edges are
    JAX's bit for bit, whether the port sorts all pixels in one pass or
    in 7."""
    rows = MEMBERS * bundles["IITM"].n_t
    monkeypatch.setattr(tterciles, "SORT_ELEMENTS",
                        -(-53 * rows * 256 // passes))
    js, _ = stacked
    ts = ttune._nn_setup(_cfg(tconfigs, "stacked"), bundles, quiet,
                         device="cpu")
    assert ts[4].shape == (2, rows, 16, 16)
    np.testing.assert_array_equal(ts[4], js[4])
    np.testing.assert_array_equal(ts[5].numpy(), np.asarray(js[5]))
    assert np.array_equal(ts[3].train, js[3].train)
    for (je, jp), te, tp in zip(zip(*js[6]), *ts[6]):
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_tercile_sort_passes_stay_within_their_budget(monkeypatch):
    """rolling_edges sorts (53, T, pixels) a slice of pixels at a time,
    each pass within SORT_ELEMENTS, every pixel once. On the card the
    stacked tune_IITM_full (24 x 437 rows of 64x64) needs 17 passes of
    241 pixels; in one pass its sort ran out of the H100's 80 GB."""
    assert -(-4096 // (tterciles.SORT_ELEMENTS // (53 * 24 * 437))) == 17
    sizes = []
    real = tterciles.masked_quantile

    def recording(values, valid, qs, axis):
        sizes.append(torch.broadcast_shapes(values.shape, valid.shape))
        return real(values, valid, qs, axis)
    monkeypatch.setattr(tterciles, "masked_quantile", recording)
    monkeypatch.setattr(tterciles, "SORT_ELEMENTS", 53 * 40 * 30)
    rng = np.random.default_rng(0)
    y = rng.gamma(2.0, 2.0, (40, 9, 11)).astype(np.float32)
    weeks = np.tile(np.arange(20, 40), 2)
    pool = rng.random(40) < 0.7
    wm = timeutils.week_window_matrix(1)
    edges, present = tterciles.rolling_edges(y, weeks, pool, wm)
    assert [s[-1] for s in sizes] == [30, 30, 30, 9]
    assert all(s.numel() <= tterciles.SORT_ELEMENTS for s in sizes)
    assert edges.shape == (53, 2, 9, 11)
    monkeypatch.setattr(tterciles, "SORT_ELEMENTS", 1 << 40)
    whole, _ = tterciles.rolling_edges(y, weeks, pool, wm)
    assert len(sizes) == 5
    np.testing.assert_array_equal(edges.numpy(), whole.numpy())


def test_stacked_fixed_training_matches_jax(bundles, stacked):
    """run_fixed_training (training_type='train': the grid's first trial,
    no early exit) on the 2,616 stacked rows: every fold's best val loss
    and winner predictions against JAX's."""
    js, ts = stacked
    x = ts[1]["IITM"].predictor_images("stacked")
    y_oh, fm = np.asarray(js[5]), ts[3]
    assert x.shape == (MEMBERS * bundles["IITM"].n_t, 16, 16, 1)
    ucfg = first_trial()
    jmodel = JaxUNet(JaxUNetConfig(**ucfg))
    kw = dict(lr=LR, batch_size=BS, epochs=EPOCHS, patience=5,
              base_seed=SEED, early_exit=False)
    jv, jp, _ = jsweep.run_fixed_training(jmodel, x, y_oh, fm.train,
                                          fm.val, **kw)
    res = tsweep.run_fixed_training(
        lambda g: UNet(UNetConfig(**ucfg), 1, generator=g), x, y_oh,
        fm.train, fm.val, device="cpu", lane_overrides=jax_lanes(jmodel, x),
        **kw)
    np.testing.assert_allclose(res.val_loss, np.asarray(jv), atol=ATOL)
    assert res.predictions.shape == (fm.n_folds,) + x.shape[:3] + (3,)
    np.testing.assert_allclose(res.predictions.numpy(), np.asarray(jp),
                               atol=ATOL)
    assert res.epochs_run == fm.n_folds * EPOCHS

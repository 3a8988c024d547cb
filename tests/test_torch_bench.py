"""Port vs JAX: the measurement programs (s2s_ismr_tpu_torch.bench,
probes.roofline, probes.lane_regime) on the CPU at small sizes.

Mirrors bench.py and probes/lane_regime_probe.py: the bench's workload is
built by both packages from the same seed and compared (the JAX one by
importing the probe's build_workload by path); one bench lane trains
through both engines from the same flax init and JAX's batch orders; the
bench's CLI prints bench.py's last line; the roofline's ceiling is
roofline_r5.py's arithmetic and its conv census counts what
chip_smoke.step_launches says; the lane-regime probe's serial and batched
lanes agree. Sizes: 16x16 maps, years 2003-2012 (bootstrap_masks needs
at least 10 years for its val and test years), 2 folds, 4 lanes.
"""

import importlib.util
import json
import math
import pathlib
import re

import jax
import numpy as np
import pytest

import chip_smoke
from s2s_ismr_tpu.train import engine as jengine
from s2s_ismr_tpu_torch import bench
from s2s_ismr_tpu_torch.models import UNet
from s2s_ismr_tpu_torch.models.convert import load_flax
from s2s_ismr_tpu_torch.probes import lane_regime, roofline
from s2s_ismr_tpu_torch.train import engine as tengine

ROOT = pathlib.Path(__file__).resolve().parent.parent
GRID, YEARS, FOLDS, LANES = (16, 16), (2003, 2012), 2, 4


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "lane_regime_probe", ROOT / "probes" / "lane_regime_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def wl():
    return bench.build_workload(GRID, YEARS, 3, folds=FOLDS, lanes=LANES,
                                device="cpu")


@pytest.fixture(scope="module")
def jax_wl():
    return _jax_probe().build_workload(GRID, YEARS, 3, folds=FOLDS,
                                       lanes=LANES)


def test_build_workload_matches_the_jax_probe(wl, jax_wl):
    """x, masks, fold order, learning rates, val rows and the one-hot
    labels equal JAX's exactly (tolerance 0)."""
    model, x, (y_oh, train, val, lrs, _keys), val_rows = jax_wl
    np.testing.assert_array_equal(wl.x.numpy(), np.asarray(x))
    np.testing.assert_array_equal(wl.train, np.asarray(train))
    np.testing.assert_array_equal(wl.val, np.asarray(val))
    np.testing.assert_array_equal(wl.fold_idx, np.arange(LANES) % FOLDS)
    np.testing.assert_array_equal(wl.lrs, np.asarray(lrs))
    assert wl.val_rows == val_rows
    np.testing.assert_array_equal(wl.y.numpy(), np.asarray(y_oh))
    assert (wl.config().filters, wl.config().n_blocks,
            wl.config().ct_kernel) == (model.config.filters,
                                       model.config.n_blocks,
                                       model.config.ct_kernel)


def jax_epoch_perms(key, epochs, T):
    """engine.py:108, 164-168, 193: the per-epoch permutations."""
    key, _ = jax.random.split(key)
    perms = []
    for ekey in jax.random.split(key, epochs):
        ekey, _ = jax.random.split(ekey)
        perms.append(np.asarray(jax.random.permutation(ekey, T)))
    return np.stack(perms).astype(np.int64)


def test_bench_lane_matches_jax_train_fold(wl, jax_wl):
    """Lane 0 of the bench (fold 0, lr 1e-3) through the port's train_fold
    and JAX's, from the same flax init with JAX's batch orders, 2 epochs:
    best val loss within rtol 1e-5."""
    model, x, (y_oh, train, val, lrs, keys), val_rows = jax_wl
    epochs = 2
    init = jax.jit(lambda k, xx: model.init(k, xx, train=False))(
        jax.random.key(7), x[:1])
    js = jengine.TrainSettings(epochs=epochs, batch_size=16,
                               patience=epochs, val_rows=val_rows)
    _, jv, _ = jax.jit(lambda: jengine.train_fold(
        model, x, y_oh[0], train[0], val[0], lrs[0], keys[0], js,
        init_variables=init))()
    tmodel = load_flax(UNet(wl.config(), 1), init)
    _, tv, _ = tengine.train_fold(
        tmodel, wl.x, wl.y[0], wl.train[0], wl.val[0], float(wl.lrs[0]),
        None, wl.settings(epochs),
        epoch_perms=jax_epoch_perms(keys[0], epochs, wl.x.shape[0]))
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)


def test_bench_main_prints_bench_py_last_line(wl, capsys):
    """`bench.main(['--cpu', ...])` at a tiny size: the last line parses
    and holds exactly bench.py's four keys and its metric name; its steps
    are the port's, sum over lanes of epochs x train_batches(n_train, 16),
    exactly."""
    bench.main(["--cpu", "--fast", "--grid", *map(str, GRID), "--lanes",
                "2", "--epochs", "1", "--rounds", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert sorted(last) == ["metric", "unit", "value", "vs_baseline"]
    ref = re.search(r'"metric": "(\w+)"', (ROOT / "bench.py").read_text())
    assert last["metric"] == ref.group(1)
    rep = json.loads(lines[-2])["bench"]
    fast = bench.build_workload(GRID, bench.FAST["years"], 3,
                                bench.FAST["folds"], 2, device="cpu")
    steps = sum(tengine.train_batches(int(fast.train[i].sum()), 16)
                for i in range(2))
    assert rep["variants"]["serial-async/kernel"]["lane_steps"] == steps
    assert f"= {steps} steps run" in last["unit"]
    assert last["value"] > 0 and last["vs_baseline"] > 0
    assert rep["nominal_steps_per_lane"] == math.ceil(rep["T"] / 16)


def test_roofline_ceiling_arithmetic():
    """roofline_r5.py:239-275 on a fixed census and fixed latencies (exact
    up to float rounding, rtol 1e-12)."""
    cc = {"step": {"H32": 7, "H16": 8, "H8": 8, "H4": 4}, "per_step": 27,
          "wgrad": 14, "val": {"H32": 0.5, "H16": 0.5, "H8": 0.5,
                               "H4": 0.25}}
    per_op = {"H32": 6.0, "H16": 5.0, "H8": 4.0, "H4": 3.0}
    got = roofline.ceiling(cc, 600.0, per_op, 2.0, 2000.0)
    conv_us = 7 * 6 + 8 * 5 + 8 * 4 + 4 * 3
    wgrad_us = 14 * 4.5
    val_us = 0.5 * 6 + 0.5 * 5 + 0.5 * 4 + 0.25 * 3
    other_us = (600 - 27 - 14 - 1.75) * 2.0
    floor_us = conv_us + wgrad_us + val_us
    want = {"conv_floor_step_us": floor_us,
            "conv_floor_steps_per_s": 1e6 / floor_us,
            "serialized_sum_step_us": floor_us + other_us,
            "achieved_fraction_of_conv_floor": floor_us / 2000.0,
            "nonconv_latency_hidden_fraction":
                1 - (2000.0 - floor_us) / other_us}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(
        list(got["ceiling_components_us"].values()),
        [conv_us, wgrad_us, val_us, other_us], rtol=1e-12)


def test_roofline_conv_census_equals_step_launches(wl):
    """The census of one epoch of the bench's lane 0, counted on a CPU run
    (conv Function calls per lane step), equals chip_smoke.step_launches
    at n_blocks 3 (14 forward, 13 dx) by level; one wgrad matmul per conv;
    the val forward's 14 convs per val chunk, amortized per step."""
    ce = roofline.epoch_census(wl, log=lambda s: None)
    cc, n = ce["conv_census"], ce["n_steps"]
    fwd, dx = chip_smoke.step_launches(3)
    assert (sum(cc["fwd"].values()), sum(cc["dx"].values())) == (fwd, dx)
    assert cc["fwd"] == {"H16": 4, "H8": 4, "H4": 4, "H2": 2}
    assert cc["dx"] == {"H16": 3, "H8": 4, "H4": 4, "H2": 2}
    assert cc["wgrad"] == fwd
    assert n == tengine.train_batches(int(wl.train[0].sum()), 16)
    assert sum(cc["val"].values()) * n == pytest.approx(
        fwd * ce["val_chunks"], rel=1e-12)


def test_lane_regime_serial_and_batched_agree(wl):
    """The probe's two formulations on 2 lanes x 2 epochs (early exit,
    patience 1): the same epochs run, best val losses within 1e-5."""
    st = wl.settings(2, patience=1, early_exit=True)
    serial, _ = lane_regime.timed(wl, "serial", 2, st)
    vmap, _ = lane_regime.timed(wl, "vmap", 2, st)
    assert serial.epochs == vmap.epochs
    assert serial.lane_steps == vmap.lane_steps
    np.testing.assert_allclose(vmap.best_vloss, serial.best_vloss,
                               rtol=0, atol=1e-5)

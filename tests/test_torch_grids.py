"""Port vs JAX at the structures of the configs' tuning grids, and the
records of `chip_smoke.py` phase 11.

The eight configs' grids reach U-Nets that no other parity test builds:
n_blocks 5 on 32x32 (a 1x1 bottleneck), n_blocks 4, and n_blocks 3 on the
24x24 grid of tune_ECMWF_full, whose pools end on a 3x3 bottleneck that
the ct_kernel 2 / 3 / 5 transposed convs take back to 6x6 with Keras
'same' padding. Mirrors tests/test_models_keras_parity.py (eval forward,
weighted BatchNorm in training, loss gradients) and tests/test_sweep.py
(one sweep lane). JAX runs as its own tests run it: on the CPU, its
default ('auto' = XLA) conv. Also here: the conv shapes the grids give the
kernel (`conv_bench.config_shapes`), the per-trial launch count of
`chip_smoke.expected_launches` against the launches a CPU run makes, and
the port's `suite --check` file. Port calls name their device.
"""

import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.ops import metrics as jmetrics
from s2s_ismr_tpu.pipelines import configs as jconfigs
from s2s_ismr_tpu.pipelines import tune as jtune
from s2s_ismr_tpu.train import sweep as jsweep
from s2s_ismr_tpu.train.losses import categorical_crossentropy as jax_ce
from s2s_ismr_tpu_torch import run
from s2s_ismr_tpu_torch.kernels import conv, conv_bench
from s2s_ismr_tpu_torch.models import UNet, UNetConfig
from s2s_ismr_tpu_torch.models.convert import from_flax, load_flax, to_flax
from s2s_ismr_tpu_torch.ops import metrics as tmetrics
from s2s_ismr_tpu_torch.pipelines import CONFIGS
from s2s_ismr_tpu_torch.pipelines import configs as tconfigs
from s2s_ismr_tpu_torch.pipelines import tune as ttune
from s2s_ismr_tpu_torch.train import engine as tengine
from s2s_ismr_tpu_torch.train import sweep as tsweep
from s2s_ismr_tpu_torch.train.losses import categorical_crossentropy

RTOL, ATOL = 1e-5, 1e-6

# (filters, n_blocks, ct_kernel, grid side, batch): the bottlenecks of
# n_blocks 5 on 32x32 (1x1), n_blocks 3 on 24x24 (3x3, each ct_kernel)
# and n_blocks 4 on 16x16 (1x1)
CASES = {
    "n5_32x32": (1, 5, (2, 2), 32, 2),
    "n3_24x24_ct2": (1, 3, (2, 2), 24, 2),
    "n3_24x24_ct3": (1, 3, (3, 3), 24, 2),
    "n3_24x24_ct5": (1, 3, (5, 5), 24, 2),
    "n4_16x16": (2, 4, (3, 3), 16, 4),
}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_unet_matches_jax_at_grid_structures(case):
    """Eval forward, training forward with weighted BatchNorm (outputs and
    new statistics) and the gradients of the Keras crossentropy, with
    converted flax weights and moved BN statistics, within rtol 1e-5 /
    atol 1e-6."""
    filters, blocks, ck, side, n = CASES[case]
    rng = np.random.default_rng(17)
    x = rng.normal(size=(n, side, side, 1)).astype(np.float32)
    oh = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, side, side))]
    wts = np.array([1.0, 0.0, 1.0, 1.0][:n], np.float32)
    jcfg = JaxUNetConfig(filters=filters, n_blocks=blocks, ct_kernel=ck)
    jm = JaxUNet(jcfg)
    variables = dict(jax.jit(lambda k, v: jm.init(k, v, train=False))(
        jax.random.key(3), jnp.asarray(x)))
    variables["batch_stats"] = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
        .astype(np.float32), variables["batch_stats"])
    tcfg = UNetConfig(filters=filters, n_blocks=blocks, ct_kernel=ck)
    xt, wt = torch.tensor(x), torch.tensor(wts)

    # eval forward: the 1x1 / 3x3 bottleneck and its transposed convs
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    model = load_flax(UNet(tcfg), variables)
    with torch.no_grad():
        got = model(xt, train=False).numpy()
    assert got.shape == (n, side, side, 3)
    _close(got, want, f"{case} eval forward")

    # training forward: weighted batch statistics
    want, mutated = jax.jit(lambda v, a, w: jm.apply(
        v, a, train=True, sample_weight=w, mutable=["batch_stats"]))(
            variables, jnp.asarray(x), jnp.asarray(wts))
    model = load_flax(UNet(tcfg), variables)
    out = model(xt, train=True, sample_weight=wt)
    _close(out.detach().numpy(), np.asarray(want), f"{case} train forward")
    new_stats = to_flax(model)["batch_stats"]
    for path, a in jax.tree_util.tree_leaves_with_path(
            mutated["batch_stats"]):
        node = new_stats
        for p in path:
            node = node[p.key]
        _close(node, np.asarray(a), f"{case} {jax.tree_util.keystr(path)}")

    # loss gradients of every parameter
    def loss(params):
        o, _ = jm.apply({"params": params,
                         "batch_stats": variables["batch_stats"]},
                        jnp.asarray(x), train=True,
                        sample_weight=jnp.asarray(wts),
                        mutable=["batch_stats"])
        return jax_ce(o, jnp.asarray(oh), jnp.asarray(wts))
    grads = from_flax({"params": jax.jit(jax.grad(loss))(
        variables["params"])})
    model = load_flax(UNet(tcfg), variables)
    categorical_crossentropy(model(xt, train=True, sample_weight=wt),
                             torch.tensor(oh), wt).backward()
    params = dict(model.named_parameters())
    assert set(params) == set(grads)
    for name, p in params.items():
        _close(p.grad.numpy(), grads[name].numpy(), f"{case} grad {name}")


# ------------------------------------------------------ one grid lane
EPOCHS = 2
SEED = 42


def jax_epoch_perms(key, epochs, T):
    """s2s_ismr_tpu/train/engine.py:108, 164-168, 193: the per-epoch
    permutations the JAX engine draws from `key`."""
    key, _ = jax.random.split(key)
    perms = []
    for ekey in jax.random.split(key, epochs):
        ekey, _ = jax.random.split(ekey)
        perms.append(np.asarray(jax.random.permutation(ekey, T)))
    return np.stack(perms).astype(np.int64)


def test_blocks_grid_lane_matches_jax():
    """One lane of tune_GEFS_com's _BLOCKS_GRID at its deepest trial with
    filters 2 (n_blocks 5, ct_kernel 2, batch 16, lr 1e-3) on the 32x32
    grid, fold 0, two epochs: JAX's run_unet_sweep against the port's with
    JAX's lane init and batch orders fed through `lane_overrides`. The
    years are cut to ten (2003-2012), the fewest whose bootstrap split
    (val 0.2, test 0.1 of the years) leaves a test year. The val losses
    agree within 1e-5 and the fold's test RPSS within 1e-4 (float32 sum
    order over 20 Adam steps at lr 1e-3, as
    test_torch_slice.py::test_one_lane_rpss_matches_jax)."""
    def cfg(mod):
        c = mod.get_config("tune_GEFS_com")
        return replace(c, years=(2003, 2012), tuning=replace(
            c.tuning, n_blocks=(5,), n_filters=(2,), ct_kernels=((2, 2),)))
    jcfg, tcfg = cfg(jconfigs), cfg(tconfigs)
    bundles = ttune.load_bundles(tcfg)
    quiet = lambda s: None  # noqa: E731
    _, jfilled, _, fm, jlab, jyoh, _ = jtune._nn_setup(jcfg, bundles, quiet)
    _, tfilled, _, _, tlab, tyoh, _ = ttune._nn_setup(tcfg, bundles, quiet,
                                                      device="cpu")
    x = jfilled["GEFS"].predictor_images()
    assert x.shape[1:] == (32, 32, 1)
    tm, vm = fm.train[:1], fm.val[:1]
    j = jsweep.run_unet_sweep(x, jyoh[:1], tm, vm, jcfg.tuning,
                              epochs=EPOCHS, base_seed=SEED)
    jm = JaxUNet(JaxUNetConfig(filters=2, n_blocks=5, ct_kernel=(2, 2)))
    init = jax.jit(lambda k, v: jm.init(k, v, train=False))

    def overrides(f, ti):
        key = jsweep._lane_keys(SEED, f, ti)
        _, init_key = jax.random.split(key)
        return (from_flax(init(init_key, jnp.asarray(x[:1]))),
                jax_epoch_perms(key, EPOCHS, x.shape[0]))
    t = tsweep.run_unet_sweep(x, tyoh[:1], tm, vm, tcfg.tuning,
                              epochs=EPOCHS, base_seed=SEED, device="cpu",
                              lane_overrides=overrides)
    assert [c.n_blocks for c in t.winner_configs] == [5]
    assert np.isfinite(t.val_loss_table).all()
    np.testing.assert_allclose(t.val_loss_table, j.val_loss_table,
                               atol=1e-5)
    climo_j = jmetrics.climo_forecast(jfilled["GEFS"].ensemble_mean())
    want = np.asarray(jmetrics.rpss(climo_j, j.predictions[0],
                                    jnp.asarray(jlab[0]),
                                    jnp.asarray(fm.test[0])))
    climo_t = tmetrics.climo_forecast(tfilled["GEFS"].ensemble_mean())
    got = tmetrics.rpss(climo_t, t.predictions[0], tlab[0],
                        fm.test[0]).numpy()
    assert np.isfinite(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_epochs_table_per_lane():
    """The sweep's epochs_table holds each lane's epochs run, in product
    order: it sums to epochs_run, and with the lanes' batches to
    train_steps; lanes stop at their own epochs (patience 1)."""
    rng = np.random.default_rng(4)
    T = 40
    x = rng.normal(size=(T, 8, 8, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, T, 8, 8))]
    tm = np.zeros((2, T), bool)
    vm = np.zeros((2, T), bool)
    tm[:, :28], vm[:, 28:] = True, True
    tm[1, :4] = False
    grid = tsweep.TuningGrid(n_blocks=(1, 2), n_filters=(1,),
                             ct_kernels=((2, 2),), batch_sizes=(8, 16),
                             learning_rates=(5e-2,), patience=1)
    res = tsweep.run_unet_sweep(x, y, tm, vm, grid, epochs=6, device="cpu")
    trials = tsweep.enumerate_trials(grid)
    tab = res.epochs_table
    assert tab.shape == (2, len(trials)) and (tab >= 2).all()
    assert tab.sum() == res.epochs_run
    assert res.train_steps == sum(
        int(tab[f, t.index]) * tengine.train_batches(int(tm[f].sum()),
                                                     t.batch_size)
        for f in range(2) for t in trials)


# ------------------------------------------------- phase 11's records
# phase 3's 22 U-Net shapes (filters 2 and 3, n_blocks 3, 32x32, batch
# 16) in the order phase 3 times them, so its sums stay comparable
PHASE3 = [(16, 32, 32, 1, 8), (16, 32, 32, 8, 8), (16, 16, 16, 8, 16),
          (16, 16, 16, 16, 16), (16, 8, 8, 16, 32), (16, 8, 8, 32, 32),
          (16, 4, 4, 32, 64), (16, 4, 4, 64, 64), (16, 8, 8, 64, 32),
          (16, 16, 16, 32, 16), (16, 32, 32, 16, 8), (16, 32, 32, 1, 12),
          (16, 32, 32, 12, 12), (16, 16, 16, 12, 24), (16, 16, 16, 24, 24),
          (16, 8, 8, 24, 48), (16, 8, 8, 48, 48), (16, 4, 4, 48, 96),
          (16, 4, 4, 96, 96), (16, 8, 8, 96, 48), (16, 16, 16, 48, 24),
          (16, 32, 32, 24, 12)]


def test_phase3_shapes_unchanged():
    assert conv_bench.slice_shapes(torch, (2, 3), 16, device="cpu") == PHASE3


@pytest.fixture(scope="module")
def grid_shapes():
    """{config: (training shapes, eval shapes)} as phase 11 resolves the
    configs (2 folds)."""
    return {cfg.name: conv_bench.config_shapes(torch, cfg, device="cpu")
            for cfg in chip_smoke.suite_configs()}


def test_grid_shapes_of_the_eight_configs(grid_shapes):
    """134 training shapes, 112 of them new to phase 3; C = O = 384 at
    1x1 and 2x2 maps and 3x3 maps among them; every shape within the
    kernel's channel limit; the eval shapes at the val rows and T of each
    config in row chunks."""
    train = []
    for tr, _ in grid_shapes.values():
        train += [s for s in tr if s not in train]
    assert len(train) == 134
    assert len([s for s in train if s not in PHASE3]) == 112
    for hw in (1, 2):
        assert (16, hw, hw, 384, 384) in train
    assert {s[1] for s in train} == {64, 32, 24, 16, 12, 8, 6, 4, 3, 2, 1}
    assert {s[0] for s in train} == {16, 32}
    assert max(max(s[3:]) for s in train) == conv.MAX_CHANNELS
    tr, ev = grid_shapes["tune_IITM_full"]
    assert tr[0] == (16, 64, 64, 1, 8) and {s[0] for s in ev} == {88, 437}
    assert {s[0] for s in grid_shapes["tune_GEFS_full"][1]} == {132, 655}


@pytest.mark.parametrize("name", ["tune_GEFS_com", "tune_2MME"])
def test_expected_launches_per_trial(name, monkeypatch):
    """chip_smoke.expected_launches counts each lane at its own trial's
    depth and each fold's winner at its winner's, summed over an MME's
    models: equal to the conv calls of a CPU run (counted where the
    wrapper calls its plain version) with n_blocks 1 and 2 in one grid."""
    calls = {"n": 0}
    for fn in ("_conv_call", "_dx_call"):
        real = getattr(conv, fn)

        def counting(*a, real=real):
            calls["n"] += 1
            return real(*a)
        monkeypatch.setattr(conv, fn, counting)
    base = tconfigs.get_config(name)
    cfg = replace(base, years=(2003, 2012), n_bootstraps=2, epochs=3,
                  tuning=replace(base.tuning, n_blocks=(1, 2),
                                 n_filters=(1,), ct_kernels=((2, 2),),
                                 batch_sizes=(32,), patience=1))
    bundles = ttune.load_bundles(cfg, synthetic_step=2)
    nn = ttune.run_nn_branch(cfg, bundles, log=lambda s: None, device="cpu")
    out = ttune.TuneOutputs(config=cfg, elr=None, nn=nn, mask=None)
    want, terms = chip_smoke.expected_launches(torch, out)
    assert calls["n"] == want, terms
    assert len(nn.sweeps) == len(cfg.models)
    assert {t.n_blocks for sw in nn.sweeps.values()
            for t in tsweep.enumerate_trials(cfg.tuning)} == {1, 2}


EXPECTED = os.path.join(os.path.dirname(run.__file__), "expected",
                        "suite_rpss_h100_cut.json")


@pytest.fixture(scope="module")
def expected():
    with open(EXPECTED) as fh:
        return json.load(fh)


def test_expected_file_is_the_one_phase_11_checks(expected):
    """The file ships with the package where chip_smoke looks for it,
    names all eight configs, and its settings are the fingerprint the
    suite writes for the flags phase 11 passes."""
    assert chip_smoke.expected_path() == EXPECTED
    assert sorted(expected["configs"]) == sorted(CONFIGS)
    for means in expected["configs"].values():
        assert set(means) == {"elr_rpss_test_mean", "nn_rpss_test_mean"}
        assert all(np.isfinite(v) for v in means.values())
    args = run._parser().parse_args(chip_smoke.SUITE_ARGV)
    assert expected["settings"] == run.suite_fingerprint(args)
    assert expected["tolerance"] >= 1e-5
    assert expected["backend"] in expected["_comment"]


def test_check_suite_passes_on_the_files_own_numbers(expected):
    results = {n: dict(v, config=n) for n, v in expected["configs"].items()}
    assert run._check_suite(results, EXPECTED) == []


@pytest.mark.parametrize("key", ["elr_rpss_test_mean", "nn_rpss_test_mean"])
def test_check_suite_fails_past_the_tolerance(expected, key, tmp_path):
    """A copy with one config's mean moved by twice the tolerance fails,
    and names that config and key."""
    doc = json.loads(json.dumps(expected))
    doc["configs"]["tune_IITM_full"][key] += 2 * doc["tolerance"]
    path = tmp_path / "moved.json"
    path.write_text(json.dumps(doc))
    results = {n: dict(v) for n, v in expected["configs"].items()}
    failures = run._check_suite(results, str(path))
    assert len(failures) == 1 and f"tune_IITM_full.{key}" in failures[0]

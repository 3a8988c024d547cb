"""The port's run modes end to end on the CPU: `--training-type train`
then `load`, `--output deterministic`, `--predictor multi_predictor` and
`stacked` through the CLI (`run.main`, in-process), the cnn and mlp
through `run_pipeline`, and the JAX package's errors for the modes that do
not compose.

Mirrors tests/test_training_type_train.py, tests/test_output_predictor_modes.py
and tests/test_batch_size.py::test_batch_size_full_train_manifest_records_resolved_bs
(`test_training_type_train.py::test_batch_size_full_train_manifest_records_resolved_bs`),
on the reduced synthetic grid (`--step 2`: 16x16, 2 folds, 2 epochs). Each
run writes the JAX CLI's outputs tree (file names as the JAX code writes
them, `.pt` for `.msgpack`), its winners manifest keeps the JAX schema, and
its test RPSS is finite on land. A load replays the run it loads bit for
bit. Error messages are compared with the JAX package's own.
"""

import dataclasses
import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from s2s_ismr_tpu.pipelines import configs as jconfigs
from s2s_ismr_tpu.pipelines import tune as jtune
from s2s_ismr_tpu.train import checkpoint as jcheckpoint
from s2s_ismr_tpu_torch import run as cli
from s2s_ismr_tpu_torch.pipelines import configs as tconfigs
from s2s_ismr_tpu_torch.pipelines import tune as ttune
from s2s_ismr_tpu_torch.train import checkpoint as tcheckpoint
from s2s_ismr_tpu_torch.train.engine import predict

# The suite runs in several xdist worker processes on few cores: share the
# cores among them, or torch's intra-op threads oversubscribe the machine
# and every worker crawls.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

WK = "wk3-4"
BASE = ["tune_ECMWF_com", "--synthetic", "--fast", "--cpu", "--step", "2",
        "--epochs", "2"]


def quiet(*a):
    pass


def cli_run(out, *argv):
    """run.main(BASE + argv) writing under `out`; returns the run's
    TuneOutputs."""
    outs, real = [], ttune.run_pipeline

    def recording(*a, **kw):
        outs.append(real(*a, **kw))
        return outs[-1]
    ttune.run_pipeline = recording
    try:
        rc = cli.main(BASE + list(argv) + ["--out", str(out)])
    finally:
        ttune.run_pipeline = real
    assert rc == 0 and len(outs) == 1
    return outs[0]


def tree(root, arch, suffix, n_folds=2, models=True):
    """The JAX CLI's outputs tree of a single-model ECMWF run."""
    odir = os.path.join(root, "outputs", "Common Period", "ECMWF_IMD")
    mdir = os.path.join(root, "models", "Common Period", "ECMWF_IMD", WK)
    files = ([f"{odir}/ELR_rpss_{t}_{WK}.nc" for t in ("train", "test")]
             + [f"{odir}/{arch}_rpss_{t}_{WK}.nc"
                for t in ("train", "val", "test")]
             + [f"{odir}/best_hparams_{WK}.json", f"{odir}/profile_{WK}.json"])
    if models:
        files += [f"{mdir}/winners_{WK}.json"] + [
            f"{mdir}/best_model_{arch}_{i}_{suffix}.pt"
            for i in range(n_folds)]
    return sorted(os.path.normpath(p) for p in files)


def out_file(root, name):
    """outputs/Common Period/ECMWF_IMD/{name}_{week}.json"""
    return os.path.join(root, "outputs", "Common Period", "ECMWF_IMD",
                        f"{name}_{WK}.json")


def on_disk(root):
    return sorted(os.path.normpath(os.path.join(r, f))
                  for r, _, fs in os.walk(root) for f in fs)


def manifest(root):
    path = os.path.join(root, "models", "Common Period", "ECMWF_IMD", WK,
                        f"winners_{WK}.json")
    with open(path) as fh:
        return json.load(fh)


def land(out):
    b = ttune.load_bundles(out.config, synthetic_step=2.0)["ECMWF"]
    return b.valid_pixels()


def assert_rpss_finite_on_land(out):
    mask = land(out)
    for split in (out.nn.rpss_train, out.nn.rpss_val, out.nn.rpss_test):
        assert split.values.shape == (2, 16, 16)
        assert np.isfinite(split.values[:, mask]).all()


# --------------------------------------------------- train, then load
@pytest.fixture(scope="module")
def train_load(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    trained = cli_run(root, "--training-type", "train")
    files = on_disk(root)
    with open(out_file(root, "profile")) as fh:
        trained.profile = json.load(fh)     # the load rewrites the file
    loaded = cli_run(root, "--training-type", "load")
    return root, trained, files, loaded


def test_train_writes_the_jax_tree(train_load):
    root, trained, files, _ = train_load
    assert files == tree(str(root), "unet", "trained")
    assert not trained.nn.sweeps and set(trained.nn.fixed_winners) == \
        {"ECMWF"}
    assert_rpss_finite_on_land(trained)


def test_train_manifest_is_the_jax_schema(train_load):
    """save_fixed_winners (checkpoint.py:68-93): the UNetConfig of the
    first grid entry, the hparams trained with, JAX's fingerprint."""
    root, trained, _, _ = train_load
    cfg = trained.config
    fp = jtune.settings_fingerprint(cfg, "synthetic", 0, 2.0)
    _, vloss, ucfg = trained.nn.fixed_winners["ECMWF"]
    for i, e in enumerate(manifest(root)):
        assert set(e) == {"fold", "file", "architecture", "config",
                          "hparams", "val_loss", "input_shape",
                          "fingerprint"}
        assert e["file"] == f"best_model_unet_{i}_trained.pt"
        assert e["architecture"] == "unet" and e["fingerprint"] == fp
        assert e["input_shape"] == [1, 16, 16, 1]
        assert e["val_loss"] == float(vloss[i])
        assert e["hparams"] == {"architecture": "unet", "lr": 1e-3,
                                "batch_size": 16, "ct_kernel": [2, 2],
                                "filters": 2, "blocks": 3}
        jmodel, _ = jcheckpoint._build_model(e, "unet")
        assert dataclasses.asdict(jmodel.config) == dataclasses.asdict(ucfg)
    assert ucfg.n_blocks == cfg.tuning.n_blocks[0]


def test_train_profile_keeps_the_jax_counter(train_load):
    """The fixed branch's profile counts folds x epochs x batches of T
    (tune.py:418-420); the steps that ran are the train rows' batches."""
    _, trained, _, _ = train_load
    T = trained.nn.labels.shape[1]
    assert trained.profile["counters"] == {"train_steps": 2 * 2 * -(-T // 16),
                                "epochs_run": 4}
    masks = trained.nn.masks.train
    assert trained.nn.train_steps == sum(2 * -(-int(m.sum()) // 16)
                                         for m in masks)


def test_load_replays_train_bit_for_bit(train_load):
    """--training-type load after train: the same predictions and RPSS
    maps, bit for bit, and no model file written."""
    root, trained, files, loaded = train_load
    assert on_disk(root) == files
    assert torch.equal(loaded.nn.predictions, trained.nn.predictions)
    for split in ("rpss_train", "rpss_val", "rpss_test"):
        np.testing.assert_array_equal(getattr(loaded.nn, split).values,
                                      getattr(trained.nn, split).values)
    assert loaded.nn.best_hparams == json.loads(json.dumps(
        trained.nn.best_hparams))
    with open(out_file(root, "profile")) as fh:
        assert json.load(fh)["counters"] == {}


# -------------------------------------------------------- deterministic
@pytest.fixture(scope="module")
def deterministic(tmp_path_factory):
    root = tmp_path_factory.mktemp("det")
    return root, cli_run(root, "--output", "deterministic")


def test_deterministic_head_end_to_end(deterministic):
    """test_output_predictor_modes.py::test_pipeline_deterministic_head:
    one-hot categorized predictions, finite RPSS, the saved winner is the
    1-channel ReLU head."""
    root, out = deterministic
    assert on_disk(root) == tree(str(root), "unet", "tuned")
    preds = out.nn.predictions.numpy()
    assert preds.shape[-1] == 3
    vals = preds[np.isfinite(preds).all(-1)]
    assert set(np.unique(vals)) <= {0.0, 1.0}
    np.testing.assert_array_equal(vals.sum(-1), 1.0)
    assert_rpss_finite_on_land(out)
    mdir = os.path.join(root, "models", "Common Period", "ECMWF_IMD", WK)
    model, _ = tcheckpoint.load_winner(mdir, WK, 0, device="cpu")
    y = predict(model, None, torch.zeros(1, 16, 16, 1))
    assert y.shape == (1, 16, 16, 1) and (y >= 0).all()
    assert all(e["config"]["output"] == "deterministic"
               for e in manifest(root))


def test_deterministic_load_and_fingerprint(deterministic):
    """The load converts through the same categorization, bit-equal; a
    proba-head load over deterministic winners trips the fingerprint."""
    root, out = deterministic
    loaded = ttune.run_pipeline(out.config, out_root=str(root),
                                synthetic_step=2.0, log=quiet,
                                training_type="load", device="cpu")
    assert torch.equal(loaded.nn.predictions, out.nn.predictions)
    with pytest.raises(ValueError, match="different settings"):
        ttune.run_pipeline(replace(out.config, output="proba"),
                           out_root=str(root), synthetic_step=2.0,
                           log=quiet, training_type="load", device="cpu")


# ------------------------------------------------------------ predictors
def test_multi_predictor_end_to_end(tmp_path):
    """test_output_predictor_modes.py::test_pipeline_multi_predictor: the
    members are input channels, recorded in the manifest's input shape."""
    out = cli_run(tmp_path, "--predictor", "multi_predictor")
    assert on_disk(tmp_path) == tree(str(tmp_path), "unet", "tuned")
    n_m = ttune.load_bundles(out.config, synthetic_step=2.0)["ECMWF"].n_m
    assert n_m > 1
    assert all(e["input_shape"] == [1, 16, 16, n_m]
               for e in manifest(tmp_path))
    w = out.nn.sweeps["ECMWF"].winner_variables[0]["down1_conv1.conv.kernel"]
    assert w.shape[2] == n_m
    assert out.nn.predictions.shape[-1] == 3
    assert_rpss_finite_on_land(out)


def test_stacked_end_to_end(tmp_path):
    """--predictor stacked: members are extra rows (M*T); labels, splits
    and metrics run on the tiled axis."""
    out = cli_run(tmp_path, "--predictor", "stacked", "--batch-size", "64")
    assert on_disk(tmp_path) == tree(str(tmp_path), "unet", "tuned")
    b = ttune.load_bundles(out.config, synthetic_step=2.0)["ECMWF"]
    assert tuple(out.nn.predictions.shape) == (2, b.n_m * b.n_t, 16, 16, 3)
    assert out.nn.labels.shape == (2, b.n_m * b.n_t, 16, 16)
    assert all(e["input_shape"] == [1, 16, 16, 1] for e in manifest(tmp_path))
    assert_rpss_finite_on_land(out)


# ----------------------------------------------------------- cnn and mlp
def _fast_cfg(**over):
    cfg = replace(tconfigs.get_config("tune_ECMWF_com").fast_variant(
        epochs=2))
    return replace(cfg, **over)


def test_cnn_fixed_training_and_load(tmp_path):
    """test_training_type_train.py::test_cnn_fixed_load_roundtrip: the cnn
    trains one configuration per fold (training.py:53-64), writes
    cnn_rpss_* and *_trained winners, and replays bit for bit."""
    cfg = _fast_cfg(architecture="cnn")
    kw = dict(out_root=str(tmp_path), synthetic_step=2.0, log=quiet,
              device="cpu")
    ran = ttune.run_pipeline(cfg, **kw)
    assert on_disk(tmp_path) == tree(str(tmp_path), "cnn", "trained")
    assert all(e["config"] is None and e["architecture"] == "cnn"
               for e in manifest(tmp_path))
    assert_rpss_finite_on_land(ran)
    loaded = ttune.run_pipeline(cfg, training_type="load", **kw)
    assert torch.equal(loaded.nn.predictions, ran.nn.predictions)
    np.testing.assert_array_equal(loaded.nn.rpss_test.values,
                                  ran.nn.rpss_test.values)
    assert loaded.nn.best_hparams[0]["ECMWF"]["architecture"] == "cnn"


def test_mlp_train_mode_runs(tmp_path):
    """test_training_type_train.py::test_mlp_train_mode_runs: 'train'
    reaches the mlp (no early exit, all epochs; dropout 0.3 from the
    lane's generator)."""
    out = ttune.run_pipeline(_fast_cfg(architecture="mlp"),
                             out_root=str(tmp_path), synthetic_step=2.0,
                             log=quiet, training_type="train", device="cpu")
    _, vloss, ucfg = out.nn.fixed_winners["ECMWF"]
    assert ucfg is None and np.isfinite(vloss).all()
    assert out.nn.epochs_run == 2 * 2
    assert on_disk(tmp_path) == tree(str(tmp_path), "mlp", "trained")
    assert_rpss_finite_on_land(out)


def test_batch_size_full_train_manifest_records_resolved_bs(tmp_path):
    """`--batch-size full --training-type train`: the manifest records the
    resolved batch size (T), as best_hparams does."""
    out = cli_run(tmp_path, "--batch-size", "full", "--training-type",
                  "train")
    bs = manifest(tmp_path)[0]["hparams"]["batch_size"]
    assert bs == out.nn.labels.shape[1] > 0
    assert bs == out.nn.best_hparams[0]["ECMWF"]["batch_size"]
    with open(out_file(tmp_path, "best_hparams")) as fh:
        assert json.load(fh)[0]["ECMWF"]["batch_size"] == bs
    assert out.nn.train_steps == 2 * 2      # one step per epoch and fold


# ---------------------------------------------------------- error paths
def _small(mod, name="tune_ECMWF_com", **over):
    return replace(mod.get_config(name).fast_variant(epochs=1),
                   years=(2003, 2012), **over)


@pytest.fixture(scope="module")
def small_bundles():
    return {name: ttune.load_bundles(_small(tconfigs, name),
                                     synthetic_step=4.0)
            for name in ("tune_ECMWF_com", "tune_2MME")}


def _same_error(exc, jax_call, port_call):
    with pytest.raises(exc) as want:
        jax_call()
    with pytest.raises(exc) as got:
        port_call()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("name, over, match", [
    ("tune_2MME", dict(predictor="stacked"), "not supported for MME"),
    ("tune_ECMWF_com", dict(output="deterministic", architecture="cnn"),
     "only available for the U-Net"),
    ("tune_ECMWF_com", dict(output="deterministic", architecture="mlp"),
     "only available for the U-Net"),
    ("tune_ECMWF_com", dict(output="deterministic", predictor="stacked"),
     "does not compose")])
def test_mode_errors_are_jax_errors(small_bundles, name, over, match):
    b = small_bundles[name]
    msg = _same_error(
        ValueError,
        lambda: jtune.run_nn_branch(_small(jconfigs, name, **over), b,
                                    log=quiet),
        lambda: ttune.run_nn_branch(_small(tconfigs, name, **over), b,
                                    log=quiet, device="cpu"))
    assert match in msg


def _write_manifest(root, entries):
    mdir = os.path.join(root, "models", "Common Period", "ECMWF_IMD", WK)
    os.makedirs(mdir)
    with open(os.path.join(mdir, f"winners_{WK}.json"), "w") as fh:
        json.dump(entries, fh)


@pytest.mark.parametrize("case", ["no_manifest", "missing_folds",
                                  "fingerprint"])
def test_load_errors_are_jax_errors(small_bundles, tmp_path, case):
    """run_nn_branch_load refuses a missing manifest, a manifest lacking
    folds and one saved under other settings, with JAX's messages."""
    b = small_bundles["tune_ECMWF_com"]
    fp = {"predictor": "mean", "seed": 0}
    if case == "missing_folds":
        _write_manifest(tmp_path, [{"fold": 0, "fingerprint": None}])
    elif case == "fingerprint":
        _write_manifest(tmp_path, [{"fold": f, "fingerprint": {
            "predictor": "stacked", "seed": 0}} for f in range(2)])
    exc = FileNotFoundError if case == "no_manifest" else ValueError
    msg = _same_error(
        exc,
        lambda: jtune.run_nn_branch_load(_small(jconfigs), b,
                                         out_root=str(tmp_path), log=quiet,
                                         fingerprint=fp),
        lambda: ttune.run_nn_branch_load(_small(tconfigs), b,
                                         out_root=str(tmp_path), log=quiet,
                                         fingerprint=fp, device="cpu"))
    assert {"no_manifest": "no winner manifest",
            "missing_folds": "lacks folds [1]",
            "fingerprint": "different settings"}[case] in msg

"""Port vs JAX: the tune pipeline as a whole — the ELR branch, MME
blending, the skill mask, winner checkpoints and run_pipeline.

Mirrors tests/test_elr.py::test_elr_folds_end_to_end at full size, the
checkpoint tests of tests/test_attrib_checkpoint_realtime.py
(test_checkpoint_roundtrip, test_sweep_winner_save_load,
test_pipeline_persists_winners), the outputs-tree checks of
tests/test_run_cli.py::test_week_override_pipeline_end_to_end, and
run_pipeline's make_plots figures (against JAX's run_pipeline) and
profile_dir traces (s2s_ismr_tpu/pipelines/tune.py:786-825, 876-894).
Every port call names its device (`device="cpu"`): the library defaults
to the card.
Tolerances (float32): labels bit-equal; ELR probabilities within 1e-4 and
RPSS maps within 1e-5 of JAX, NaN pattern identical; a winner reloaded
from disk predicts bit for bit what the sweep did (same code, same device).
"""

import dataclasses
import json
import os
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from s2s_ismr_tpu.data import gateway as jgateway
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.pipelines import configs as jconfigs
from s2s_ismr_tpu.pipelines import tune as jtune
from s2s_ismr_tpu.train import checkpoint as jcheckpoint
from s2s_ismr_tpu_torch.data import gateway as tgateway
from s2s_ismr_tpu_torch.data import synthetic
from s2s_ismr_tpu_torch.io import read_netcdf
from s2s_ismr_tpu_torch.ops import elr as telr
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


def quiet(*a):
    pass


def _elr_both(name, step=None):
    """run_elr_branch of JAX and the port on one synthetic bundle."""
    bundles = ttune.load_bundles(tconfigs.get_config(name),
                                 synthetic_step=step)
    j = jtune.run_elr_branch(jconfigs.get_config(name), bundles, log=quiet)
    t = ttune.run_elr_branch(tconfigs.get_config(name), bundles, log=quiet,
                             device="cpu")
    return bundles, j, t


def _assert_elr_close(j, t):
    np.testing.assert_array_equal(t.labels, j.labels)          # NaN == NaN
    for split in ("train", "test"):
        np.testing.assert_array_equal(getattr(t.masks, split),
                                      getattr(j.masks, split))
    pj, pt = np.asarray(j.test_probs), t.test_probs.numpy()
    assert pt.shape == pj.shape
    np.testing.assert_array_equal(np.isnan(pt), np.isnan(pj))
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    for split in ("rpss_train", "rpss_test"):
        a, b = getattr(j, split), getattr(t, split)
        assert b.dims == a.dims == ("bootstrap", "Y", "X")
        np.testing.assert_array_equal(np.isnan(b.values), np.isnan(a.values))
        np.testing.assert_allclose(b.values, a.values, atol=1e-5)
        assert np.isfinite(b.values).any()


def test_run_elr_branch_full_ecmwf_com_matches_jax():
    """The whole tune_ECMWF_com ELR branch: 10 folds, 32x32, T = 349."""
    _, j, t = _elr_both("tune_ECMWF_com")
    assert t.test_probs.shape == (10, 349, 32, 32, 3)
    _assert_elr_close(j, t)


def test_mme_elr_blend_matches_jax():
    """tune_2MME at step 2 (16x16, 10 folds): the cross-model mean obs for
    the labels, one GLM per model, the blend before RPSS."""
    bundles, j, t = _elr_both("tune_2MME", step=2.0)
    assert list(bundles) == ["IITM", "ECMWF"]
    assert t.test_probs.shape == (10, 349, 16, 16, 3)
    _assert_elr_close(j, t)
    # the blend propagates the NaN of a pixel either model skipped
    assert np.isnan(t.test_probs.numpy()).any()


@pytest.fixture(scope="module")
def mme_small():
    cfg = replace(tconfigs.get_config("tune_2MME").fast_variant(epochs=1),
                  years=(2003, 2012))
    return cfg, ttune.load_bundles(cfg, synthetic_step=2)


def test_mme_nn_setup_labels_match_jax(mme_small):
    """_nn_setup of an MME config labels the cross-model mean obs."""
    cfg, bundles = mme_small
    jcfg = replace(jconfigs.get_config("tune_2MME").fast_variant(epochs=1),
                   years=(2003, 2012))
    js = jtune._nn_setup(jcfg, bundles, quiet)
    ts = ttune._nn_setup(cfg, bundles, quiet, device="cpu")
    np.testing.assert_array_equal(ts[4], js[4])
    np.testing.assert_array_equal(ts[5].numpy(), np.asarray(js[5]))


def test_mme_nn_branch_blends_models(mme_small):
    cfg, bundles = mme_small
    res = ttune.run_nn_branch(cfg, bundles, log=quiet, device="cpu")
    assert list(res.sweeps) == ["IITM", "ECMWF"]
    want = telr.blend_probabilities([res.sweeps[n].predictions
                                     for n in res.sweeps])
    assert torch.equal(res.predictions, want)
    assert [set(h) for h in res.best_hparams] == [{"IITM", "ECMWF"}] * 2
    land = ~np.isnan(np.mean([b.y for b in bundles.values()], 0)).any(0)
    assert np.isfinite(res.rpss_test.values[:, land]).all()


def test_skill_mask_matches_jax(rng):
    labels = rng.integers(0, 3, (2, 40, 5, 6)).astype(np.float32)
    labels[0, :, 0, 0] = 1.0                      # one class only
    labels[0, :, 1, 1] = np.where(rng.random(40) < 0.5, 0.0, 2.0)
    labels[0, ::3, 2, 2] = np.nan
    test = np.zeros((2, 40), bool)
    test[0, 30:] = True
    y_raw = rng.normal(size=(40, 5, 6)).astype(np.float32)
    y_raw[7, 4, 5] = np.nan
    nn = SimpleNamespace(labels=labels, masks=SimpleNamespace(test=test))
    got = ttune.skill_mask(nn, y_raw)
    np.testing.assert_array_equal(got, jtune.skill_mask(nn, y_raw))
    assert got[0, 0] and got[1, 1] and got[4, 5] and not got.all()


def test_settings_fingerprint_matches_jax():
    for name in ("tune_ECMWF_com", "tune_2MME"):
        args = ("synthetic", 3, 2.0)
        assert ttune.settings_fingerprint(tconfigs.get_config(name), *args) \
            == jtune.settings_fingerprint(jconfigs.get_config(name), *args)


def test_iridl_source_through_a_fake_gateway(monkeypatch):
    """load_bundles(source='iridl') calls the port's gateway per model and
    aligns MME time axes at the midpoint (tune_MME.py:66-81), as JAX does
    through its own gateway."""
    calls = []

    def fake_get_data(**kw):
        calls.append(kw)
        b = synthetic.synthetic_hindcast(
            model=kw["model"], years=(2003, 2005), step=4.0,
            lead=kw["custom_lead"], seed=len(calls))
        return b.x_field(), b.y_field()

    monkeypatch.setattr(tgateway, "get_data", fake_get_data)
    monkeypatch.setattr(jgateway, "get_data", fake_get_data)
    cfg = tconfigs.get_config("tune_2MME")
    got = ttune.load_bundles(cfg, source="iridl")
    t_calls, calls[:] = list(calls), []
    want = jtune.load_bundles(jconfigs.get_config("tune_2MME"),
                              source="iridl")
    assert t_calls == calls
    assert [c["custom_lead"] for c in calls] == [(16, 29), (16, 30)]
    assert list(got) == list(want) == ["IITM", "ECMWF"]
    for n in got:
        for f in ("x", "y", "t", "lats", "lons", "name"):
            np.testing.assert_array_equal(getattr(got[n], f),
                                          getattr(want[n], f))
    with pytest.raises(ValueError, match="unknown source"):
        ttune.load_bundles(cfg, source="nope")


# --------------------------------------------------- run_pipeline, checkpoints
def _fast_cfg(mod):
    return replace(mod.get_config("tune_ECMWF_com").fast_variant(epochs=2),
                   years=(2003, 2012))


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("run"))
    out = ttune.run_pipeline(_fast_cfg(tconfigs), source="synthetic",
                             out_root=root, synthetic_step=2.0, log=quiet,
                             device="cpu")
    return root, out


def test_run_pipeline_outputs_tree(pipeline_run):
    """The JAX CLI's outputs tree, file by file (tune.py:783, 836-863)."""
    root, out = pipeline_run
    wk = out.config.week
    odir = os.path.join(root, "outputs", "Common Period", "ECMWF_IMD")
    mdir = os.path.join(root, "models", "Common Period", "ECMWF_IMD", wk)
    files = {
        "elr_train": f"{odir}/ELR_rpss_train_{wk}.nc",
        "elr_test": f"{odir}/ELR_rpss_test_{wk}.nc",
        "nn_train": f"{odir}/unet_rpss_train_{wk}.nc",
        "nn_val": f"{odir}/unet_rpss_val_{wk}.nc",
        "nn_test": f"{odir}/unet_rpss_test_{wk}.nc",
        "hparams": f"{odir}/best_hparams_{wk}.json",
        "profile": f"{odir}/profile_{wk}.json",
        "winners_ECMWF": f"{mdir}/winners_{wk}.json"}
    assert {k: os.path.normpath(v) for k, v in out.paths.items()} == \
        {k: os.path.normpath(v) for k, v in files.items()}
    on_disk = sorted(os.path.join(r, f) for r, _, fs in os.walk(root)
                     for f in fs)
    weights = [f"{mdir}/best_model_unet_{i}_tuned.pt" for i in range(2)]
    assert on_disk == sorted(os.path.normpath(p)
                             for p in list(files.values()) + weights)
    for key, fld in (("elr_test", out.elr.rpss_test),
                     ("nn_val", out.nn.rpss_val),
                     ("nn_test", out.nn.rpss_test)):
        back = read_netcdf(files[key])
        assert back.dims == ("bootstrap", "Y", "X")
        np.testing.assert_array_equal(back.values, fld.values)
    with open(files["hparams"]) as fh:
        hp = json.load(fh)
    assert len(hp) == 2 and all(set(h) == {"ECMWF"} for h in hp)
    with open(files["profile"]) as fh:
        prof = json.load(fh)
    assert set(prof["stages_s"]) == {"data", "elr", "nn"}
    sw = out.nn.sweeps["ECMWF"]
    assert prof["counters"] == {"train_steps": sw.train_steps,
                                "epochs_run": sw.epochs_run}
    assert out.mask.shape == (16, 16) and out.mask.dtype == bool
    assert out.elapsed_s > 0 and out.figures == {}
    assert [f.name for f in dataclasses.fields(out)] == \
        [f.name for f in dataclasses.fields(jtune.TuneOutputs)]


def test_winner_manifest_schema_and_jax_config(pipeline_run):
    """winners_{week}.json keeps the JAX schema; its config loads into
    JAX's UNetConfig, and the fingerprint is JAX's."""
    root, out = pipeline_run
    wk = out.config.week
    mdir = os.path.join(root, "models", "Common Period", "ECMWF_IMD", wk)
    with open(os.path.join(mdir, f"winners_{wk}.json")) as fh:
        manifest = json.load(fh)
    sw = out.nn.sweeps["ECMWF"]
    fp = jtune.settings_fingerprint(_fast_cfg(jconfigs), "synthetic", 0, 2.0)
    for i, e in enumerate(manifest):
        assert set(e) == {"fold", "file", "architecture", "config",
                          "hparams", "val_loss", "input_shape",
                          "fingerprint"}
        assert e["fold"] == i and e["file"] == f"best_model_unet_{i}_tuned.pt"
        assert e["input_shape"] == [1, 16, 16, 1]
        assert e["fingerprint"] == fp
        assert e["val_loss"] == float(sw.best_val_loss[i])
        assert e["hparams"] == json.loads(json.dumps(
            sw.best_trial[i].hparams()))
        jmodel, _ = jcheckpoint._build_model(e, "unet")
        assert jmodel.config == JaxUNetConfig(**{
            **e["config"], "ct_kernel": tuple(e["config"]["ct_kernel"]),
            "ct_stride": tuple(e["config"]["ct_stride"])})
        assert dataclasses.asdict(jmodel.config) == \
            dataclasses.asdict(sw.winner_configs[i])


def test_checkpoint_round_trip_replays_the_sweep(pipeline_run):
    """save -> load_winner -> forward equals the sweep's predictions."""
    root, out = pipeline_run
    wk = out.config.week
    mdir = os.path.join(root, "models", "Common Period", "ECMWF_IMD", wk)
    b = ttune.load_bundles(out.config, synthetic_step=2.0)["ECMWF"]
    x = torch.as_tensor(b.fillna(0.0).predictor_images("mean"))
    sw = out.nn.sweeps["ECMWF"]
    for f in range(2):
        model, variables = tcheckpoint.load_winner(mdir, wk, f,
                                                   device="cpu")
        assert model.config == sw.winner_configs[f]
        for k, v in sw.winner_variables[f].items():
            assert torch.equal(variables[k], v), k
        assert torch.equal(predict(model, None, x), out.nn.predictions[f])


def test_save_load_variables_round_trip(tmp_path):
    """test_attrib_checkpoint_realtime.py::test_checkpoint_roundtrip."""
    from s2s_ismr_tpu_torch.models import UNet, UNetConfig
    model = UNet(UNetConfig(filters=1, n_blocks=2),
                 generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    p = tcheckpoint.save_variables(state, str(tmp_path / "w" / "m.pt"))
    loaded = tcheckpoint.load_variables(p, device="cpu")
    assert list(loaded) == list(state)
    for k in state:
        assert torch.equal(loaded[k], state[k])


@pytest.mark.parametrize("arch, shape", [("cnn", [1, 16, 16, 1]),
                                         ("mlp", [1, 8, 12, 3])])
def test_load_winner_cnn_mlp(tmp_path, arch, shape):
    """test_attrib_checkpoint_realtime.py / test_training_type_train.py:
    a cnn or mlp winner saved by save_fixed_winners (`*_trained`, config
    null) is rebuilt from the manifest's architecture and input shape and
    holds the saved state."""
    make = tcheckpoint.model_factory(arch, shape, device="cpu")
    state = make(torch.Generator().manual_seed(3)).state_dict()
    tcheckpoint.save_fixed_winners([state], [0.5], str(tmp_path), "wk3-4",
                                   arch, input_shape=shape,
                                   hparams={"architecture": arch})
    with open(tmp_path / "winners_wk3-4.json") as fh:
        entry = json.load(fh)[0]
    assert entry["file"] == f"best_model_{arch}_0_trained.pt"
    assert entry["config"] is None and entry["input_shape"] == shape
    model, variables = tcheckpoint.load_winner(str(tmp_path), "wk3-4", 0,
                                               device="cpu")
    assert type(model).__name__ == arch.upper()
    for k, v in state.items():
        assert torch.equal(variables[k], v) and torch.equal(
            model.state_dict()[k], v), k
    x = torch.zeros((2, *shape[1:]))
    assert predict(model, None, x).shape == (2, *shape[1:3], 3)


def test_unknown_training_type_raises():
    """run_pipeline refuses a training_type other than tune / train / load
    with JAX's message, before any work."""
    for mod in (jtune, ttune):
        with pytest.raises(ValueError, match="training_type must be"):
            mod.run_pipeline(_fast_cfg(tconfigs), log=quiet,
                             training_type="fit")


@pytest.fixture(scope="module")
def plotted_run(tmp_path_factory):
    """run_pipeline with make_plots and profile_dir, one epoch."""
    root = str(tmp_path_factory.mktemp("plots"))
    prof = os.path.join(root, "trace")
    out = ttune.run_pipeline(replace(_fast_cfg(tconfigs), epochs=1),
                             out_root=root, synthetic_step=2.0, log=quiet,
                             make_plots=True, profile_dir=prof, device="cpu")
    return root, prof, out


def test_run_pipeline_make_plots_figures_match_jax(plotted_run, tmp_path):
    """make_plots draws JAX's figure set (tune.py:876-894): the ELR and NN
    RPSS panels and the three per-category reliability comparisons, under
    the same paths as JAX's run_pipeline on the same config."""
    root, _, out = plotted_run
    jout = jtune.run_pipeline(replace(_fast_cfg(jconfigs), epochs=1),
                              out_root=str(tmp_path), synthetic_step=2.0,
                              log=quiet, make_plots=True)
    rel = {k: os.path.relpath(v, root) for k, v in out.figures.items()}
    assert rel == {k: os.path.relpath(v, str(tmp_path))
                   for k, v in jout.figures.items()}
    assert set(out.figures) == {
        "wk34_RPSS_ELR", "wk34_RPSS_UNET", "wk3_4_Below_Normal.pdf",
        "wk3_4_Normal.pdf", "wk3_4_Above_Normal.pdf"}
    assert all(os.path.getsize(p) > 1000 for p in out.figures.values())


def _trace_events(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert events
    return events


@pytest.mark.parametrize("training_type", ["tune", "load"])
def test_run_pipeline_profile_dir_writes_traces(plotted_run, tmp_path,
                                                training_type):
    """profile_dir: a Chrome trace of the ELR stage in profile_dir and one
    of the NN stage in profile_dir/nn (tune.py:786-825); a load traces
    only the ELR stage. On the CPU the traces hold torch ops only."""
    root, prof, out = plotted_run
    if training_type == "load":
        prof = str(tmp_path / "trace")
        ttune.run_pipeline(replace(_fast_cfg(tconfigs), epochs=1),
                           out_root=root, synthetic_step=2.0, log=quiet,
                           profile_dir=prof, training_type="load",
                           device="cpu")
    assert sorted(os.listdir(prof)) == (
        ["trace.json"] if training_type == "load" else ["nn", "trace.json"])
    ops = {e.get("name") for e in _trace_events(
        os.path.join(prof, "trace.json"))}
    assert not any("conv" in str(n) for n in ops)    # ELR: no convolution
    if training_type == "tune":
        nn = _trace_events(os.path.join(prof, "nn", "trace.json"))
        assert any(e.get("cat") == "cpu_op" for e in nn)
        assert not any(e.get("cat") == "kernel" for e in nn)   # CPU run

"""The --week x persistence seams on the port: its mirror of
tests/test_week_persistence.py, case for case, on the CPU.

The weeks cross product (`suite --week`) writes winners under
models/{dir}/{model}_{obs}/{week} per week and outputs under
outputs/{dir}/{model}_{obs}/*_{week}.nc: the filesystem contract between
the tune runs, training_type='load', realtime and the barplot. These
tests drive those seams end to end from files the port itself wrote: load
and realtime replay the right week's winners and refuse a week mismatch
(by path or by fingerprint), and a real `suite --week` tree feeds
run_barplot with no row synthesised. The JAX file marks its cases `slow`;
the port's run them in ~50 s on one thread, so they stay in tier-1. Where
the port raises, its message is compared with the JAX package's own on
the same tree (`_same_error`).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from s2s_ismr_tpu.pipelines import configs as jconfigs
from s2s_ismr_tpu.pipelines import realtime as jrealtime
from s2s_ismr_tpu.pipelines import tune as jtune
from s2s_ismr_tpu_torch import run as cli
from s2s_ismr_tpu_torch.pipelines import configs as tconfigs
from s2s_ismr_tpu_torch.pipelines import notebooks
from s2s_ismr_tpu_torch.pipelines import realtime as trealtime
from s2s_ismr_tpu_torch.pipelines import tune as ttune
from test_torch_modes import _same_error

# The suite runs in several xdist worker processes on few cores: share the
# cores among them, or torch's intra-op threads oversubscribe the machine.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

STEP = 2.0


def quiet(*a):
    pass


def _wk_cfg(week, pkg=tconfigs):
    return dataclasses.replace(
        pkg.get_config("tune_ECMWF_com").fast_variant(),
        years=(2003, 2012), epochs=3).with_week(week)


def run(week, root, **kw):
    return ttune.run_pipeline(_wk_cfg(week), out_root=str(root),
                              synthetic_step=STEP, log=quiet, device="cpu",
                              **kw)


def mdir(root, week):
    return os.path.join(str(root), "models", "Common Period", "ECMWF_IMD",
                        week)


@pytest.fixture(scope="module")
def wk1_tree(tmp_path_factory):
    """One wk1 fast tune run of the port: outputs and persisted winners."""
    root = tmp_path_factory.mktemp("wk1run")
    return root, run("wk1", root)


@pytest.fixture
def copied_wk2(wk1_tree):
    """The wk1 winners copied under wk2, the manifest renamed (the
    checkpoint names carry no week); removed after the test."""
    root, _ = wk1_tree
    shutil.copytree(mdir(root, "wk1"), mdir(root, "wk2"))
    os.rename(os.path.join(mdir(root, "wk2"), "winners_wk1.json"),
              os.path.join(mdir(root, "wk2"), "winners_wk2.json"))
    yield root
    shutil.rmtree(mdir(root, "wk2"))


def load_both(root, week):
    """run_nn_branch_load of the JAX package and of the port on the same
    tree, each with its own fingerprint of the week's run."""
    bundles = ttune.load_bundles(_wk_cfg(week), synthetic_step=STEP)
    jcfg, tcfg = _wk_cfg(week, jconfigs), _wk_cfg(week)
    return (lambda: jtune.run_nn_branch_load(
                jcfg, bundles, out_root=str(root), log=quiet,
                fingerprint=jtune.settings_fingerprint(
                    jcfg, "synthetic", 0, STEP)),
            lambda: ttune.run_nn_branch_load(
                tcfg, bundles, out_root=str(root), log=quiet, device="cpu",
                fingerprint=ttune.settings_fingerprint(
                    tcfg, "synthetic", 0, STEP)))


def test_load_replays_the_tuned_week(wk1_tree):
    """training_type='load' with --week wk1 replays the wk1 winners bit
    for bit; a load for a week never tuned fails on the missing manifest,
    with JAX's message, instead of falling back to another week."""
    root, tuned = wk1_tree
    loaded = run("wk1", root, training_type="load")
    assert torch.equal(loaded.nn.predictions, tuned.nn.predictions)
    np.testing.assert_array_equal(loaded.nn.rpss_test.values,
                                  tuned.nn.rpss_test.values)
    with pytest.raises(FileNotFoundError, match="winner manifest"):
        run("wk2", root, training_type="load")
    msg = _same_error(FileNotFoundError, *load_both(root, "wk2"))
    assert "winner manifest" in msg and "wk2" in msg


def test_load_rejects_week_mismatched_winners(copied_wk2):
    """A winners tree copied across week dirs fails the load's
    fingerprint check, which records the tuned week, with JAX's
    message."""
    with pytest.raises(ValueError, match="week"):
        run("wk2", copied_wk2, training_type="load")
    msg = _same_error(ValueError, *load_both(copied_wk2, "wk2"))
    assert "'week': ('wk1', 'wk2')" in msg


def _realtime(week, root):
    return trealtime.run_realtime_eval(
        _wk_cfg(week), out_root=str(root), source="synthetic",
        synthetic_step=STEP, fetch_indices=False, log=quiet, device="cpu")


def test_realtime_week_uses_matching_winners(wk1_tree):
    """realtime --week wk1 evaluates with the wk1 winners; an untuned week
    fails on the missing manifest, as JAX's loader does on that path."""
    root, _ = wk1_tree
    res, paths = _realtime("wk1", root)
    assert np.isfinite(np.asarray(res.rpss_map)).any()
    assert any(p.endswith(".nc") for p in paths.values())
    with pytest.raises(FileNotFoundError):
        _realtime("wk2", root)
    _same_error(FileNotFoundError,
               lambda: jrealtime.load_winner_for_realtime(mdir(root, "wk2"),
                                                          "wk2"),
               lambda: trealtime.load_winner_for_realtime(mdir(root, "wk2"),
                                                          "wk2",
                                                          device="cpu"))


def test_realtime_rejects_week_mismatched_winners(copied_wk2):
    """A copied mismatched tree fails realtime's fingerprint check with
    JAX's message."""
    with pytest.raises(ValueError, match="week"):
        _realtime("wk2", copied_wk2)
    msg = _same_error(
        ValueError,
        lambda: jrealtime._validate_winner_fingerprint(
            mdir(copied_wk2, "wk2"), _wk_cfg("wk2", jconfigs)),
        lambda: trealtime._validate_winner_fingerprint(
            mdir(copied_wk2, "wk2"), _wk_cfg("wk2")))
    assert "week='wk1'" in msg


def test_suite_week_tree_feeds_barplot_from_real_files(tmp_path):
    """A real `suite --week` run of the port (fast CPU variant:
    ECMWF_com and 2MME at wk1 and wk3-4; one epoch, where the JAX test
    trains three, which the seams do not read) writes the per-week
    outputs tree, and run_barplot consumes those netcdfs: producer and
    consumer agree on paths, file names, dims and masks, and no row is
    skipped."""
    out = str(tmp_path)
    rc = cli.main(["suite", "--configs", "tune_ECMWF_com,tune_2MME",
                   "--week", "wk1,wk3-4", "--fast", "--epochs", "1",
                   "--step", "2.0", "--out", out, "--cpu"])
    assert rc == 0
    with open(tmp_path / "suite_summary.json") as fh:
        s = json.load(fh)
    assert set(s["configs"]) == {"tune_ECMWF_com[wk1]",
                                 "tune_ECMWF_com[wk3-4]",
                                 "tune_2MME[wk1]", "tune_2MME[wk3-4]"}
    for week in ("wk1", "wk3-4"):
        assert os.path.exists(os.path.join(
            out, "outputs", "Common Period", "ECMWF_IMD",
            f"unet_rpss_test_{week}.nc"))
        assert os.path.exists(os.path.join(
            out, "outputs", "2MME", "2MME_IMD",
            f"ELR_rpss_test_{week}.nc"))
    runs = [r for r in notebooks.default_barplot_runs()
            if r["week"] in ("wk1", "wk3-4")
            and ((r["period"] == "Common Period" and r["model"] == "ECMWF")
                 or (r["period"] == "2MME" and r["model"] == "2MME"))]
    assert len(runs) == 8                     # 2 rows x 2 weeks x 2 archs
    paths = notebooks.run_barplot(out_root=out, runs=runs, log=quiet)
    assert paths["skipped"] == []
    assert os.path.exists(paths["by_model"])

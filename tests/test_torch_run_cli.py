"""The port's CLI, `python -m s2s_ismr_tpu_torch.run`.

Mirrors tests/test_run_cli.py: listing, config resolution, suite
incremental writes and --resume, failure isolation, the --check gate, the
--week cross product and single-week keys, error paths — with the port's
`_run` monkeypatched so no pipeline runs — plus what is the port's own:
the device is explicit (no card and no --cpu exits non-zero), the mode
flags reach run_pipeline, flags of unported slices are refused naming
their ROADMAP item, and one real `--cpu` run prints the JAX CLI's summary
keys. The `realtime` subcommand (tests/test_run_cli.py's realtime cases):
`--source` resolves as in the JAX CLI, its flags reach the entry points as the
JAX CLI passes them, and a `--cpu` run on converted winners prints the
paths JSON and writes the JAX CLI's netcdfs within 1e-5.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from s2s_ismr_tpu import compile_cache
from s2s_ismr_tpu import run as jcli
from s2s_ismr_tpu.pipelines import realtime as jrt
from s2s_ismr_tpu_torch import run as cli
from s2s_ismr_tpu_torch.pipelines import CONFIGS
from s2s_ismr_tpu_torch.pipelines import realtime as trt

# The suite runs in several xdist worker processes on few cores: share the
# cores among them, or torch's intra-op threads oversubscribe the machine
# and every worker crawls.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = ["--fast", "--cpu"]


def fake_run(calls, values=None, fail=None):
    """A stand-in for run._run recording (config name, week, lead, device);
    configs in `fail` raise once."""
    fail = set(fail or ())

    def _run(cfg, args, device, **kw):
        calls.append((cfg.name, cfg.week, cfg.lead(), device))
        if cfg.name in fail:
            fail.discard(cfg.name)
            raise RuntimeError("device lost")
        v = (values or {}).get(cfg.name, 0.0)
        return SimpleNamespace(paths={}, figures={}), {
            "config": cfg.name, "elapsed_s": 1.0,
            "elr_rpss_test_mean": v, "nn_rpss_test_mean": v}
    return _run


def _summary(path):
    with open(path / "suite_summary.json") as fh:
        return json.load(fh)


def test_list_prints_all_configs(capsys):
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in list(CONFIGS) + ["suite", "realtime"]:
        assert name in out


def test_unknown_config_errors(capsys):
    assert cli.main(["tune_NOPE", "--cpu"]) == 2
    assert "unknown pipeline" in capsys.readouterr().err
    assert cli.main(["suite", "--configs", "tune_NOPE", "--cpu"]) == 2
    assert "unknown pipeline" in capsys.readouterr().err


def test_no_card_without_cpu_exits_nonzero(monkeypatch, capsys, tmp_path):
    """The run goes to cuda unless --cpu is given, and never falls back."""
    calls = []
    monkeypatch.setattr(cli, "_run", fake_run(calls))
    assert cli.main(["tune_ECMWF_com", "--fast"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["suite", "--configs", "tune_ECMWF_com", "--fast",
                     "--out", str(tmp_path)]) == 2
    assert calls == []
    assert cli.main(["tune_ECMWF_com"] + FAST) == 0
    assert calls == [("tune_ECMWF_com", "wk3-4", (16, 30), "cpu")]


def test_module_entry_without_card_exits_nonzero():
    proc = subprocess.run(
        [sys.executable, "-m", "s2s_ismr_tpu_torch.run", "tune_ECMWF_com",
         "--fast"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "-1"})
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and proc.stdout == ""


@pytest.mark.parametrize("argv, want", [
    (["--training-type", "load"], dict(training_type="load")),
    (["--training-type", "train"], dict(training_type="train")),
    (["--output", "deterministic"], dict(output="deterministic")),
    (["--predictor", "stacked"], dict(predictor="stacked"))])
def test_mode_flags_reach_run_pipeline(argv, want, monkeypatch):
    """The JAX CLI's mode flags (run.py:252-255, 289-292, 312) go through to
    run_pipeline: --output and --predictor into the config,
    --training-type as the call's training_type, on the chosen device."""
    from s2s_ismr_tpu_torch.pipelines import tune
    seen = []

    def fake_pipeline(cfg, **kw):
        seen.append((cfg, kw))
        raise RuntimeError("stop")
    monkeypatch.setattr(tune, "run_pipeline", fake_pipeline)
    with pytest.raises(RuntimeError, match="stop"):
        cli.main(["tune_ECMWF_com"] + FAST + argv)
    (cfg, kw), = seen
    got = {"training_type": kw["training_type"], "output": cfg.output,
           "predictor": cfg.predictor}
    assert got == {"training_type": "tune", "output": "proba",
                   "predictor": "mean", **want}
    assert kw["device"] == "cpu"


@pytest.mark.parametrize("argv, item", [
    (["--plots"], "item 15"),
    (["--profile", "trace"], "item 16")])
def test_unported_flags_refused(argv, item, monkeypatch):
    monkeypatch.setattr(cli, "_run", fake_run([]))
    with pytest.raises(SystemExit, match=item):
        cli.main(["tune_ECMWF_com"] + FAST + argv)


@pytest.mark.parametrize("sub, item", [("accs", "item 15"),
                                       ("barplot", "item 15")])
def test_unported_subcommands_refused(sub, item):
    with pytest.raises(SystemExit, match=item):
        cli.main([sub, "--cpu"])


def _paths_json(out):
    """The paths JSON the realtime subcommand prints after its log."""
    return json.loads(out[out.index("{\n"):])


def test_realtime_subcommand_matches_jax_cli(tmp_path, capsys, monkeypatch):
    """`realtime --from-config tune_ECMWF_com --synthetic --cpu` on a tree
    of winners (flax variables saved by the JAX checkpoint; converted and
    saved by the port's in another root) prints the paths JSON and writes
    the JAX CLI's netcdfs, values within 1e-5."""
    from test_torch_realtime import _same_files, _save_winners
    monkeypatch.setattr(compile_cache, "enable_compilation_cache",
                        lambda *a, **k: None)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    _save_winners(jroot, troot, CONFIGS["tune_ECMWF_com"], "ECMWF", 0)
    argv = ["realtime", "--from-config", "tune_ECMWF_com", "--synthetic",
            "--cpu", "--step", "2", "--out"]
    assert cli.main(argv + [troot]) == 0
    tpaths = _paths_json(capsys.readouterr().out)
    assert jcli.main(argv + [jroot]) == 0
    jpaths = _paths_json(capsys.readouterr().out)
    assert {"probs", "gradcam", "rpss"} <= set(tpaths)
    assert all(os.path.isfile(p) for p in tpaths.values())
    _same_files(tpaths, jpaths, troot, jroot)


def _record_entry_points(monkeypatch, pkg):
    """Replace pkg's realtime entry points by recorders of (name, cfg, args);
    returns the list they append to."""
    calls = []

    def fake(name):
        def entry(cfg, *args, **kw):
            kw.pop("device", None)
            calls.append((name, cfg, args, kw))
            return None, {}
        return entry
    for name in ("run_realtime_forecast", "run_realtime_eval"):
        monkeypatch.setattr(pkg, name, fake(name))
    return calls


@pytest.mark.parametrize("argv, want", [
    ([], ("run_realtime_eval", "source", "synthetic")),
    (["--date", "2023-06-15"],
     ("run_realtime_forecast", "hindcast_source", "iridl")),
    (["--date", "2023-06-15", "--synthetic"],
     ("run_realtime_forecast", "hindcast_source", "synthetic")),
    (["--date", "2023-06-15,2023-06-22", "--no-download", "--no-indices",
      "--plots", "--week", "wk1", "--standardize", "--predictor",
      "multi_predictor", "--seed", "3", "--step", "2", "--out", "o"],
     ("run_realtime_forecast", "hindcast_source", "iridl"))])
def test_realtime_flags_and_source_resolve_as_jax(argv, want, monkeypatch):
    """--source defaults to iridl for `realtime --date` and to synthetic
    everywhere else (s2s_ismr_tpu/run.py:193-198); the realtime flags and
    cfg overrides reach the entry points as the JAX CLI passes them, on the
    CPU with --cpu."""
    monkeypatch.setattr(compile_cache, "enable_compilation_cache",
                        lambda *a, **k: None)
    tcalls = _record_entry_points(monkeypatch, trt)
    jcalls = _record_entry_points(monkeypatch, jrt)
    base = ["realtime", "--from-config", "tune_GEFS_com"]
    assert cli.main(base + argv + ["--cpu"]) == 0
    assert jcli.main(base + argv) == 0
    (tname, tcfg, targs, tkw), = tcalls
    (jname, jcfg, jargs, jkw), = jcalls
    entry, key, source = want
    assert tname == jname == entry and tkw[key] == jkw[key] == source
    assert targs == jargs and tkw == jkw
    for f in ("name", "week", "predictor", "output", "standardize"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f


def test_tune_source_still_defaults_to_synthetic(monkeypatch):
    seen = []

    def _run(cfg, args, device, **kw):
        seen.append(args.source)
        return SimpleNamespace(paths={}, figures={}), {"config": cfg.name}
    monkeypatch.setattr(cli, "_run", _run)
    assert cli.main(["tune_ECMWF_com"] + FAST) == 0
    assert cli.main(["tune_ECMWF_com", "--source", "iridl"] + FAST) == 0
    assert seen == ["synthetic", "iridl"]


def test_realtime_errors(capsys, monkeypatch):
    """Without --cpu and without a card: exit 2 before any work; an
    unknown --from-config or week: exit 2; --plots stays refused for the
    tune run."""
    calls = _record_entry_points(monkeypatch, trt)
    assert cli.main(["realtime"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["realtime", "--from-config", "tune_NOPE", "--cpu"]) == 2
    assert "unknown pipeline" in capsys.readouterr().err
    assert cli.main(["realtime", "--week", "wk9", "--cpu"]) == 2
    assert "unknown week" in capsys.readouterr().err
    assert calls == []
    with pytest.raises(SystemExit, match="item 15"):
        cli.main(["tune_ECMWF_com", "--plots"] + FAST)


def test_overrides_resolve_like_jax(monkeypatch):
    seen = []

    def _run(cfg, args, device, **kw):
        seen.append(cfg)
        return SimpleNamespace(paths={}, figures={}), {"config": cfg.name}
    monkeypatch.setattr(cli, "_run", _run)
    assert cli.main(["tune_GEFS_com", "--cpu", "--epochs", "3", "--folds",
                     "4", "--standardize", "--batch-size", "full",
                     "--week", "wk1"]) == 0
    cfg = seen[0]
    assert (cfg.epochs, cfg.n_bootstraps, cfg.standardize) == (3, 4, True)
    assert cfg.tuning.batch_sizes == (0,) and cfg.week == "wk1"
    assert cfg.tuning.n_filters == CONFIGS["tune_GEFS_com"].tuning.n_filters


def test_batch_size_non_integer_rejected():
    for bad in ("1.5", "abc", "0"):
        with pytest.raises(SystemExit, match="batch-size"):
            cli.main(["tune_ECMWF_com", "--batch-size", bad] + FAST)


def test_week_comma_rejected_outside_suite():
    with pytest.raises(SystemExit):
        cli.main(["tune_ECMWF_com", "--week", "wk1,wk2"] + FAST)


def test_week_list_validated_up_front(capsys):
    assert cli.main(["suite", "--week", "wk1,"] + FAST) == 2
    assert "unknown week" in capsys.readouterr().err
    assert cli.main(["suite", "--week", "wk1,wk1"] + FAST) == 2
    assert "duplicate" in capsys.readouterr().err


def test_suite_incremental_and_resume(tmp_path, monkeypatch):
    """suite writes the summary after every config and --resume skips the
    configs already recorded."""
    calls = []
    monkeypatch.setattr(cli, "_run", fake_run(calls))
    argv = ["suite", "--configs", "tune_ECMWF_com,tune_GEFS_com", "--out",
            str(tmp_path)] + FAST
    assert cli.main(argv) == 0
    s = _summary(tmp_path)
    assert set(s["configs"]) == {"tune_ECMWF_com", "tune_GEFS_com"}
    assert s["partial"] is False and s["settings"]["cpu"] is True
    assert [c[0] for c in calls] == ["tune_ECMWF_com", "tune_GEFS_com"]
    assert not os.path.exists(tmp_path / "suite_summary.json.tmp")

    calls.clear()
    assert cli.main(argv + ["--resume"]) == 0
    assert calls == []

    s["configs"].pop("tune_GEFS_com")
    with open(tmp_path / "suite_summary.json", "w") as fh:
        json.dump(s, fh)
    assert cli.main(argv + ["--resume"]) == 0
    assert [c[0] for c in calls] == ["tune_GEFS_com"]

    # other settings: a fast resume must not satisfy a full run
    calls.clear()
    assert cli.main(["suite", "--configs", "tune_ECMWF_com", "--cpu",
                     "--out", str(tmp_path), "--resume"]) == 0
    assert [c[0] for c in calls] == ["tune_ECMWF_com"]


def test_suite_isolates_config_failures(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(cli, "_run", fake_run(calls, fail={"tune_ECMWF_com"}))
    argv = ["suite", "--configs", "tune_ECMWF_com,tune_GEFS_com", "--out",
            str(tmp_path)] + FAST
    assert cli.main(argv) == 1
    s = _summary(tmp_path)
    assert "device lost" in s["configs"]["tune_ECMWF_com"]["error"]
    assert "error" not in s["configs"]["tune_GEFS_com"]
    calls.clear()
    assert cli.main(argv + ["--resume"]) == 0
    assert [c[0] for c in calls] == ["tune_ECMWF_com"]


def test_suite_week_cross_product(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(cli, "_run", fake_run(calls))
    assert cli.main(["suite", "--configs", "tune_ECMWF_com", "--week",
                     "wk1,wk3-4", "--out", str(tmp_path)] + FAST) == 0
    assert calls == [("tune_ECMWF_com[wk1]", "wk1", (2, 8), "cpu"),
                     ("tune_ECMWF_com[wk3-4]", "wk3-4", (16, 30), "cpu")]
    s = _summary(tmp_path)
    assert set(s["configs"]) == {"tune_ECMWF_com[wk1]",
                                 "tune_ECMWF_com[wk3-4]"}
    assert s["settings"]["week"] == "wk1,wk3-4"
    calls.clear()
    assert cli.main(["suite", "--configs", "tune_ECMWF_com", "--week", "wk9",
                     "--out", str(tmp_path)] + FAST) == 2
    assert calls == []


def test_suite_single_week_suffixes_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "_run", fake_run([]))
    assert cli.main(["suite", "--configs", "tune_ECMWF_com", "--week", "wk1",
                     "--out", str(tmp_path)] + FAST) == 0
    assert set(_summary(tmp_path)["configs"]) == {"tune_ECMWF_com[wk1]"}


def test_suite_check_gate(tmp_path, monkeypatch, capsys):
    vals = {"tune_ECMWF_com": 0.25, "tune_GEFS_com": 0.27}
    monkeypatch.setattr(cli, "_run", fake_run([], values=vals))
    exp = {"tolerance": 1e-9, "configs": {
        "tune_ECMWF_com": {"elr_rpss_test_mean": 0.25,
                           "nn_rpss_test_mean": 0.25},
        "tune_GEFS_com": {"elr_rpss_test_mean": 0.27,
                          "nn_rpss_test_mean": 0.27},
        "tune_IITM_com": {"nn_rpss_test_mean": 0.5}}}
    epath = tmp_path / "expected.json"
    epath.write_text(json.dumps(exp))
    argv = ["suite", "--configs", "tune_ECMWF_com,tune_GEFS_com", "--check",
            str(epath)] + FAST
    assert cli.main(argv + ["--out", str(tmp_path / "a")]) == 0
    cap = capsys.readouterr()
    assert "skip tune_IITM_com" in cap.err and "[check] ok" in cap.err
    assert json.loads(cap.out)["check"]["ok"] is True
    assert _summary(tmp_path / "a")["check"]["ok"] is True

    exp["configs"]["tune_GEFS_com"]["nn_rpss_test_mean"] = 0.2701
    epath.write_text(json.dumps(exp))
    assert cli.main(argv + ["--out", str(tmp_path / "b")]) == 1
    assert "FAIL tune_GEFS_com.nn_rpss_test_mean" in capsys.readouterr().err
    assert _summary(tmp_path / "b")["check"]["ok"] is False

    monkeypatch.setattr(cli, "_run", fake_run([], fail={"tune_ECMWF_com"}))
    assert cli.main(["suite", "--configs", "tune_ECMWF_com", "--check",
                     str(epath), "--out", str(tmp_path / "c")] + FAST) == 1


def test_check_suite_as_jax(tmp_path, capsys):
    """_check_suite is the JAX function, line for line."""
    exp = {"tolerance": 1e-6, "configs": {
        "a": {"elr_rpss_test_mean": 0.1, "nn_rpss_test_mean": 0.2},
        "b": {"nn_rpss_test_mean": 0.3}, "c": {"nn_rpss_test_mean": 0.3}}}
    epath = tmp_path / "e.json"
    epath.write_text(json.dumps(exp))
    results = {"a": {"elr_rpss_test_mean": 0.1, "nn_rpss_test_mean": 0.25},
               "b": {"error": "boom"}}
    got = cli._check_suite(results, str(epath))
    assert got == jcli._check_suite(results, str(epath)) and len(got) == 2


def test_suite_resume_accumulates_total_and_persists_check(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(cli, "_run",
                        fake_run([], values={"tune_ECMWF_com": 0.25}))
    epath = tmp_path / "expected.json"
    epath.write_text(json.dumps({"tolerance": 1e-9, "configs": {
        "tune_ECMWF_com": {"elr_rpss_test_mean": 0.25,
                           "nn_rpss_test_mean": 0.25}}}))
    argv = ["suite", "--configs", "tune_ECMWF_com", "--out", str(tmp_path),
            "--check", str(epath)] + FAST
    assert cli.main(argv) == 0
    s = _summary(tmp_path)
    assert s["check"]["ok"] is True and s["check"]["failures"] == []
    s["total_s"] = 9000.0
    with open(tmp_path / "suite_summary.json", "w") as fh:
        json.dump(s, fh)
    assert cli.main(argv + ["--resume"]) == 0
    s2 = _summary(tmp_path)
    assert s2["total_s"] >= 9000.0 and s2["check"]["ok"] is True


def test_cpu_run_end_to_end(tmp_path, capsys):
    """A real --cpu run at step 2 (16x16) prints the JAX CLI's summary keys
    and the outputs it wrote (run.py:313-318, 475-477)."""
    assert cli.main(["tune_ECMWF_com", "--synthetic", "--step", "2",
                     "--epochs", "2", "--out", str(tmp_path)] + FAST) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("\n{\n") + 1:])
    assert set(summary) == {"config", "elapsed_s", "elr_rpss_test_mean",
                            "nn_rpss_test_mean", "outputs", "figures"}
    assert summary["config"] == "tune_ECMWF_com"
    assert -1.0 < summary["elr_rpss_test_mean"] < 1.0
    assert -1.0 < summary["nn_rpss_test_mean"] < 1.0
    assert set(summary["outputs"]) == {
        "elr_train", "elr_test", "winners_ECMWF", "nn_train", "nn_val",
        "nn_test", "hparams", "profile"}
    assert all(os.path.isfile(p) for p in summary["outputs"].values())

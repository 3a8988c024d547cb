"""The harness end to end on the CPU: a tiny cell prints a valid last
line; cells, configurations and metrics are found by name from files; the
committed BENCHMARK.json agrees with the files; no card or no program
means no result."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from .util import REPO, run_cell, tiny_args

BENCH = os.path.join(REPO, "benchmark")


@pytest.mark.parametrize("cell", ["tiny_serial", "tiny_vmap",
                                  "tiny_stacked_serial", "tiny_early_serial"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_a_valid_last_line(tiny_root, cell, trace):
    rc, out, err = run_cell(tiny_args(tiny_root, cell, trace=trace))
    assert rc == 0, err
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, err
    assert out["failed"] == 0 and out["attempted"] >= 4
    if trace:
        assert "model.step_mfu" in out["metrics"]
        assert "lane_steps_per_s" not in out["metrics"]
    else:
        assert set(out["metrics"]) == {"lane_steps_per_s", "setup_s"}
        assert out["metrics"]["lane_steps_per_s"]["value"] > 0
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
        assert f"{name} {c['value']!r} limit {c['limit']!r}" in err


@pytest.mark.parametrize("cell,control", [("tiny_serial", None),
                                          ("tiny_early_serial", None),
                                          ("tiny_early_serial", "tf32")])
def test_the_first_epoch_is_read_where_a_cell_names_it(tiny_root, cell,
                                                       control):
    """The set-up call's numbers are compared where the cell's limits name
    one, from the control too, and read nowhere else."""
    args = tiny_args(tiny_root, cell) + (["--control", control]
                                         if control else [])
    rc, out, err = run_cell(args)
    assert rc == 0, err
    with open(tiny_root / "cells" / f"{cell}.json") as fh:
        limits = json.load(fh)["limits"]
    assert set(out["checks"]) == set(limits)
    early = "check: call -1 fold" in err
    assert early == any(k.startswith("epoch1_") for k in limits)


def test_cells_and_metrics_are_found_by_name(tiny_root):
    """A new cell and a new metric reader are files; no code changes."""
    (tiny_root / "cells" / "tiny_more.json").write_text(json.dumps(
        dict(json.loads((tiny_root / "cells" / "tiny_serial.json")
                        .read_text()), why="another cell")))
    (tiny_root / "metrics" / "window.calls.py").write_text(textwrap.dedent(
        '''
        UNIT, BETTER, SOURCE = "calls", "higher", "host_clock"
        LAYER, MOVES = "sweep (train/sweep.py)", "lane_steps_per_s"

        def read(rec):
            return float(rec["window"]["calls"])
        '''))
    (tiny_root / "metrics" / "silent.py").write_text(
        "UNIT = 'x'\n\ndef read(rec):\n    return None\n")
    rc, out, err = run_cell(tiny_args(tiny_root, "tiny_more", trace=1))
    assert rc == 0, err
    assert out["metrics"]["window.calls"]["value"] >= 1
    assert "silent" not in out["metrics"]


def test_benchmark_json_agrees_with_the_files():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        with open(os.path.join(REPO, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in b["workloads"]:
        with open(os.path.join(BENCH, "cells", w["name"] + ".json")) as fh:
            cell = json.load(fh)
        assert (cell["config"], cell["traffic"], cell["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
        assert cell["config"] in configs
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    names = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        scope = {}
        with open(path) as fh:
            exec(compile(fh.read(), path, "exec"), scope)
        assert (scope["UNIT"], scope["LAYER"], scope["MOVES"],
                scope["BETTER"], scope["SOURCE"]) == \
            (m["unit"], m["layer"], m["moves"], m["better"], m["source"])
        assert m["moves"] in e2e
        assert set(m.get("workloads", names)) <= names


def test_no_card_no_result(tiny_root):
    """Without --cpu the harness needs a card: none, no result line."""
    args = [a for a in tiny_args(tiny_root) if a != "--cpu"]
    rc, out, err = run_cell(args, env={"CUDA_VISIBLE_DEVICES": ""})
    assert rc != 0 and out is None
    assert "no CUDA device" in err


def test_no_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/, the run
    fails and prints no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    root = tmp_path / "benchmark" / "tests" / "tiny"
    shutil.copytree(tmp_path / "benchmark" / "traffic", root / "traffic")
    shutil.copytree(tmp_path / "benchmark" / "metrics", root / "metrics")
    p = subprocess.run([sys.executable, "-m", "benchmark.run"]
                       + tiny_args(root), cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
    assert "not importable" in p.stderr

"""Running the harness from the benchmark's tests."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_cell(args, cwd=REPO, prelude="", env=None, timeout=600):
    """(returncode, the last stdout line as JSON or None, stderr) of one
    harness run in a fresh interpreter; `prelude` is Python run before
    the harness's main (where a test plants a fault)."""
    code = (f"import sys\n{prelude}\nfrom benchmark import run\n"
            f"raise SystemExit(run.main({list(args)!r}))\n")
    # one thread each: the tests run several harness processes at once
    e = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    p = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=e,
                       capture_output=True, text=True, timeout=timeout)
    lines = p.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if lines else None
    return p.returncode, out, p.stderr


def tiny_args(root, cell="tiny_serial", seed=123456789012, trace=0):
    return ["--workload", cell, "--seed", str(seed), "--seconds", "1",
            "--trace", str(trace), "--cpu", "--root", str(root)]

"""Nothing the harness or the reference loads is JAX, flax, optax or the
JAX package (top-level names compared whole), and the reference, the
generator and the check load nothing of the program."""

import subprocess
import sys

from .util import REPO, run_cell, tiny_args

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "s2s_ismr_tpu"}


def loaded_after(code):
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                        "print(sorted({m.split('.')[0] for m in "
                        "sys.modules}))"], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny_root):
    mods = loaded_after("from benchmark import run\nassert run.main("
                        f"{tiny_args(tiny_root)!r}) == 0")
    assert "s2s_ismr_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_the_yardstick_loads_nothing_of_the_program():
    mods = loaded_after("from benchmark import check, counts, peaks, "
                        "reference, trace, workload")
    assert not mods & (FORBIDDEN | {"s2s_ismr_tpu_torch"})


def test_a_run_that_loaded_jax_prints_no_result(tiny_root):
    prelude = "import types\nsys.modules['jax'] = types.ModuleType('jax')"
    rc, out, err = run_cell(tiny_args(tiny_root), prelude=prelude)
    assert rc != 0 and out is None
    assert "jax" in err.splitlines()[-1]

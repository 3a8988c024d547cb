"""The PyTorch port imports without JAX.

The port (`s2s_ismr_tpu_torch`) may share only the numpy host layer of the
JAX package; importing it must not load jax, flax or optax. Mirrors the
clean-interpreter import probe of the JAX package's verify notes.
"""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "s2s_ismr_tpu_torch"
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py"))
MODULES = [s[:-3].replace("/", ".").removesuffix(".__init__")
           for s in SOURCES]


def test_port_imports_without_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = [m for m in ('jax', 'flax', 'optax') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("source", SOURCES)
def test_source_names_no_jax(source):
    text = (ROOT / source).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax)\b", text,
                         re.M), source

"""The PyTorch port imports without JAX and without the JAX package.

The port (`s2s_ismr_tpu_torch`) keeps its own copy of the numpy host
layer; importing it must load neither jax, flax or optax nor any module of
`s2s_ismr_tpu`. Mirrors the clean-interpreter import probe of the JAX
package's verify notes, and scans the sources of the port and of
`chip_smoke.py` for such imports. The drawing packages (matplotlib,
seaborn) are missing on the card's machine: no module of the port imports
them, or pandas, at module level, so every module imports with all three
blocked, and a drawing call names the package it lacks.
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
JAX_PACKAGE = re.compile(r"^\s*(import\s+s2s_ismr_tpu\b(?!_)"
                         r"|from\s+s2s_ismr_tpu[. ])", re.M)


DRAWING = ("matplotlib", "pandas", "seaborn")


def _import_all(blocked=()):
    code = ("import sys\n"
            + "".join(f"sys.modules[{b!r}] = None\n" for b in blocked)
            + "".join(f"import {m}\n" for m in MODULES)
            + "import json\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    import json
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_without_jax():
    loaded = _import_all()
    bad = [m for m in ("jax", "flax", "optax") if m in loaded]
    assert not bad, bad


def test_port_imports_nothing_of_the_jax_package():
    loaded = _import_all()
    assert "s2s_ismr_tpu_torch" in loaded
    bad = [m for m in loaded
           if m == "s2s_ismr_tpu" or m.startswith("s2s_ismr_tpu.")]
    assert not bad, bad


@pytest.mark.parametrize("source", SOURCES)
def test_source_names_no_jax(source):
    text = (ROOT / source).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax)\b", text,
                         re.M), source


@pytest.mark.parametrize("source", SOURCES + ["chip_smoke.py"])
def test_source_names_no_jax_package(source):
    text = (ROOT / source).read_text()
    hits = [m.group(0).strip() for m in JAX_PACKAGE.finditer(text)]
    assert not hits, (source, hits)


def test_port_imports_without_drawing_packages():
    """Every module of the port imports with matplotlib, pandas and seaborn
    blocked, and loads none of them."""
    loaded = _import_all(blocked=DRAWING)
    assert "s2s_ismr_tpu_torch.analysis" in loaded


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_drawing_package_at_module_level(source):
    """A module-level import of matplotlib, pandas or seaborn anywhere in
    the port (imports inside functions are the port's way)."""
    import ast
    tree = ast.parse((ROOT / source).read_text())
    names = [a.name for node in tree.body
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for a in (node.names if isinstance(node, ast.Import)
                       else [ast.alias(node.module or "")])]
    bad = [n for n in names if n.split(".")[0] in DRAWING]
    assert not bad, (source, bad)


def test_realtime_path_imports_without_matplotlib():
    """The card's machine has no matplotlib: with it blocked, the CLI, the
    realtime pipeline and attrib import, and the realtime CLI's --help
    runs (the figures import matplotlib inside the drawing calls)."""
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "import s2s_ismr_tpu_torch.run as run\n"
            "import s2s_ismr_tpu_torch.pipelines.realtime\n"
            "import s2s_ismr_tpu_torch.attrib\n"
            "import s2s_ismr_tpu_torch.viz.maps\n"
            "import s2s_ismr_tpu_torch.viz.regions\n"
            "try:\n"
            "    run.main(['realtime', '--help'])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.startswith('matplotlib')\n"
            "       and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "--from-config" in proc.stdout and "--no-indices" in proc.stdout
    blocked = subprocess.run(
        [sys.executable, "-c", "import sys; sys.modules['matplotlib'] = "
         "None; import numpy as np; from s2s_ismr_tpu_torch.viz import "
         "realtime; realtime.plot_probability_maps(np.zeros((1, 2, 2)), "
         "[0, 1], [0, 1], 'p.png')"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert blocked.returncode != 0 and "matplotlib" in blocked.stderr


def test_reporting_imports_without_drawing_packages():
    """With matplotlib, pandas and seaborn blocked, analysis,
    pipelines.notebooks, viz.maps, viz.reliability, pipelines.tune and run
    import, `accs --help` runs and the levels need nothing; then each
    drawing call raises an ImportError naming the package it lacks (the
    boxplot's seaborn, with matplotlib and pandas present)."""
    code = ("import sys\n"
            "for m in ('matplotlib', 'pandas', 'seaborn'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np\n"
            "import s2s_ismr_tpu_torch.run as run\n"
            "import s2s_ismr_tpu_torch.pipelines.tune\n"
            "from s2s_ismr_tpu_torch import analysis\n"
            "from s2s_ismr_tpu_torch.pipelines import notebooks\n"
            "from s2s_ismr_tpu_torch.viz import maps, reliability\n"
            "assert len(maps.CC_LEVELS) == 13 and len(maps.ACC_LEVELS) == 11\n"
            "try:\n"
            "    run.main(['accs', '--help'])\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "calls = [lambda: maps.plot_skill_map(np.zeros((2, 2)), [0, 1],\n"
            "                                     [0, 1], 'x.png'),\n"
            "         lambda: maps.plot_climatology(np.zeros((2, 2)), [0, 1],\n"
            "                                       [0, 1], 'x.png'),\n"
            "         lambda: reliability.reliability_diagram(\n"
            "             np.zeros(4), np.zeros(4), 'x.png', device='cpu')]\n"
            "for call in calls:\n"
            "    try:\n"
            "        call()\n"
            "    except ImportError as e:\n"
            "        assert 'matplotlib' in str(e), e\n"
            "    else:\n"
            "        raise AssertionError('drew without matplotlib')\n"
            "del sys.modules['matplotlib'], sys.modules['pandas']\n"
            "table = analysis.RpssTable(*[np.zeros(1)] * 5)\n"
            "try:\n"
            "    analysis.rpss_boxplot(table, 'x.png')\n"
            "except ImportError as e:\n"
            "    assert 'seaborn' in str(e), e\n"
            "else:\n"
            "    raise AssertionError('boxplot without seaborn')\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "--models" in proc.stdout and proc.stdout.endswith("ok\n")


def test_jax_package_scan_catches_its_imports():
    """The scan above rejects the import forms and lets the port's own
    name through."""
    for line in ("import s2s_ismr_tpu", "from s2s_ismr_tpu import grid",
                 "from s2s_ismr_tpu.io import read_netcdf",
                 "    from s2s_ismr_tpu.data import synthetic",
                 "import s2s_ismr_tpu.field"):
        assert JAX_PACKAGE.search(line), line
    for line in ("import s2s_ismr_tpu_torch",
                 "from s2s_ismr_tpu_torch.io import read_netcdf",
                 "# see s2s_ismr_tpu.field", "from .field import Field"):
        assert not JAX_PACKAGE.search(line), line

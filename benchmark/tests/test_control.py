"""On the card: the lower-precision control (the plain reference with TF32
on in cuDNN and matmuls, so in every conv, transposed conv and head and
their gradients, put in the program's place) fails the check at each
cell's own size, and the program as configured passes it. `python -m
pytest benchmark/tests -m chip` on the chip."""

import pytest

from .util import run_cell

CELLS = ["ecmwf32_serial", "iitm64_serial", "ecmwf32_vmap"]


def args(cell, seed):
    return ["--workload", cell, "--seed", str(seed), "--seconds", "1",
            "--trace", "0"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 7, 2 ** 33 + 11, 2 ** 32 + 5])
def test_the_tf32_control_is_not_correct(card, cell, seed):
    rc, out, err = run_cell(args(cell, seed) + ["--control", "tf32"],
                            timeout=1200)
    assert rc == 0, err
    assert out["correct"] is False, out["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(card, cell):
    rc, out, err = run_cell(args(cell, 2 ** 31 + 7), timeout=1200)
    assert rc == 0, err
    assert out["correct"] is True, out["checks"]

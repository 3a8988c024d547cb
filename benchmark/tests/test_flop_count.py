"""The benchmark's counts against numbers worked by hand, and the conv
kernel launches the shapes give against the launches a CPU sweep call
makes (its plain calls counted)."""

from collections import Counter

import pytest

from benchmark import counts, peaks, workload
from benchmark import run as brun

from .test_plain_unet_ref import SEED, tiny_inputs

ECMWF = workload.Trial(0, 16, 1e-3, (3, 3), 2, 3)
IITM = workload.Trial(0, 16, 1e-3, (3, 3), 3, 5)


def step_launches(trial, h, w):
    c = Counter()
    for i, s in enumerate(counts.conv_shapes(trial, 16, h, w)):
        c[(s, False, 1)] += 1
        if i:
            c[(s, True, 1)] += 1
    return c


def test_the_32x32_step_by_hand():
    """n_blocks 3, filters 2 (widths 8, 16, 32, bottleneck 64), batch 16:
    14 forward and 13 dx launches; forward FLOP 2 N H W 9 C O summed is
    276.03 M, dx the same less the first conv's 2.36 M: 549,715,968 FLOP;
    least time 6.905 us at 165 TFLOP/s and 3.35 TB/s."""
    c = step_launches(ECMWF, 32, 32)
    assert sum(c.values()) == 27
    flop = sum(2 * n * h * w * 9 * ci * o * k
               for ((n, h, w, ci, o), _, _), k in c.items())
    assert flop == 549_715_968
    assert counts.least_time(c) == pytest.approx(6.905e-6, abs=1e-9)
    assert peaks.FLOAT32_3XTF32 == 165e12


def test_row_flops_by_hand():
    """One training row of the 32x32 trial: convs 3 x 17.25 M less the
    first conv's dx 0.147 M, transposed convs 3 x 0.884 M, head 3 x 49 K:
    57,065,472; a step of 16 rows 0.913 GFLOP; the 64x64 n_blocks-5
    filters-3 trial 13.29 GFLOP a step."""
    train, fwd = counts.row_flops(ECMWF, 32, 32)
    assert (train, fwd) == (57_065_472, 19_070_976)
    assert 16 * counts.row_flops(IITM, 64, 64)[0] == 13_292_273_664


def test_launches_per_lane_step():
    """4 n_blocks + 2 forward and 4 n_blocks + 1 dx per step, 4 n_blocks
    + 2 per val forward; one lane-mode launch serves all L lanes."""
    c = counts.sweep_launches(ECMWF, 32, 32, [0], [1], {0: 17}, 70, 349,
                              [], False)
    assert sum(c.values()) == 17 * 27 + 14
    c = counts.sweep_launches(IITM, 64, 64, [0, 1], [2, 2], {0: 20, 1: 19},
                              88, 437, [0, 1], False)
    assert sum(c.values()) == 2 * (20 + 19) * 43 + 2 * 2 * 22 + 2 * 22
    c = counts.sweep_launches(ECMWF, 32, 32, list(range(20)), 10,
                              {i: 17 for i in range(20)}, 70, 349, [0], True)
    assert sum(c.values()) == 10 * (17 * 27 + 14) + 14
    assert {lanes for (_, _, lanes) in c} == {1, 20}
    assert counts.chunks(437, 64, 64) == [437]
    assert counts.chunks(1000, 64, 64) == [488, 488, 24]


@pytest.mark.parametrize("config", ["tiny", "tiny_stacked"])
@pytest.mark.parametrize("dispatch", ["serial", "vmap"])
def test_launches_match_a_cpu_sweep_call(monkeypatch, dispatch, config):
    from s2s_ismr_tpu_torch.kernels import conv
    calls = [0]

    def counted(f):
        def g(*a, **k):
            calls[0] += 1
            return f(*a, **k)
        return g

    for name in ("_conv_call", "_dx_call", "conv3x3_bias_act_lanes_plain",
                 "conv3x3_dx_lanes_plain"):
        monkeypatch.setattr(conv, name, counted(getattr(conv, name)))
    cfg, inp = tiny_inputs(config)
    prog = brun.Program(cfg, {"lane_dispatch": dispatch}, inp, "cpu")
    for folds, epochs in ((None, 2), ([1], 1)):
        calls[0] = 0
        res = prog.call(0, epochs=epochs, folds=folds)
        fs = folds or list(range(inp.train.shape[0]))
        want = brun.expected_launches(cfg, inp, res, fs, dispatch == "vmap")
        assert calls[0] == sum(want.values())
    assert SEED

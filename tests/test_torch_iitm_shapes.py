"""The records of `chip_smoke.py` phase 12 (IITM's 24 members at 64x64),
checked on the CPU as tests/test_torch_grids.py checks phase 11's.

`chip_smoke.member_shapes` gives the kernel its shapes: the
multi_predictor first conv (C = 24) of every trial of tune_IITM_full's
grid, and the stacked predictor's 488-row eval chunks; and
`chip_smoke.expected_launches` must count the launches of a stacked
`train` run, its `load` and a multi_predictor sweep exactly, eval row
chunks included: here against the conv calls of CPU runs (counted where
the wrapper calls its plain version). Port calls name their device.
"""

import os
from dataclasses import replace

import pytest
import torch

import chip_smoke
from s2s_ismr_tpu_torch.kernels import conv, conv_bench
from s2s_ismr_tpu_torch.pipelines import configs as tconfigs
from s2s_ismr_tpu_torch.pipelines import tune as ttune
from s2s_ismr_tpu_torch.train import engine as tengine

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


@pytest.fixture(autouse=True)
def bench(monkeypatch):
    """chip_smoke's `bench` global, set by its main()."""
    monkeypatch.setattr(chip_smoke, "bench", conv_bench, raising=False)


def test_member_shapes_of_tune_iitm_full():
    """The multi_predictor first convs take the 24 members (filters 2 and
    3: 8 and 12 outputs) at batch 16, the val rows and T; the stacked
    eval chunks cover 24 x 437 = 10,488 rows of 64x64 in 22 chunks of 488
    (the last 240) and the 2,112 val rows (the last chunk 160), at every
    conv of n_blocks 3 / filters 2 and n_blocks 5 / filters 3."""
    first, multi, stacked = chip_smoke.member_shapes(torch, device="cpu")
    assert first == [(16, 64, 64, 24, 8), (16, 64, 64, 24, 12)]
    assert sorted(multi) == sorted((n, 64, 64, 24, o) for n in (88, 437)
                                   for o in (8, 12))
    chunk = tengine.row_chunk(torch.empty(1, 64, 64, 1))
    assert chunk == 488 and -(-24 * 437 // chunk) == 22
    assert 24 * 437 - 21 * chunk == 240 and 24 * 88 - 4 * chunk == 160
    assert {s[0] for s in stacked} == {488, 240, 160}
    # 11 distinct convs at n_blocks 3 / filters 2, 17 at 5 / 3, each at
    # three row counts
    assert len(stacked) == 3 * (11 + 17) == 84
    assert (488, 64, 64, 1, 8) in stacked and (488, 2, 2, 384, 384) in stacked
    assert max(n * h * w for n, h, w, _, _ in stacked) <= conv.MAX_PIXELS


def _small(predictor, **over):
    base = tconfigs.get_config("tune_IITM_com")
    return replace(base, years=(2003, 2007), nn_frac_test=0.2,
                   n_bootstraps=2, epochs=2, predictor=predictor,
                   tuning=replace(base.tuning, n_blocks=(1, 2),
                                  n_filters=(1,), ct_kernels=((2, 2),),
                                  batch_sizes=(32,), patience=1), **over)


@pytest.fixture
def calls(monkeypatch):
    """The kernel's launches, counted where the wrapper calls its plain
    version on the CPU."""
    n = {"n": 0}
    for fn in ("_conv_call", "_dx_call"):
        real = getattr(conv, fn)

        def counting(*a, real=real):
            n["n"] += 1
            return real(*a)
        monkeypatch.setattr(conv, fn, counting)
    return n


def test_expected_launches_multi_predictor_sweep(calls):
    """A multi_predictor sweep (C = 24 into the first conv) at n_blocks 1
    and 2."""
    cfg = _small("multi_predictor")
    nn = ttune.run_nn_branch(cfg, ttune.load_bundles(cfg, synthetic_step=2),
                             log=lambda s: None, device="cpu")
    out = ttune.TuneOutputs(config=cfg, elr=None, nn=nn, mask=None)
    want, terms = chip_smoke.expected_launches(torch, out)
    assert calls["n"] == want, terms
    assert nn.predictions.shape[:2] == (2, 109)


def test_expected_launches_stacked_train_and_load(calls, tmp_path,
                                                  monkeypatch):
    """A stacked `train` run (the grid's first trial, one lane per fold)
    and its `load`, with the row chunk cut so that the 2,616 stacked rows
    take 22 chunks, as 10,488 rows of 64x64 do on the card."""
    monkeypatch.setattr(tengine, "MAX_PIXELS", 119 * 16 * 16)
    cfg = _small("stacked")
    kw = dict(out_root=str(tmp_path), synthetic_step=2.0,
              log=lambda s: None, device="cpu")
    for mode in ("train", "load"):
        calls["n"] = 0
        out = ttune.run_pipeline(cfg, training_type=mode, **kw)
        want, terms = chip_smoke.expected_launches(torch, out,
                                                   load=mode == "load")
        assert calls["n"] == want, terms
        assert "22 chunk(s)" in terms
        assert out.nn.labels.shape == (2, 24 * 109, 16, 16)

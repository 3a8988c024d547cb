"""Port vs JAX: losses and RPS/RPSS.

Mirrors the loss checks of tests/test_engine.py and the RPS/RPSS checks of
tests/test_metrics.py. The same numpy inputs go through s2s_ismr_tpu and
s2s_ismr_tpu_torch; results agree at rtol 1e-6 (float32 reductions in a
different order).
"""

import numpy as np
import pytest
import torch

from s2s_ismr_tpu.ops import metrics as jm
from s2s_ismr_tpu.train import losses as jl
from s2s_ismr_tpu_torch.ops import metrics as tm
from s2s_ismr_tpu_torch.train import losses as tl

RTOL = 1e-6


def _t(a):
    return torch.as_tensor(a)


def _probs_onehot(rng, shape=(6, 4, 5)):
    p = rng.dirichlet(np.ones(3), size=shape).astype(np.float32)
    oh = np.eye(3, dtype=np.float32)[rng.integers(0, 3, shape)]
    return p, oh


@pytest.mark.parametrize("weights", [None, "mixed", "zero"])
def test_categorical_crossentropy(rng, weights):
    p, oh = _probs_onehot(rng)
    p[0, 0, 0] = [1.0, 0.0, 0.0]                      # exercises the clip
    w = {None: None, "mixed": np.array([1, 0, 1, 1, 0, 1], np.float32),
         "zero": np.zeros(6, np.float32)}[weights]
    got = float(tl.categorical_crossentropy(_t(p), _t(oh),
                                            None if w is None else _t(w)))
    want = float(jl.categorical_crossentropy(p, oh, w))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_masked_mse(rng, weighted):
    pred = rng.normal(size=(5, 4, 4, 1)).astype(np.float32)
    tgt = rng.normal(size=(5, 4, 4, 1)).astype(np.float32)
    tgt[:, 0] = np.nan                                # ocean row
    w = np.array([1, 1, 0, 1, 0], np.float32) if weighted else None
    got = float(tl.masked_mse(_t(pred), _t(tgt), None if w is None else _t(w)))
    np.testing.assert_allclose(got, float(jl.masked_mse(pred, tgt, w)),
                               rtol=RTOL)


def test_categorical_accuracy(rng):
    p, oh = _probs_onehot(rng)
    w = np.array([1, 0, 1, 1, 1, 0], np.float32)
    for ww in (None, w):
        got = float(tl.categorical_accuracy(_t(p), _t(oh),
                                            None if ww is None else _t(ww)))
        np.testing.assert_allclose(
            got, float(jl.categorical_accuracy(p, oh, ww)), rtol=RTOL)


def test_climo_forecast(rng):
    x = rng.normal(size=(7, 3, 4)).astype(np.float32)
    x[:, 0, 1] = np.nan
    np.testing.assert_array_equal(tm.climo_forecast(x).numpy(),
                                  np.asarray(jm.climo_forecast(x)))


def _fcst_labels(rng, T=30, S=(4, 5)):
    f = rng.dirichlet(np.ones(3), size=(T,) + S).astype(np.float32)
    lab = rng.integers(0, 3, (T,) + S).astype(np.float32)
    lab[rng.random(lab.shape) < 0.1] = np.nan
    lab[:, 0, 0] = np.nan                             # all-NaN pixel
    return f, lab


@pytest.mark.parametrize("masked", [False, True])
def test_rps(rng, masked):
    f, lab = _fcst_labels(rng)
    m = (rng.random(f.shape[0]) > 0.4) if masked else None
    got = tm.rps(f, lab, m).numpy()
    want = np.asarray(jm.rps(f, lab, m))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True])
def test_rpss(rng, masked):
    f, lab = _fcst_labels(rng)
    x = rng.normal(size=lab.shape).astype(np.float32)
    x[:, 1, 1] = np.nan
    climo = np.asarray(jm.climo_forecast(x))
    m = (rng.random(f.shape[0]) > 0.4) if masked else None
    got = tm.rpss(tm.climo_forecast(x), f, lab, m).numpy()
    want = np.asarray(jm.rpss(climo, f, lab, m))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    # rtol on the RPS ratio 1 - RPSS: RPSS itself sits near 0 here, where
    # a relative tolerance on the difference would be meaningless
    np.testing.assert_allclose(1.0 - got, 1.0 - want, rtol=RTOL)

"""Port vs JAX: masked quantiles and rolling tercile labels.

Mirrors tests/test_terciles.py. The same numpy inputs go through
s2s_ismr_tpu.ops (JAX, CPU) and s2s_ismr_tpu_torch.ops. Labels must be
bit-equal (NaN positions included); edges agree at rtol 1e-6 (float32, the
same op sequence on both sides).
"""

import numpy as np
import pytest
import torch

from s2s_ismr_tpu.ops import quantiles as jq
from s2s_ismr_tpu.ops import terciles as jt
from s2s_ismr_tpu_torch import timeutils
from s2s_ismr_tpu_torch.data import synthetic
from s2s_ismr_tpu_torch.grid import Domain
from s2s_ismr_tpu_torch.ops import quantiles as tq
from s2s_ismr_tpu_torch.ops import terciles as tt


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def bundle():
    return synthetic.synthetic_hindcast(years=(2003, 2012), seed=5,
                                        domain=Domain(67, 98, 7, 38), step=2.0)


def test_masked_quantile_matches_jax(rng):
    v = rng.normal(size=(40, 6, 7)).astype(np.float32)
    valid = rng.random((40, 6, 7)) > 0.3
    qs = [1 / 3, 2 / 3]
    got = _np(tq.masked_quantile(v, valid, qs, axis=0))
    np.testing.assert_allclose(got, _np(jq.masked_quantile(v, valid, qs, 0)),
                               rtol=1e-6)
    with np.errstate(all="ignore"):
        expected = np.nanquantile(np.where(valid, v, np.nan), qs, axis=0)
    np.testing.assert_allclose(got, expected, atol=1e-5)


def test_masked_quantile_empty_and_single():
    v = np.array([[1.0, 5.0], [2.0, 7.0], [3.0, 9.0]], np.float32)
    valid = np.array([[False, True], [False, False], [False, False]])
    got = _np(tq.masked_quantile(v, valid, [0.5], axis=0))
    assert np.isnan(got[0, 0])
    assert got[0, 1] == 5.0
    np.testing.assert_array_equal(
        got, _np(jq.masked_quantile(v, valid, [0.5], axis=0)))


def test_masked_mean_matches_jax():
    v = np.array([1.0, np.nan, 3.0], np.float32)
    for valid in (np.ones(3, bool), np.zeros(3, bool),
                  np.array([True, False, False])):
        np.testing.assert_array_equal(_np(tq.masked_mean(v, valid)),
                                      _np(jq.masked_mean(v, valid)))


def _fit_both(y, weeks, pool, degenerate=False):
    wm = timeutils.week_window_matrix(1)
    j = jt.fit_and_label(y, weeks, pool, wm, None, degenerate_mask=degenerate)
    t = tt.fit_and_label(y, weeks, pool, wm, None, degenerate_mask=degenerate)
    return [_np(a) for a in j], [_np(a) for a in t]


def _assert_fit_equal(j, t):
    np.testing.assert_array_equal(t[0], j[0])          # labels, bit-equal
    np.testing.assert_allclose(t[1], j[1], rtol=1e-6)  # edges
    np.testing.assert_array_equal(t[2], j[2])          # present weeks


def test_labeler_full_pool(bundle):
    y = np.nan_to_num(bundle.y, nan=0.0)              # NN-path fillna(0)
    j, t = _fit_both(y, bundle.weeks, np.ones(bundle.n_t, bool))
    _assert_fit_equal(j, t)


def test_labeler_train_pool_and_nearest_borrowing(bundle):
    pool = np.isin(bundle.years, np.unique(bundle.years)[:6])
    y = np.nan_to_num(bundle.y, nan=0.0)
    j, t = _fit_both(y, bundle.weeks, pool)
    _assert_fit_equal(j, t)


def test_labeler_elr_variant_with_nans(bundle):
    pool = np.isin(bundle.years, np.unique(bundle.years)[:7])
    j, t = _fit_both(bundle.y, bundle.weeks, pool, degenerate=True)
    _assert_fit_equal(j, t)
    assert np.isnan(t[0][:, np.isnan(bundle.y[0])]).all()


def test_labeler_week53_wrap(rng):
    """Weeks 52, 53 and 1 pool across the year boundary (%53 wrap)."""
    weeks = np.concatenate([np.arange(1, 54), rng.integers(1, 54, 80),
                            [53, 53, 1, 1, 52]]).astype(np.int32)
    y = rng.gamma(1.5, 2.0, size=(weeks.size, 3, 4)).astype(np.float32)
    y[rng.random(y.shape) < 0.1] = 0.0                 # ties at zero
    pool = rng.random(weeks.size) > 0.4
    for degenerate in (False, True):
        j, t = _fit_both(y, weeks, pool, degenerate)
        _assert_fit_equal(j, t)


def test_elr_targets_match_jax(bundle):
    pool = np.ones(bundle.n_t, bool)
    wm = timeutils.week_window_matrix(1)
    e, p = jt.rolling_edges(bundle.y, bundle.weeks, pool, wm)
    te, tp = tt.rolling_edges(bundle.y, bundle.weeks, pool, wm)
    np.testing.assert_array_equal(
        _np(tt.elr_targets(bundle.y, bundle.weeks, te, tp)),
        _np(jt.elr_targets(bundle.y, bundle.weeks, e, p)))


def test_one_hot_labels_nan_preserving():
    lab = np.array([0.0, 1.0, 2.0, np.nan, 2.0], np.float32)
    np.testing.assert_array_equal(_np(tt.one_hot_labels(lab)),
                                  _np(jt.one_hot_labels(lab)))


def test_nearest_present_week_tiebreak():
    present = np.zeros(53, bool)
    present[[19, 29]] = True                # weeks 20 and 30
    near = _np(tt.nearest_present_week(present))
    assert near[24] == 29                   # week 25: tie -> larger
    assert near[0] == 19 and near[52] == 29
    np.testing.assert_array_equal(near, _np(jt.nearest_present_week(present)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nearest_present_week_matches_jax(seed):
    present = np.random.default_rng(seed).random(53) > 0.7
    np.testing.assert_array_equal(_np(tt.nearest_present_week(present)),
                                  _np(jt.nearest_present_week(present)))


def test_static_terciles_match_jax(rng):
    y = rng.gamma(2, 2, size=(60, 4, 4)).astype(np.float32)
    y[:, 0, 0] = np.nan
    pool = np.zeros(60, bool)
    pool[:30] = True
    for pm in (None, pool):
        jl, je = jt.static_terciles(y, pm)
        tl, te = tt.static_terciles(y, pm)
        np.testing.assert_array_equal(_np(tl), _np(jl))
        np.testing.assert_allclose(_np(te), _np(je), rtol=1e-6)

"""Port vs JAX: the binned REL/BSS/RES diagnostics and CC/ACC of
s2s_ismr_tpu_torch/ops/metrics.py.

Mirrors tests/test_metrics.py:119-200 (test_bss_rel_res_match_reference,
test_binning_exact_edge_values, test_masked_corr_matches_numpy,
test_weekly_climatology_and_acc, test_anomaly_cc_external_climatology):
the same numpy inputs from a seed go through the JAX function and the
port's, on the CPU. Tolerance: 1e-6 abs (float32, sum order only), NaN
pattern identical; the reference formulas of tests/test_metrics.py hold
both within their 1e-5.
"""

import numpy as np
import pytest
import torch

from s2s_ismr_tpu.ops import metrics as jm
from s2s_ismr_tpu_torch.ops import metrics as tm
from test_metrics import ref_bss, ref_reliability, ref_resolution

ATOL = 1e-6
SCORES = ("brier_skill_score", "reliability_score", "resolution_score")


def _both(name, *args, **kw):
    """(JAX, port) results of metrics.`name` on the same numpy inputs."""
    j = np.asarray(getattr(jm, name)(*args, **kw), np.float32)
    t = getattr(tm, name)(*args, **kw)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    return j, t.numpy()


def _close(j, t, atol=ATOL):
    assert j.shape == t.shape
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    np.testing.assert_allclose(t, j, atol=atol, equal_nan=True)


@pytest.fixture
def probs(rng):
    n = 4000
    p = rng.random(n)
    t = (rng.random(n) < p * 0.7).astype(float)
    return p, t


@pytest.mark.parametrize("name", SCORES)
def test_bss_rel_res_match_reference(probs, name):
    """NaN predictions skipped; with and without an explicit valid mask."""
    p, t = probs
    p2 = p.copy()
    p2[::17] = np.nan
    valid = ~np.isnan(p2 + t)
    _close(*_both(name, p2, t))
    _close(*_both(name, p2, t, valid))
    _close(*_both(name, p[valid], t[valid]))
    keep = valid & (np.arange(p.size) % 3 > 0)
    _close(*_both(name, p2, t, keep))
    ref = {"brier_skill_score": lambda: ref_bss(p2, t),
           "reliability_score": lambda: ref_reliability(t[valid], p[valid]),
           "resolution_score": lambda: ref_resolution(p[valid], t[valid])}
    np.testing.assert_allclose(float(getattr(tm, name)(p2, t)), ref[name](),
                               atol=1e-5)


def test_bss_base_rate_and_multidim(rng):
    p = rng.random((7, 5, 3)).astype(np.float32)
    t = (rng.random((7, 5, 3)) < 0.4).astype(np.float32)
    t[2, 1] = np.nan
    for br in (1 / 3, 0.5):
        _close(*_both("brier_skill_score", p, t, base_rate=br))


@pytest.mark.parametrize("name", ("reliability_score", "resolution_score"))
def test_binning_exact_edge_values(rng, name):
    """The digitize(right=True) convention at exact bin edges, p = 0 in
    bin 0, as JAX bins them in float32 (ceil(p * 10) - 1)."""
    edge_p = np.array([0.0, 0.1, 0.1, 0.2, 0.30000001, 0.5, 1.0] * 30)
    t = (rng.random(edge_p.shape) < edge_p).astype(float)
    _close(*_both(name, edge_p, t))
    ref = ref_reliability(t, edge_p) if name == "reliability_score" \
        else ref_resolution(edge_p, t)
    np.testing.assert_allclose(float(getattr(tm, name)(edge_p, t)), ref,
                               atol=1e-6)


def test_bin_stats_matches_jax(rng):
    p = rng.random(500).astype(np.float32)
    p[:20] = np.linspace(0, 1, 20)
    p[25] = np.nan
    t = (rng.random(500) < p).astype(np.float32)
    valid = rng.random(500) < 0.9
    for j, t_ in zip(jm._bin_stats(p, t, valid), tm._bin_stats(p, t, valid)):
        _close(np.asarray(j), t_.numpy())


def test_masked_corr_matches_numpy(rng):
    T = 50
    a = rng.normal(size=(T, 4, 4)).astype(np.float32)
    b = (0.6 * a + 0.8 * rng.normal(size=(T, 4, 4))).astype(np.float32)
    b[:, 0, 0] = np.nan
    a[3:7, 1, 1] = np.nan
    a[:49, 2, 2] = np.nan                  # one valid sample: NaN
    b[:, 3, 3] = 1.0                       # zero variance: NaN
    j, t = _both("masked_corr", a, b)
    _close(j, t)
    assert np.isnan(t[0, 0]) and np.isnan(t[2, 2]) and np.isnan(t[3, 3])
    ok = ~np.isnan(a[:, 1, 1] + b[:, 1, 1])
    np.testing.assert_allclose(
        t[1, 1], np.corrcoef(a[ok, 1, 1], b[ok, 1, 1])[0, 1], atol=1e-4)
    t_mask = rng.random(T) < 0.7
    _close(*_both("masked_corr", a, b, t_mask))


def test_weekly_climatology_and_acc(rng):
    T = 80
    weeks = (np.arange(T) % 20) + 18
    clim_true = np.linspace(0, 5, 53)[:, None, None].astype(np.float32) \
        * np.ones((1, 3, 3), np.float32)
    noise = rng.normal(size=(T, 3, 3)).astype(np.float32)
    x = clim_true[weeks - 1] + noise
    x[4, 0, 0] = np.nan
    j, t = _both("weekly_climatology", x, weeks)
    assert t.shape == (53, 3, 3)
    _close(j, t)
    assert np.isnan(t[0]).all() and np.isfinite(t[17:37]).all()
    t_mask = rng.random(T) < 0.6
    _close(*_both("weekly_climatology", x, weeks, t_mask))
    y = clim_true[weeks - 1] + 0.5 * noise + \
        0.8 * rng.normal(size=(T, 3, 3)).astype(np.float32)
    _close(*_both("anomaly_cc", x, y, weeks))
    _close(*_both("anomaly_cc", x, y, weeks, t_mask=t_mask))
    acc = tm.anomaly_cc(x, y, weeks).numpy()
    cc = tm.masked_corr(x, y).numpy()
    assert np.nanmean(cc) > np.nanmean(acc)   # seasonal cycle inflates CC
    assert 0.05 < np.nanmean(acc) < 0.95


@pytest.mark.parametrize("kind", ["weekly", "per_sample"])
def test_anomaly_cc_external_climatology(rng, kind):
    """A (53,*S) climatology is indexed by ISO week, a (T,*S) one is used
    per sample, as JAX tells them apart (shape[0] == 53)."""
    T = 40
    weeks = (np.arange(T) % 10) + 20
    x = rng.normal(size=(T, 2, 2)).astype(np.float32)
    y = x + 0.1 * rng.normal(size=(T, 2, 2)).astype(np.float32)
    n = 53 if kind == "weekly" else T
    ext = rng.normal(size=(n, 2, 2)).astype(np.float32)
    _close(*_both("anomaly_cc", x, y, weeks, x_clim=ext))
    _close(*_both("anomaly_cc", x, y, weeks, x_clim=ext, y_clim=ext))
    zero = np.zeros((n, 2, 2), np.float32)      # zero climatology: raw CC
    np.testing.assert_allclose(
        tm.anomaly_cc(x, y, weeks, x_clim=zero, y_clim=zero).numpy(),
        tm.masked_corr(x, y).numpy(), atol=1e-5)


def test_metrics_follow_the_input_device_and_repeat_bit_equal(rng):
    """Tensors in, tensors out on the input's device; a repeat gives the
    same bits (no scatter-add: the sums reduce a one-hot mask)."""
    p = torch.as_tensor(rng.random(300).astype(np.float32))
    t = torch.as_tensor((rng.random(300) < 0.3).astype(np.float32))
    for name in SCORES:
        a, b = getattr(tm, name)(p, t), getattr(tm, name)(p, t)
        assert a.device == p.device and a.shape == ()
        assert a.numpy().tobytes() == b.numpy().tobytes()
    x = torch.as_tensor(rng.normal(size=(60, 3, 3)).astype(np.float32))
    weeks = (np.arange(60) % 20) + 18
    c1 = tm.weekly_climatology(x, weeks)
    assert torch.equal(c1[17:37], tm.weekly_climatology(x, weeks)[17:37])

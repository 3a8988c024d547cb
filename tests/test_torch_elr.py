"""Port vs JAX: the ELR baseline (ops/elr.py).

Mirrors tests/test_elr.py and tests/test_elr_edge_cases.py. The same numpy
inputs go through s2s_ismr_tpu.ops.elr (JAX, CPU) and
s2s_ismr_tpu_torch.ops.elr, and the port is held to the JAX tests' own
assertions (scipy MLE, the statsmodels-GLM oracle). Tolerances, float32
(the row sums run in another order on each side):
  * betas: rtol 1e-4 / atol 1e-5 of JAX on well-conditioned pixels, and
    5e-3 of the scipy MLE;
  * probabilities: atol 1e-5 of JAX, 1e-4 where eta runs to the clip
    (perfectly separable or constant-target pixels, whose betas after 30
    iterations depend on rounding); NaN pattern identical.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_elr_edge_cases as oracle
from s2s_ismr_tpu.ops import elr as jelr
from s2s_ismr_tpu.ops import terciles as jterc
from s2s_ismr_tpu_torch import timeutils
from s2s_ismr_tpu_torch.data import synthetic
from s2s_ismr_tpu_torch.grid import Domain
from s2s_ismr_tpu_torch.ops import elr as telr
from s2s_ismr_tpu_torch.ops import metrics as tmetrics
from s2s_ismr_tpu_torch.ops import terciles as tterc
from s2s_ismr_tpu_torch.train import splits
from test_elr import _design, _ref_logit_fit

# The suite runs in several xdist worker processes on few cores: share the
# cores among them, or torch's intra-op threads oversubscribe the machine
# and every worker crawls.
if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _scaled_q(T):
    q = (np.concatenate([np.full(T, 33.0), np.full(T, 67.0)]) - 50.0) / 17.0
    return np.broadcast_to(q[:, None], (2 * T, 1)).astype(np.float32)


def _both_irls(x2, y2, w, q):
    j = [np.asarray(v) for v in jelr._irls_pixels(
        jnp.asarray(x2), jnp.asarray(y2), jnp.asarray(w), jnp.asarray(q))]
    t = [v.numpy() for v in telr._irls_pixels(
        torch.tensor(x2), torch.tensor(y2), torch.tensor(w),
        torch.tensor(q))]
    return j, t


def test_constants_as_jax():
    for name in ("Q_INDICATOR", "N_IRLS_ITERS", "RIDGE", "ETA_CLIP",
                 "_Q_CENTER", "_Q_SCALE"):
        assert getattr(telr, name) == getattr(jelr, name), name


def test_irls_matches_jax_and_mle(rng):
    """test_elr.py::test_irls_matches_mle, on 6 well-conditioned pixels."""
    T, P = 120, 6
    x = rng.normal(2.0, 1.0, (T, P)).astype(np.float32)
    true_beta = np.array([0.5, -0.8, 0.01])
    ys = []
    for p in range(P):
        X = _design(x[:, p])
        prob = 1 / (1 + np.exp(-(X @ true_beta)))
        ys.append((rng.random(2 * T) < prob).astype(np.float32))
    y2 = np.stack(ys, 1)
    x2 = np.concatenate([x, x])
    w = np.ones((2 * T, P), np.float32)
    j, t = _both_irls(x2, y2, w, _scaled_q(T))
    for bj, bt in zip(j, t):
        np.testing.assert_allclose(bt, bj, rtol=1e-4, atol=1e-5)
    b0, b1, b2 = t
    for p in range(P):
        # from the scaled-q basis back to [1, x, q]
        beta = np.array([b0[p] - 50.0 * b2[p] / 17.0, b1[p], b2[p] / 17.0])
        np.testing.assert_allclose(beta, _ref_logit_fit(_design(x[:, p]),
                                                        y2[:, p]), atol=5e-3)


def test_irls_batched_folds_equal_single(rng):
    """A leading fold axis computes each fold as its own call would."""
    T, P = 50, 4
    x2 = rng.normal(size=(2, 2 * T, P)).astype(np.float32)
    y2 = (rng.random((2, 2 * T, P)) < 0.4).astype(np.float32)
    w = (rng.random((2, 2 * T, P)) < 0.8).astype(np.float32)
    q = torch.tensor(_scaled_q(T))
    batched = telr._irls_pixels(torch.tensor(x2), torch.tensor(y2),
                                torch.tensor(w), q)
    for f in range(2):
        single = telr._irls_pixels(torch.tensor(x2[f]), torch.tensor(y2[f]),
                                   torch.tensor(w[f]), q)
        for bb, bs in zip(batched, single):
            np.testing.assert_allclose(bb[f].numpy(), bs.numpy(), rtol=1e-6,
                                       atol=1e-7)


def _fold_both(x, tg, train, test, y_raw):
    j = np.asarray(jelr.elr_fold(*(jnp.asarray(a) for a in
                                   (x, tg, train, test, y_raw))))
    t = telr.elr_fold(x, tg, train, test, y_raw).numpy()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    return j, t


def test_fit_pixel_conventions(rng):
    """test_elr.py::test_fit_pixel_conventions."""
    T = 60
    x = rng.gamma(2, 2, T).astype(np.float32)
    q1, q2 = np.quantile(x, [1 / 3, 2 / 3])
    tgt = np.stack([(x <= q1), (x <= q2)]).astype(np.float32)
    valid = np.ones(T, bool)
    valid[5:8] = False
    tgt[:, ~valid] = np.nan
    train = np.zeros(T, bool)
    train[: T // 2] = True
    j, t = _fold_both(x[:, None], tgt[:, :, None], train, ~train,
                      x[:, None].copy())
    probs = t[:, 0]
    np.testing.assert_allclose(t, j, atol=1e-5)
    np.testing.assert_allclose(probs[~valid], 1 / 3)
    np.testing.assert_allclose(probs[valid].sum(-1), 1.0, atol=1e-5)
    lo, hi = x[valid].argmin(), x[valid].argmax()
    assert probs[valid][lo, 0] > probs[valid][hi, 0]


def test_fit_pixel_skip_guards(rng):
    """test_elr.py::test_fit_pixel_skip_guards."""
    T = 40
    x = rng.gamma(2, 2, T).astype(np.float32)
    tgt = np.stack([(x <= 2), (x <= 4)]).astype(np.float32)
    train = np.zeros(T, bool)
    train[: T // 2] = True
    y_nan = x.copy()
    y_nan[3] = np.nan
    _, t = _fold_both(x[:, None], tgt[:, :, None], train, ~train,
                      y_nan[:, None])
    assert np.isnan(t).all()
    few = np.zeros(T, bool)
    few[:1] = True
    tgt2 = tgt.copy()
    tgt2[:, ~few] = np.nan
    _, t2 = _fold_both(x[:, None], tgt2[:, :, None], train, ~train,
                       x[:, None].copy())
    assert np.isnan(t2).all()


# ---------------------------------------- test_elr_edge_cases.py, case by case
def _pixel(x_t, y33, y66, tm, sm=None):
    """(x, targets, train, test, y_raw) of one pixel on a 1x1 grid."""
    T = len(x_t)
    tm = np.asarray(tm, bool)
    sm = ~tm if sm is None else np.asarray(sm, bool)
    return (np.asarray(x_t, np.float32).reshape(T, 1, 1),
            np.stack([y33, y66]).astype(np.float32).reshape(2, T, 1, 1),
            tm, sm, np.ones((T, 1, 1), np.float32))


def _well_behaved(rng):
    T = 60
    x = rng.gamma(2, 2, T).astype(np.float64)
    y33 = ((x + rng.normal(0, 1.5, T)) < np.quantile(x, 1 / 3)).astype(float)
    y66 = np.maximum(y33, ((x + rng.normal(0, 1.5, T))
                           < np.quantile(x, 2 / 3)).astype(float))
    tm = np.ones(T, bool)
    tm[-15:] = False

    def check(got):
        np.testing.assert_allclose(
            got[:, 0, 0], oracle.oracle_pixel_probs(x, y33, y66, tm),
            atol=2e-3)
    return _pixel(x, y33, y66, tm), 1e-5, check


def _perfectly_separable(rng):
    T = 40
    x = np.sort(rng.gamma(2, 2, T)).astype(np.float64)
    thr = np.median(x)
    y33 = (x < thr).astype(float)
    y66 = np.ones(T)
    tm = np.ones(T, bool)
    tm[::4] = False

    def check(got):
        g = got[:, 0, 0]
        np.testing.assert_allclose(
            g, oracle.oracle_pixel_probs(x, y33, y66, tm), atol=1e-2)
        assert g[x < thr - 0.5, 0].min() > 0.95
        assert g[x > thr + 0.5, 0].max() < 0.05
    return _pixel(x, y33, y66, tm), 1e-4, check


def _constant_target_block(rng):
    T = 30
    x = rng.gamma(2, 2, T)
    y33 = rng.integers(0, 2, T).astype(float)
    y66 = np.ones(T)
    tm = np.ones(T, bool)
    tm[::4] = False

    def check(got):
        g = got[:, 0, 0]
        # all three categories, where the JAX test holds only the third
        np.testing.assert_allclose(
            g, oracle.oracle_pixel_probs(x, y33, y66, tm), atol=1e-2)
        assert g[:, 2].max() < 0.01
    # JAX's IRLS diverges on this pixel (test_divergence_guard below)
    return _pixel(x, y33, y66, tm), None, check


def _constant_predictor(rng):
    T = 50
    x = np.full(T, 3.7)
    lab = rng.integers(0, 3, T)
    y33 = (lab == 0).astype(float)
    y66 = (lab <= 1).astype(float)
    tm = np.ones(T, bool)
    tm[::4] = False

    def check(got):
        np.testing.assert_allclose(
            got[:, 0, 0], oracle.oracle_pixel_probs(x, y33, y66, tm),
            atol=2e-3)
    return _pixel(x, y33, y66, tm), 1e-5, check


def _train_constant_test_varying(rng):
    T = 50
    x = np.full(T, 3.7)
    tm = np.ones(T, bool)
    tm[-10:] = False
    x[~tm] = rng.gamma(2, 2, (~tm).sum())
    lab = rng.integers(0, 3, T)
    y33 = (lab == 0).astype(float)
    y66 = (lab <= 1).astype(float)

    def check(got):
        test_probs = got[~tm, 0, 0]
        np.testing.assert_allclose(
            test_probs, np.broadcast_to(test_probs[:1], test_probs.shape),
            atol=1e-6)
        np.testing.assert_allclose(test_probs.sum(-1), 1.0, atol=1e-5)
        want = telr.elr_fold(*_pixel(np.full(T, 3.7), y33, y66, tm)).numpy()
        np.testing.assert_allclose(test_probs, want[~tm, 0, 0], atol=1e-5)
    return _pixel(x, y33, y66, tm), 1e-5, check


def _skip_guards_stay_nan(rng):
    T = 20
    x = rng.gamma(2, 2, (T, 1, 2)).astype(np.float32)
    tg = rng.integers(0, 2, (2, T, 1, 2)).astype(np.float32)
    y_raw = np.ones((T, 1, 2), np.float32)
    y_raw[3, 0, 0] = np.nan                  # pixel 0: raw NaN -> skip
    tg[:, 2:, 0, 1] = np.nan                 # pixel 1: 1 valid train row
    tm = np.ones(T, bool)
    tm[-5:] = False

    def check(got):
        assert np.isnan(got[:, 0, 0, :]).all()
        assert np.isnan(got[:, 0, 1, :]).all()
    return (x, tg, tm, ~tm, y_raw), 1e-5, check


def _label_invalid_times_filled(rng):
    T = 40
    x = rng.gamma(2, 2, T)
    y33 = (x < np.quantile(x, 1 / 3)).astype(float)
    y66 = (x < np.quantile(x, 2 / 3)).astype(float)
    y33[5] = np.nan
    y66[5] = np.nan
    tm = np.ones(T, bool)
    tm[-10:] = False

    def check(got):
        np.testing.assert_allclose(got[5, 0, 0], [1 / 3] * 3, atol=1e-6)
        assert np.isfinite(got).all()
        # the targets are separable in x: the fit puts every valid train
        # row on the side of both cumulative targets
        g, ok = got[:, 0, 0], tm & ~np.isnan(y33)
        np.testing.assert_array_equal(g[ok, 0] > 0.5, y33[ok] == 1)
        np.testing.assert_array_equal(g[ok, :2].sum(-1) > 0.5, y66[ok] == 1)
    # JAX's IRLS diverges on this pixel (test_divergence_guard below)
    return _pixel(x, y33, y66, tm), None, check


EDGE_CASES = {f.__name__[1:]: f for f in (
    _well_behaved, _perfectly_separable, _constant_target_block,
    _constant_predictor, _train_constant_test_varying,
    _skip_guards_stay_nan, _label_invalid_times_filled)}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_case_matches_jax_and_oracle(case, rng):
    """test_elr_edge_cases.py::test_<case>: the JAX test's assertion on the
    port's probabilities, and the port against JAX's elr_fold (NaN pattern
    always; values where JAX's fit converges)."""
    args, atol, check = EDGE_CASES[case](rng)
    j, t = _fold_both(*args)
    if atol is not None:
        np.testing.assert_allclose(t, j, atol=atol)
    check(t)


def _scaled_design(x, tg, train, test, y_raw):
    """elr_fold's IRLS inputs for a one-pixel case: (x2, y2, w, q)."""
    T = len(train)
    xs, y33, y66 = x.reshape(T), tg[0].reshape(T), tg[1].reshape(T)
    w = np.tile(train & ~np.isnan(y33), 2).astype(np.float32)
    x2 = np.tile(xs, 2)
    xm = (w * x2).sum() / w.sum()
    x2 = (x2 - xm) / np.sqrt((w * (x2 - xm) ** 2).sum() / w.sum())
    y2 = np.nan_to_num(np.concatenate([y33, y66]))
    return (x2[:, None].astype(np.float32), y2[:, None].astype(np.float32),
            w[:, None], _scaled_q(T))


@pytest.mark.parametrize("case", ["constant_target_block",
                                  "label_invalid_times_filled"])
def test_divergence_guard(case, rng):
    """The fault the port's divergence guard repairs (ROADMAP section C):
    on a pixel whose fit saturates, JAX's 30 float32 IRLS iterations lose
    the solve and end at betas of order 1e7-1e8; the port stops at the
    first step that raises the deviance and keeps finite betas of the
    saturated fit (its probabilities are held to the oracle above)."""
    args, _, _ = EDGE_CASES[case](rng)
    j, t = _both_irls(*_scaled_design(*args))
    assert max(abs(float(b[0])) for b in j) > 1e6
    assert max(abs(float(b[0])) for b in t) < 1e3


# ---------------------------------------------------------- folds, blend
@pytest.fixture(scope="module")
def two_folds():
    b = synthetic.synthetic_hindcast(years=(2003, 2010), seed=3, signal=0.8,
                                     domain=Domain(67, 98, 7, 38), step=2.0)
    fm = splits.bootstrap_masks_elr(b.years, n_bootstraps=2)
    wm = timeutils.week_window_matrix(1)
    tgt = []
    for f in range(2):
        edges, present = jterc.rolling_edges(b.y, b.weeks, fm.train[f], wm)
        tgt.append(np.asarray(jterc.elr_targets(b.y, b.weeks, edges,
                                                present)))
    return b, fm, np.stack(tgt)


def test_elr_folds_matches_jax(two_folds):
    """test_elr.py::test_elr_folds_end_to_end, port against JAX."""
    b, fm, tgt = two_folds
    x_mean = b.ensemble_mean()
    want = np.asarray(jelr.elr_folds(x_mean, tgt, fm.train, fm.test, b.y))
    got = telr.elr_folds(x_mean, tgt, fm.train, fm.test, b.y).numpy()
    assert got.shape == (2,) + b.y.shape + (3,)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-5)
    ocean = np.isnan(b.y[0])
    assert np.isnan(got[:, :, ocean]).all()
    pv = got[:, :, ~ocean]
    assert np.isfinite(pv).all()
    np.testing.assert_allclose(pv.sum(-1), 1.0, atol=1e-4)
    # some skill: mean test RPSS vs climatology > 0
    lab0, _, _ = tterc.fit_and_label(b.y, b.weeks, fm.train[0],
                                     timeutils.week_window_matrix(1), None,
                                     degenerate_mask=True)
    climo = tmetrics.climo_forecast(x_mean)
    r = tmetrics.rpss(climo, torch.tensor(got[0]), lab0, fm.test[0]).numpy()
    assert np.nanmean(r) > 0.0, f"mean test RPSS {np.nanmean(r)}"


def test_elr_fold_is_elr_folds_of_one(two_folds):
    b, fm, tgt = two_folds
    x_mean = b.ensemble_mean()
    one = telr.elr_fold(x_mean, tgt[1], fm.train[1], fm.test[1], b.y)
    many = telr.elr_folds(x_mean, tgt, fm.train, fm.test, b.y)
    np.testing.assert_array_equal(one.numpy(), many[1].numpy())


def test_blend_probabilities():
    """test_elr.py::test_blend_probabilities, plus JAX's NaN propagation."""
    a = np.array([[0.5, 0.3, 0.2], [np.nan] * 3], np.float32)
    c = np.array([[0.1, 0.2, 0.7], [0.2, 0.3, 0.5]], np.float32)
    got = telr.blend_probabilities([torch.tensor(a), torch.tensor(c)]).numpy()
    want = np.asarray(jelr.blend_probabilities([jnp.asarray(a),
                                                jnp.asarray(c)]))
    np.testing.assert_allclose(got[0], [0.3, 0.25, 0.45], atol=1e-6)
    np.testing.assert_allclose(got[0].sum(), 1.0, atol=1e-6)
    assert np.isnan(got[1]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-7)

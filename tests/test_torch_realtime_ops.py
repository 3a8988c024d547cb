"""Port vs JAX: the realtime path's MJO/ENSO machinery, index acquisition,
composites, `evaluate_realtime` and `render_figures`
(s2s_ismr_tpu_torch/pipelines/realtime.py).

Mirrors tests/test_indices_mjo_enso.py (test_mjo_phase_missing_index,
test_enso_state_unknown, test_rmm_sampling_from_cache,
test_nino34_monthly_sampling, test_fetch_indices_degrade_gracefully,
test_write_composites) and tests/test_attrib_checkpoint_realtime.py
(test_mjo_phase_and_enso, test_evaluate_realtime_end_to_end). The MJO/ENSO
helpers and the sampled indices are bit-equal to JAX's; evaluate_realtime's
labels equal and its probabilities, RPS, RPSS, GradCAM and composites
within 1e-5, on the same numpy inputs with flax weights converted by
models/convert.py. The entry points are in tests/test_torch_realtime.py, whose
fake-cache writers and comparisons this file shares.
"""

import os

import jax
import numpy as np
import torch

from s2s_ismr_tpu.pipelines import realtime as jrt
from s2s_ismr_tpu_torch.models import UNetConfig
from s2s_ismr_tpu_torch.models.convert import from_flax
from s2s_ismr_tpu_torch.pipelines import realtime as trt
from s2s_ismr_tpu_torch.train import checkpoint as tcheckpoint
from test_torch_realtime import (DATES, JAX_NET, WK, _jax_init, _same_files,
                                 _same_result, _write_indices, quiet)

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def test_mjo_enso_composites_bit_equal(rng):
    r1, r2 = rng.normal(0, 1.5, 40), rng.normal(0, 1.5, 40)
    r1[[3, 17]] = np.nan
    for a, b in zip(trt.mjo_phase(r1, r2), jrt.mjo_phase(r1, r2)):
        np.testing.assert_array_equal(a, b, strict=True)
    nino = rng.normal(0, 0.8, 40)
    nino[5] = np.nan
    np.testing.assert_array_equal(trt.enso_state(nino), jrt.enso_state(nino))
    vals = rng.normal(size=(40, 4, 5))
    vals[2, 1, 1] = np.nan
    groups = trt.enso_state(nino)
    a, b = trt.composite_by(vals, groups), jrt.composite_by(vals, groups)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], strict=True)


def test_indices_and_composites_as_jax(tmp_path):
    cache = str(tmp_path / "cache")
    _write_indices(cache)
    dates = DATES[:2] + ["2023-09-30"]
    a = trt.fetch_indices_for_dates(dates, download=False, cache_dir=cache,
                                    log=quiet)
    b = jrt.fetch_indices_for_dates(dates, download=False, cache_dir=cache,
                                    log=quiet)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v, strict=True)
    msgs = []
    assert trt.fetch_indices_for_dates(
        DATES[:1], download=False, cache_dir=str(tmp_path),
        log=msgs.append) == (None, None)
    assert any("MJO composites skipped" in m for m in msgs)
    assert any("ENSO composites skipped" in m for m in msgs)

    kw = dict(probs=np.zeros((2, 4, 4, 3)), labels=None, rps_map=None,
              rpss_map=None, gradcam_maps=None,
              mjo_composites={"3": np.full((4, 4), 0.4),
                              "inactive": np.full((4, 4), 0.3)},
              enso_composites={"elnino": np.full((4, 4), 0.5)})
    coords = {"Y": np.arange(4.0), "X": np.arange(4.0)}
    tp = trt.write_composites(trt.RealtimeResult(**kw), str(tmp_path / "t"),
                              coords, WK, tag="x")
    jp = jrt.write_composites(jrt.RealtimeResult(**kw), str(tmp_path / "j"),
                              coords, WK, tag="x")
    assert set(tp) == {"mjo_3", "mjo_inactive", "enso_elnino"}
    _same_files(tp, jp, str(tmp_path / "t"), str(tmp_path / "j"))


# ------------------------------------------------------ evaluate_realtime
def test_evaluate_realtime_matches_jax(tmp_path):
    """test_evaluate_realtime_end_to_end's inputs, with and without a
    mask of verified rows and with precomputed (blended) probabilities."""
    net = JAX_NET
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 16, 16, 1)).astype(np.float32)
    var = _jax_init(jax.random.key(0))
    model = tcheckpoint.model_factory("unet", (1, 16, 16, 1), UNetConfig(
        filters=1, n_blocks=2), "cpu")(torch.Generator())
    state = from_flax(var)
    Th = 60
    hind_obs = rng.gamma(2, 2, (Th, 16, 16)).astype(np.float32)
    hind_weeks = (np.arange(Th) % 20 + 18).astype(np.int32)
    obs = rng.gamma(2, 2, (3, 16, 16)).astype(np.float32)
    fweeks = np.array([20, 25, 30], np.int32)
    rmm = rng.normal(0, 1.5, (3, 2))
    nino = np.array([0.8, 0.0, -1.0])
    probs = rng.dirichlet(np.ones(3), (3, 16, 16)).astype(np.float32)
    for kw in ({}, {"obs_t_mask": np.array([True, False, True])},
               {"probs": probs}):
        t = trt.evaluate_realtime(model, state, x, hind_obs, hind_weeks,
                                  fweeks, obs=obs, rmm=rmm, nino34=nino,
                                  device="cpu", **kw)
        j = jrt.evaluate_realtime(net, var, x, hind_obs, hind_weeks, fweeks,
                                  obs=obs, rmm=rmm, nino34=nino, **kw)
        _same_result(t, j)
        assert t.enso_composites.keys() == {"elnino", "neutral", "lanina"}
    assert np.isnan(t.labels).sum() < t.labels.size
    figs = trt.render_figures(t, np.arange(16.0), np.arange(16.0),
                              [f"valid {i}" for i in range(3)],
                              str(tmp_path / "figs"), WK, tag="t0")
    assert set(figs) == {"fig_probs", "fig_gradcam", "fig_mjo", "fig_enso"}
    for p in figs.values():
        assert os.path.getsize(p) > 5000 and p.endswith(".png")

"""Port vs JAX: the realtime entry points (s2s_ismr_tpu_torch/pipelines/realtime.py).

Mirrors tests/test_realtime_operational.py (the fake-IRIDL-cache fixture,
test_fetch_realtime_set_matches_obs, test_fetch_realtime_future_unverified,
test_run_realtime_forecast_end_to_end, test_run_realtime_forecast_rejects_stacked,
test_unverified_dates_do_not_score, test_fingerprint_mismatch_fails_before_fetch,
test_realtime_eval_applies_grid_pad, test_realtime_standardize_transform,
test_run_realtime_forecast_mme_blend, test_run_realtime_eval_mme),
tests/test_indices_mjo_enso.py (test_operational_forecast_emits_composites)
and tests/test_attrib_checkpoint_realtime.py (test_sweep_winner_save_load).

Both packages run on the same cached netcdfs and synthetic hindcasts. The
JAX winners are flax variables saved by the JAX checkpoint; the port's are
the same variables converted by models/convert.py and saved by the port's
checkpoint, each in its own root. Labels equal; probabilities, RPS, RPSS,
GradCAM and composites within 1e-5; the netcdfs of a run compared file by
file; refusals raise before any fetch with JAX's messages. The MJO/ENSO
machinery and evaluate_realtime are in tests/test_torch_realtime_ops.py.
"""

import json
import os
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from s2s_ismr_tpu.grid import Domain as JDomain
from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.pipelines import realtime as jrt
from s2s_ismr_tpu.pipelines.configs import PipelineConfig as JConfig
from s2s_ismr_tpu.train import checkpoint as jcheckpoint
from s2s_ismr_tpu.train import sweep as jsweep
from s2s_ismr_tpu_torch.grid import Domain as TDomain
from s2s_ismr_tpu_torch.io import read_netcdf
from s2s_ismr_tpu_torch.models import UNetConfig
from s2s_ismr_tpu_torch.models.convert import from_flax
from s2s_ismr_tpu_torch.pipelines import realtime as trt
from s2s_ismr_tpu_torch.pipelines.configs import PipelineConfig as TConfig
from s2s_ismr_tpu_torch.train import checkpoint as tcheckpoint
from s2s_ismr_tpu_torch.train import sweep as tsweep

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

LATS = 7.0 + 2.0 * np.arange(16)
LONS = 67.0 + 2.0 * np.arange(16)
EPOCH = np.datetime64("1999-01-01")
WK = "wk3-4"
ATOL = 1e-5
DATES = ["2023-06-15", "2023-06-22", "2023-08-15"]   # the last: unverified


def quiet(*a):
    pass


def _days(date_str):
    return float((np.datetime64(date_str) - EPOCH) / np.timedelta64(1, "D"))


def _write_nc(path, var, dims, coords, values):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with netcdf_file(path, "w") as f:
        for d in dims:
            f.createDimension(d, len(coords[d]))
            v = f.createVariable(d, np.float64, (d,))
            v[:] = coords[d]
            if d in ("S", "T"):
                v.units = "days since 1999-01-01"
        dv = f.createVariable(var, np.float32, dims)
        dv[:] = np.asarray(values, np.float32)


def _write_cache(cache, out_dir, model, rng, dates=DATES,
                 obs_dates=("2023-07-07", "2023-07-14", "2023-07-21")):
    """Dated forecasts (one S, 4 members each; gateway.download_forecast's
    cache names) and the verifying obs series of one model."""
    fdir = os.path.join(cache, out_dir, f"{model}_IMD")
    for date in dates:
        d = np.datetime64(date).astype(object)
        name = (f"forecast_{model}_{d.day}_{d.strftime('%b')}_{d.year}"
                f"_ld16-29.nc")
        _write_nc(os.path.join(fdir, name), "prcp", ("S", "M", "Y", "X"),
                  {"S": np.array([_days(date)]), "M": np.arange(1.0, 5.0),
                   "Y": LATS, "X": LONS},
                  rng.gamma(2, 2, size=(1, 4, 16, 16)))
    _write_nc(os.path.join(fdir, f"IMD_{WK}.nc"), "prcp", ("T", "Y", "X"),
              {"T": np.array([_days(d) for d in obs_dates]), "Y": LATS,
               "X": LONS}, rng.gamma(2, 2, size=(len(obs_dates), 16, 16)))


def _write_indices(cache):
    """Daily RMM over Jun 2023 and monthly Nino3.4 for 2023."""
    def series(name, t, values):
        path = os.path.join(cache, "indices", f"{name}.nc")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with netcdf_file(path, "w") as f:
            f.createDimension("T", len(t))
            tv = f.createVariable("T", np.float64, ("T",))
            tv[:] = t
            tv.units = "days since 1999-01-01"
            dv = f.createVariable(name, np.float32, ("T",))
            dv[:] = np.asarray(values, np.float32)
    daily = [_days(f"2023-06-{d:02d}") for d in range(1, 31)]
    series("RMM1", daily, np.linspace(-2, 2, 30))
    series("RMM2", daily, np.linspace(2, -2, 30))
    series("NINO34", [_days(f"2023-{m:02d}-16") for m in range(1, 13)],
           [1.2, 0.9, 0.4, 0.1, -0.2, -0.6, -0.8, -0.6, -0.3, 0.1, 0.6, 1.1])


JAX_NET = JaxUNet(JaxUNetConfig(filters=1, n_blocks=2))
_jax_init = jax.jit(lambda k: JAX_NET.init(
    k, np.zeros((1, 16, 16, 1), np.float32), train=False))


def _configs(name, models, out_dir):
    kw = dict(name=name, models=models, obs="IMD", years=(2003, 2012),
              week=WK, out_dir=out_dir, n_bootstraps=2, epochs=2)
    return (JConfig(domain=JDomain(67, 98, 7, 38),
                    tuning=jsweep.TuningGrid(), **kw),
            TConfig(domain=TDomain(67, 98, 7, 38),
                    tuning=tsweep.TuningGrid(), **kw))


def _save_winners(jroot, troot, cfg, model, key, val_losses=(0.9, 1.0)):
    """One flax U-Net (filters 1, n_blocks 2) per fold, saved by the JAX
    checkpoint under jroot and converted and saved by the port's under
    troot. Returns the flax variables per fold."""
    var = [_jax_init(jax.random.key(key + f))
           for f in range(len(val_losses))]
    n = len(var)
    loss = np.asarray(val_losses)
    sub = os.path.join("models", cfg.out_dir, f"{model}_IMD", WK)
    jcheckpoint.save_sweep_winners(jsweep.SweepResult(
        best_val_loss=loss, best_trial=[jsweep.Trial(0, 16, 1e-3, (3, 3), 1,
                                                     2)] * n,
        predictions=np.zeros((n, 1, 16, 16, 3)), val_loss_table=loss[:, None],
        winner_variables=var, winner_configs=[JAX_NET.config] * n),
        os.path.join(jroot, sub), WK, input_shape=(1, 16, 16, 1))
    tcfg = UNetConfig(filters=1, n_blocks=2)
    tcheckpoint.save_sweep_winners(tsweep.SweepResult(
        best_val_loss=loss, best_trial=[tsweep.Trial(0, 16, 1e-3, (3, 3), 1,
                                                     2)] * n,
        predictions=torch.zeros((n, 1, 16, 16, 3)),
        val_loss_table=loss[:, None],
        winner_variables=[from_flax(v) for v in var],
        winner_configs=[tcfg] * n),
        os.path.join(troot, sub), WK, input_shape=(1, 16, 16, 1))
    return var


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The single-model fixture: GEFS forecasts for DATES, obs, the index
    series, and winners (fold 1 the better one) in a JAX and a port root."""
    root = tmp_path_factory.mktemp("rt")
    jcfg, tcfg = _configs("rt_test", ("GEFS",), "Realtime Test/")
    cache = str(root / "cache")
    _write_cache(cache, jcfg.out_dir, "GEFS", np.random.default_rng(0))
    _write_indices(cache)
    jroot, troot = str(root / "jax"), str(root / "port")
    _save_winners(jroot, troot, jcfg, "GEFS", 0, val_losses=(1.0, 0.9))
    return dict(jcfg=jcfg, tcfg=tcfg, cache=cache, jroot=jroot, troot=troot)


@pytest.fixture(scope="module")
def mme(tmp_path_factory):
    """Two models with their own forecasts, obs and distinct winners."""
    root = tmp_path_factory.mktemp("rtmme")
    jcfg, tcfg = _configs("rt_mme_test", ("GEFS", "ECMWF"),
                          "Realtime MME Test/")
    cache = str(root / "cache")
    rng = np.random.default_rng(1)
    jroot, troot = str(root / "jax"), str(root / "port")
    for m, key in (("GEFS", 11), ("ECMWF", 23)):
        _write_cache(cache, jcfg.out_dir, m, rng, dates=DATES[:1],
                     obs_dates=("2023-07-07",))
        _save_winners(jroot, troot, jcfg, m, key)
    return dict(jcfg=jcfg, tcfg=tcfg, cache=cache, jroot=jroot, troot=troot)


def _same_result(t, j):
    np.testing.assert_allclose(t.probs, j.probs, atol=ATOL)
    for name in ("labels", "rps_map", "rpss_map", "gradcam_maps"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), name)
        if name == "labels":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)
    for kind in ("mjo_composites", "enso_composites"):
        a, b = getattr(t, kind), getattr(j, kind)
        assert sorted(a) == sorted(b), kind
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, err_msg=k)


def _same_files(tpaths, jpaths, troot, jroot):
    """The same outputs tree, file by file: names, dims, coords, values."""
    assert sorted(tpaths) == sorted(jpaths)
    for k in tpaths:
        assert os.path.relpath(tpaths[k], troot) == \
            os.path.relpath(jpaths[k], jroot), k
        if not tpaths[k].endswith(".nc"):
            continue
        a, b = read_netcdf(tpaths[k]), read_netcdf(jpaths[k])
        assert a.dims == b.dims and a.name == b.name, k
        for d in a.coords:
            np.testing.assert_array_equal(a.coords[d], b.coords[d])
        np.testing.assert_allclose(a.values, b.values, atol=ATOL,
                                   err_msg=k)


def _forecast(pkg, fx, cfg, dates, root=None, **kw):
    args = dict(out_root=root or fx["troot" if pkg is trt else "jroot"],
                download=False, cache_dir=fx["cache"],
                hindcast_source="synthetic", synthetic_step=2.0, log=quiet,
                **kw)
    if pkg is trt:
        args["device"] = "cpu"
    return pkg.run_realtime_forecast(cfg, dates, **args)


def _eval(pkg, fx, cfg, root=None, **kw):
    args = dict(out_root=root or fx["troot" if pkg is trt else "jroot"],
                source="synthetic", synthetic_step=2.0, log=quiet, **kw)
    if pkg is trt:
        args["device"] = "cpu"
    return pkg.run_realtime_eval(cfg, **args)


# ------------------------------------------------------ the entry points
def test_fetch_realtime_set_matches_jax(single):
    kw = dict(download=False, cache_dir=single["cache"], log=quiet)
    a = trt.fetch_realtime_set(single["tcfg"], DATES, **kw)
    b = jrt.fetch_realtime_set(single["jcfg"], DATES, **kw)
    for f in ("x", "y", "t", "lats", "lons", "name"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      strict=True)
    assert a.x.shape == (3, 4, 16, 16)
    assert np.isfinite(a.y[:2]).all() and np.isnan(a.y[2]).all()
    assert str(a.t[0])[:10] == "2023-07-07"


def test_load_winner_for_realtime_picks_the_best_fold(single):
    sub = os.path.join("models", single["jcfg"].out_dir, "GEFS_IMD", WK)
    model, state = trt.load_winner_for_realtime(
        os.path.join(single["troot"], sub), WK, device="cpu")
    _, jvar = jrt.load_winner_for_realtime(
        os.path.join(single["jroot"], sub), WK)
    for k, v in from_flax(jvar).items():
        assert torch.equal(state[k], v), k      # fold 1: val loss 0.9
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_run_realtime_forecast_matches_jax(single):
    """Two verified init dates and one without verifying obs, composites
    from the cached indices: results and netcdfs equal to JAX's, and the
    unverified row scores nothing."""
    t, tp = _forecast(trt, single, single["tcfg"], DATES)
    j, jp = _forecast(jrt, single, single["jcfg"], DATES)
    _same_result(t, j)
    _same_files(tp, jp, single["troot"], single["jroot"])
    assert {"probs", "gradcam", "rpss", "enso_lanina"} <= set(tp)
    np.testing.assert_allclose(t.probs.sum(-1), 1.0, atol=1e-5)
    assert np.isfinite(t.labels[0]).any() and np.isnan(t.labels[2]).all()
    # scores equal a verified-only run's (masking, not dilution)
    solo, _ = _forecast(trt, single, single["tcfg"], DATES[:2],
                        fetch_indices=False)
    np.testing.assert_array_equal(np.isfinite(t.labels[:2]),
                                  np.isfinite(solo.labels))
    np.testing.assert_allclose(t.rps_map, solo.rps_map, atol=1e-6)


def test_run_realtime_forecast_standardized_matches_jax(single):
    t, _ = _forecast(trt, single, replace(single["tcfg"], standardize=True),
                     DATES[:1], fetch_indices=False)
    j, _ = _forecast(jrt, single, replace(single["jcfg"], standardize=True),
                     DATES[:1], fetch_indices=False)
    _same_result(t, j)
    raw, _ = _forecast(trt, single, single["tcfg"], DATES[:1],
                       fetch_indices=False)
    assert not np.allclose(raw.probs, t.probs)


def test_run_realtime_forecast_mme_matches_jax(mme):
    t, tp = _forecast(trt, mme, mme["tcfg"], DATES[:1])
    j, jp = _forecast(jrt, mme, mme["jcfg"], DATES[:1])
    _same_result(t, j)
    _same_files(tp, jp, mme["troot"], mme["jroot"])
    assert "GEFS_ECMWF_IMD" in tp["probs"]
    np.testing.assert_allclose(t.probs.sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("which", ["single", "mme"])
def test_run_realtime_eval_matches_jax(which, request):
    """The held-out final year of the synthetic record (16x16), scored
    with the winners, single model and MME blend."""
    fx = request.getfixturevalue(which)
    t, tp = _eval(trt, fx, fx["tcfg"])
    j, jp = _eval(jrt, fx, fx["jcfg"])
    _same_result(t, j)
    _same_files(tp, jp, fx["troot"], fx["jroot"])
    assert t.rpss_map is not None and t.mjo_composites and t.enso_composites
    np.testing.assert_allclose(t.probs.sum(-1), 1.0, atol=1e-5)


def test_realtime_eval_applies_grid_pad(single):
    """A pad config's winners (23 -> 24 rows in tune_ECMWF_full) replay on
    the padded grid: here 15 -> 16 rows."""
    cfg = replace(single["tcfg"], pad_y_rows=1, pad_lat_value=39.0,
                  synthetic_grid=(15, 16))
    res, paths = trt.run_realtime_eval(cfg, out_root=single["troot"],
                                       log=quiet, device="cpu")
    assert res.probs.shape[1:] == (16, 16, 3)
    assert os.path.exists(paths["probs"])


# ------------------------------------------------------------- refusals
def _refusal(pkg, fx, cfg, entry, root=None):
    """The message of the ValueError a realtime entry point raises."""
    run = _forecast if entry == "forecast" else _eval
    args = (DATES[:1],) if entry == "forecast" else ()
    with pytest.raises(ValueError) as e:
        run(pkg, fx, cfg, *args, root=root)
    return str(e.value)


@pytest.mark.parametrize("entry", ["forecast", "eval"])
@pytest.mark.parametrize("change", [dict(predictor="stacked"),
                                    dict(output="deterministic")],
                         ids=["stacked", "deterministic"])
def test_refusals_raise_before_fetch_as_jax(single, entry, change,
                                            monkeypatch):
    from s2s_ismr_tpu_torch.data import gateway
    from s2s_ismr_tpu_torch.pipelines import tune

    def fetched(*a, **k):
        raise AssertionError("fetched")
    for mod, name in ((gateway, "download_forecast"), (gateway, "get_obs"),
                      (tune, "load_bundles")):
        monkeypatch.setattr(mod, name, fetched)
    got = _refusal(trt, single, replace(single["tcfg"], **change), entry)
    want = _refusal(jrt, single, replace(single["jcfg"], **change), entry)
    assert got == want


@pytest.mark.parametrize("fp, key", [
    ({"predictor": "multi_predictor", "output": "proba"}, "predictor"),
    ({"predictor": "mean", "output": "proba", "standardize": True},
     "standardize"),
    ({"predictor": "mean", "week": "wk1"}, "week")])
def test_fingerprint_mismatch_fails_before_fetch_as_jax(single, tmp_path,
                                                       fp, key, monkeypatch):
    from s2s_ismr_tpu_torch.data import gateway
    monkeypatch.setattr(gateway, "download_forecast", None)
    src = os.path.join(single["jroot"], "models", single["jcfg"].out_dir,
                       "GEFS_IMD", WK)
    dst = os.path.join(str(tmp_path), "models", single["jcfg"].out_dir,
                       "GEFS_IMD", WK)
    os.makedirs(dst)
    with open(os.path.join(src, f"winners_{WK}.json")) as f:
        manifest = json.load(f)
    for e in manifest:
        e["fingerprint"] = fp
    with open(os.path.join(dst, f"winners_{WK}.json"), "w") as f:
        json.dump(manifest, f)
    for entry in ("forecast", "eval"):
        got = _refusal(trt, single, single["tcfg"], entry, str(tmp_path))
        want = _refusal(jrt, single, single["jcfg"], entry, str(tmp_path))
        assert got == want and key in got


def test_realtime_entry_points_need_a_card(single):
    """With every GPU hidden, device=None raises (no CPU fallback)."""
    assert not torch.cuda.is_available()
    cfg = single["tcfg"]
    sub = os.path.join(single["troot"], "models", cfg.out_dir, "GEFS_IMD",
                       WK)
    for call in (
            lambda: trt.run_realtime_eval(cfg, out_root=single["troot"],
                                          log=quiet),
            lambda: trt.run_realtime_forecast(
                cfg, DATES[:1], out_root=single["troot"], download=False,
                cache_dir=single["cache"], log=quiet),
            lambda: trt.load_winner_for_realtime(sub, WK),
            lambda: trt.evaluate_realtime(
                None, {}, np.zeros((1, 16, 16, 1)), None, None, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

"""Port vs JAX: the reporting slice, `analysis.py`, `pipelines/notebooks.py`
(accs, barplot), `viz/maps.py` and `viz/reliability.py`.

Mirrors tests/test_attrib_checkpoint_realtime.py (test_analysis_skill_maps,
test_analysis_rpss_table, test_accs_and_barplot_drivers),
tests/test_barplot_matrix.py (the cell-5 matrix, the full-matrix figures,
region facets, the MME legacy alias, the MME row masking) and
tests/test_regions.py::test_region_rpss_table_end_to_end. Both packages
run on the same inputs: synthetic bundles from one seed and fake outputs
trees written by the JAX package's writers (the netcdfs are
interchangeable). Tolerances: CC/ACC maps and accs netcdfs within 1e-5
(float32), NaN pattern identical; climatology maps, RPSS records, figure
keys and skipped rows equal. The port's CC/ACC run with device="cpu":
the library defaults to the card.
"""

import os

import numpy as np
import pytest
import torch

from s2s_ismr_tpu import analysis as janalysis
from s2s_ismr_tpu.data import gateway as jgateway
from s2s_ismr_tpu.data import synthetic as jsyn
from s2s_ismr_tpu.grid import Domain as JDomain
from s2s_ismr_tpu.pipelines import notebooks as jnb
from s2s_ismr_tpu.viz import reliability as jrel
from s2s_ismr_tpu_torch import analysis as tanalysis
from s2s_ismr_tpu_torch.data import gateway as tgateway
from s2s_ismr_tpu_torch.data import synthetic as tsyn
from s2s_ismr_tpu_torch.grid import Domain as TDomain
from s2s_ismr_tpu_torch.io import read_netcdf
from s2s_ismr_tpu_torch.pipelines import notebooks as tnb
from s2s_ismr_tpu_torch.viz import reliability as trel
from test_barplot_matrix import _fake_suite_tree, _write_rpss
from test_regions import write_dbf, write_shp

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

ATOL = 1e-5
TABLE_FIELDS = ("values", "lead", "model", "arch", "region", "period")


def quiet(*a):
    pass


def _same_table(t, j):
    for f in TABLE_FIELDS:
        a, b = t._col(f), j._col(f)
        assert a.shape == b.shape, f
        if f == "values":
            np.testing.assert_array_equal(a, b)
        else:
            assert list(a) == list(b), f


def _rel(paths, root):
    """A paths JSON with every path made relative to its root."""
    if isinstance(paths, dict):
        return {k: _rel(v, root) for k, v in paths.items()}
    if isinstance(paths, list):
        return list(paths)
    return os.path.relpath(paths, root)


# ------------------------------------------------------------- CC/ACC maps
def _bundles(**kw):
    kw = dict(years=(2003, 2008), seed=4, signal=0.7, step=2.0, **kw)
    return (jsyn.synthetic_hindcast(domain=JDomain(67, 98, 7, 38), **kw),
            tsyn.synthetic_hindcast(domain=TDomain(67, 98, 7, 38), **kw))


def _same_maps(t, j):
    for f in ("cc", "acc"):
        a, b = np.asarray(getattr(t, f)), np.asarray(getattr(j, f))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, atol=ATOL, equal_nan=True)
    for f in ("climatology", "climatology_fcst", "lats", "lons"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))


@pytest.mark.parametrize("ext", [None, "weekly", "per_sample"])
def test_analysis_skill_maps(ext, rng):
    """compute_skill_maps with the sample climatology, a (53, Y, X) and a
    (T, Y, X) external one (the GEFS dc0018 path)."""
    jb, tb = _bundles()
    clim = None
    if ext:
        n = 53 if ext == "weekly" else tb.n_t
        clim = rng.normal(5, 1, (n,) + tb.shape_yx).astype(np.float32)
    j = janalysis.compute_skill_maps(jb, external_clim=clim)
    t = tanalysis.compute_skill_maps(tb, external_clim=clim, device="cpu")
    _same_maps(t, j)
    land = ~np.isnan(tb.y[0])
    assert np.isfinite(t.acc[land]).all()
    if ext is None:
        assert np.nanmean(t.cc[land]) > 0.2         # signal present


def test_weekly_lead_sweep_matches_jax():
    leads = {"wk1": (2, 8), "wk3-4": (16, 29)}
    kw = dict(years=(2003, 2006), seed=1, step=4.0)
    j = janalysis.weekly_lead_sweep(
        lambda lead: jsyn.synthetic_hindcast(lead=lead, **kw), leads)
    t = tanalysis.weekly_lead_sweep(
        lambda lead: tsyn.synthetic_hindcast(lead=lead, **kw), leads,
        device="cpu")
    assert list(t) == list(j) == list(leads)
    for wk in leads:
        _same_maps(t[wk], j[wk])


def test_skill_maps_default_to_the_card():
    """device=None means the card: without one it raises, never falls
    back to the CPU (device.py)."""
    _, tb = _bundles()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tanalysis.compute_skill_maps(tb)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tnb.run_accs(models=("ECMWF",), years=(2003, 2006), step=4.0,
                     log=quiet)


# ------------------------------------------------------- RPSS aggregation
def test_analysis_rpss_table(tmp_path):
    """rpss_records on a fake tree: the ELR NaN pixel masked, values and
    columns equal to JAX's; the boxplot draws."""
    root = str(tmp_path)
    _write_rpss(root, "Common Period", "ECMWF", "wk3-4", n=4)
    runs = [{"period_dir": "Common Period", "model": "ECMWF", "obs": "IMD",
             "arch": a, "week": "wk3-4", "label": "wk3-4"}
            for a in ("ELR", "unet")]
    t = tanalysis.rpss_records(runs, root)
    _same_table(t, janalysis.rpss_records(runs, root))
    assert len(t.values) == 2 * 15
    p = tanalysis.rpss_boxplot(t, os.path.join(root, "box.png"))
    assert os.path.getsize(p) > 1000


def test_rpss_records_subset_concat_match_jax(tmp_path):
    """The full cell-5 matrix over a fake suite tree, with the masking
    fallbacks and their log lines; subset and concat_tables on it."""
    root = str(tmp_path)
    _fake_suite_tree(root)
    runs = [r for r in jnb.default_barplot_runs()
            if os.path.exists(janalysis.rpss_path(
                root, r["period_dir"], r["model"], r["obs"], r["arch"],
                r["week"]))]
    runs.append({**runs[0], "mask_model": "NOPE"})     # mask fallback
    jlog, tlog = [], []
    j = janalysis.rpss_records(runs, root, log=jlog.append)
    t = tanalysis.rpss_records(runs, root, log=tlog.append)
    _same_table(t, j)
    assert tlog == jlog
    for conds in (dict(period="Full Period", arch="ELR"),
                  dict(period=("Common Period", "MME", "2MME")),
                  dict(lead="week 3-4", model={"MME", "2MME"})):
        _same_table(t.subset(**conds), j.subset(**conds))
    _same_table(tanalysis.concat_tables([t, t.subset(arch="unet")]),
                janalysis.concat_tables([j, j.subset(arch="unet")]))
    _same_table(tanalysis.concat_tables([]), janalysis.concat_tables([]))


def test_default_matrix_matches_cell5():
    assert tnb.default_barplot_runs() == jnb.default_barplot_runs()
    assert tnb.default_barplot_runs(obs="CPC", weeks={"wk1": "week 1"}) \
        == jnb.default_barplot_runs(obs="CPC", weeks={"wk1": "week 1"})
    assert tnb.DEFAULT_BARPLOT_RUNS == jnb.DEFAULT_BARPLOT_RUNS
    for name in ("ACC_LEADS", "ACC_LEADS_ECMWF", "BARPLOT_PERIODS",
                 "BARPLOT_MODELS", "BARPLOT_WEEKS", "LEAD_ORDER",
                 "MME_HUE_ORDER", "REGION_YLIMS"):
        assert getattr(tnb, name) == getattr(jnb, name), name


def _regions(tmp_path):
    shp = str(tmp_path / "regions.shp")
    write_shp(shp, [[[(-0.5, -0.5), (2.5, -0.5), (2.5, 5.5), (-0.5, 5.5),
                      (-0.5, -0.5)]],
                    [[(2.5, -0.5), (5.5, -0.5), (5.5, 5.5), (2.5, 5.5),
                      (2.5, -0.5)]]])
    write_dbf(str(tmp_path / "regions.dbf"), ["West", "East"])
    return shp


@pytest.mark.parametrize("regions", [False, True])
def test_barplot_full_matrix_figures(tmp_path, regions):
    """After a fake full suite, run_barplot emits JAX's figure set and
    reports JAX's skipped rows; with a shapefile, the region facets too
    (Bar_plot.ipynb cells 7/9/10/16/19)."""
    shp = _regions(tmp_path) if regions else None
    out = {}
    for name, nb in (("jax", jnb), ("port", tnb)):
        root = str(tmp_path / name)
        _fake_suite_tree(root)
        out[name] = (root, nb.run_barplot(out_root=root, shapefile=shp,
                                          log=quiet))
    (jroot, j), (troot, t) = out["jax"], out["port"]
    assert _rel(t, troot) == _rel(j, jroot)
    assert len(t["skipped"]) == (4 * 5 - 2) * 3 * 2 - 18
    figs = [p for k, p in t.items() if k != "skipped"]
    assert all(os.path.getsize(p) > 1000 for p in figs)
    want = {"by_model", "by_lead", "full_period_ELR", "full_period_unet",
            "mme_ELR", "mme_unet", "mme_compare"}
    if regions:
        # the tree's one wk2 run (GEFS, Common Period) adds its MME facet
        want |= {"by_region", "region_full_week_3-4", "region_mme_week_3-4",
                 "region_mme_week_2"}
    assert set(t) - {"skipped"} == want


def test_mme_legacy_name_alias(tmp_path):
    root = str(tmp_path)
    _write_rpss(root, "MME", "GEFS_IITM_ECMWF", "wk3-4", value=0.25)
    args = (root, "MME/", "MME", "IMD", "unet", "wk3-4")
    assert tanalysis.rpss_path(*args[:4], "unet", "wk3-4") == \
        janalysis.rpss_path(*args[:4], "unet", "wk3-4")
    assert np.allclose(tanalysis.load_rpss(*args).values, 0.25)
    _write_rpss(root, "MME", "MME", "wk3-4", value=0.5)   # canonical wins
    np.testing.assert_array_equal(tanalysis.load_rpss(*args).values,
                                  janalysis.load_rpss(*args).values)
    assert np.allclose(tanalysis.load_rpss(*args).values, 0.5)
    np.testing.assert_array_equal(
        tanalysis.elr_nan_mask(root, "MME/", "MME", "IMD", "wk3-4"),
        janalysis.elr_nan_mask(root, "MME/", "MME", "IMD", "wk3-4"))


def test_region_rpss_table_end_to_end(tmp_path):
    """region_rpss rasterizes the shapefile on each run's grid and names
    the regions from the .dbf (Bar_plot.ipynb cells 12-19)."""
    from s2s_ismr_tpu.field import Field
    from s2s_ismr_tpu.io import write_netcdf
    lats = lons = np.arange(0.0, 8.0)
    rpss = np.zeros((2, 8, 8), np.float32)
    rpss[:, :4, :4] = 0.4
    fld = Field(rpss, ("bootstrap", "Y", "X"), {"Y": lats, "X": lons},
                "rpss")
    run = {"period_dir": "Common Period", "model": "ECMWF", "obs": "IMD",
           "arch": "unet", "week": "wk3-4"}
    outdir = os.path.join(str(tmp_path), "outputs", "Common Period",
                          "ECMWF_IMD")
    for arch in ("unet", "ELR"):
        write_netcdf(fld, os.path.join(outdir, f"{arch}_rpss_test_wk3-4.nc"))
    shp = str(tmp_path / "regions.shp")
    write_shp(shp, [[[(-0.5, -0.5), (3.5, -0.5), (3.5, 3.5), (-0.5, 3.5),
                      (-0.5, -0.5)]],
                    [[(3.5, 3.5), (7.5, 3.5), (7.5, 7.5), (3.5, 7.5),
                      (3.5, 3.5)]]])
    write_dbf(str(tmp_path / "regions.dbf"), ["SW", "NE"])
    for names in (None, ("a", "b")):
        t = tanalysis.region_rpss(str(tmp_path), shp, [run],
                                  region_names=names)
        _same_table(t, janalysis.region_rpss(str(tmp_path), shp, [run],
                                             region_names=names))
    assert set(t.region) == {"a", "b"} and len(t.values) == 32


# ------------------------------------------------------------ accs driver
def _same_accs(tpaths, jpaths, troot, jroot):
    assert _rel(tpaths, troot) == _rel(jpaths, jroot)
    for model, d in tpaths.items():
        for key, p in d.items():
            if key.startswith("fig_"):
                assert os.path.getsize(p) > 1000, p
                continue
            a, b = read_netcdf(p), read_netcdf(jpaths[model][key])
            assert a.dims == b.dims == ("metric", "Y", "X")
            for c in ("Y", "X"):
                np.testing.assert_array_equal(a.coords[c], b.coords[c])
            np.testing.assert_array_equal(np.isnan(a.values),
                                          np.isnan(b.values))
            np.testing.assert_allclose(a.values, b.values, atol=ATOL,
                                       equal_nan=True)


def test_accs_and_barplot_drivers(tmp_path):
    """run_accs with figures: JAX's paths (netcdf per week, CC and ACC maps
    per week, the two climatology maps for wk3-4), netcdfs within 1e-5;
    then run_barplot on a minimal pair."""
    kw = dict(models=("ECMWF",), years=(2003, 2007), step=4.0,
              make_plots=True, log=quiet)
    troot, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    t = tnb.run_accs(out_root=troot, device="cpu", **kw)
    j = jnb.run_accs(out_root=jroot, **kw)
    weeks = {"wk1", "wk2", "wk3", "wk4", "wk3-4"}
    assert set(t["ECMWF"]) == (weeks | {f"fig_cc_{w}" for w in weeks}
                               | {f"fig_acc_{w}" for w in weeks}
                               | {"fig_climo_wk3-4", "fig_climo_obs_wk3-4"})
    _same_accs(t, j, troot, jroot)
    _write_rpss(troot, "Common Period", "ECMWF", "wk3-4", n=4)
    paths = tnb.run_barplot(out_root=troot, log=quiet)
    assert os.path.exists(paths["by_model"])


def test_accs_gefs_iridl_external_climatology(tmp_path, monkeypatch):
    """The accs `iridl` branch: each lead window through the gateway, and
    for GEFS the dc0018 lead-dependent climatology read once from the
    gateway's cache and matched per sample (ACCs.ipynb cells 28/38), in
    both packages; netcdfs within 1e-5, and the ACC is the one against
    the external climatology, not the sample one."""
    from scipy.io import netcdf_file
    monkeypatch.chdir(tmp_path)
    calls = {"jax": [], "port": []}
    years = (2003, 2006)

    def fake_get_data(tag):
        def get_data(**kw):
            calls[tag].append(kw)
            b = tsyn.synthetic_hindcast(model=kw["model"], years=years,
                                        step=4.0, lead=kw["custom_lead"],
                                        seed=3)
            return b.x_field(), b.y_field()
        return get_data

    def cache_only(real):
        def fetch(url, fname, download=True, cookies="cookies.txt",
                  log=print):
            return real(url, fname, False, cookies, log)
        return fetch

    for tag, gw in (("jax", jgateway), ("port", tgateway)):
        monkeypatch.setattr(gw, "get_data", fake_get_data(tag))
        monkeypatch.setattr(gw, "fetch", cache_only(gw.fetch))
    # the dc0018 file: pr(S, L, Y, X) on the bundles' grid, daily S
    b = tsyn.synthetic_hindcast(model="GEFS", years=years, step=4.0)
    s_days = np.arange(0.0, 365.0, 7.0)
    leads = np.arange(0.5, 35.0, 1.0)
    rng = np.random.default_rng(0)
    path = os.path.join("download", "gefs_climo_67_98_7_38.nc")
    os.makedirs("download")
    with netcdf_file(path, "w") as f:
        for d, v in (("S", s_days), ("L", leads), ("Y", b.lats),
                     ("X", b.lons)):
            f.createDimension(d, len(v))
            cv = f.createVariable(d, np.float64, (d,))
            cv[:] = v
            if d == "S":
                cv.units = "days since 2000-01-01"
        pr = f.createVariable("pr", np.float32, ("S", "L", "Y", "X"))
        pr[:] = rng.gamma(2, 2, (len(s_days), len(leads)) + b.shape_yx)
    kw = dict(models=("GEFS",), source="iridl", years=years, log=quiet)
    t = tnb.run_accs(out_root="port", device="cpu", **kw)
    j = jnb.run_accs(out_root="jax", **kw)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 5
    assert [c["custom_lead"] for c in calls["port"]] == \
        list(tnb.ACC_LEADS.values())
    _same_accs(t, j, "port", "jax")
    sample = tanalysis.compute_skill_maps(
        tsyn.synthetic_hindcast(model="GEFS", years=years, step=4.0,
                                lead=tnb.ACC_LEADS["wk3-4"], seed=3),
        device="cpu")
    acc = read_netcdf(t["GEFS"]["wk3-4"]).values[1]
    land = np.isfinite(sample.acc)
    assert not np.allclose(acc[land], sample.acc[land], atol=1e-3)


# ----------------------------------------------------------- reliability
def test_reliability_scores_and_diagrams_match_jax(tmp_path, rng):
    """The figure annotations (BSS, REL, RES) by the port's metrics equal
    JAX's; the float64 curve binning is a plain copy; both diagrams draw."""
    p = rng.random((40, 4, 4)).astype(np.float32)
    t = (rng.random((40, 4, 4)) < p).astype(np.float32)
    t[3] = np.nan
    np.testing.assert_allclose(trel._scores(p, t, device="cpu"),
                               jrel._scores(p, t), atol=1e-6)
    for a, b in zip(trel._bin_stats(p, t), jrel._bin_stats(p, t)):
        np.testing.assert_array_equal(a, b)
    d = trel.reliability_diagram(p, t, str(tmp_path / "one.png"),
                                 title="x", device="cpu")
    c = trel.reliability_compare(p, t, p[::-1], t, str(tmp_path / "c.pdf"),
                                 device="cpu")
    assert os.path.getsize(d) > 1000 and os.path.getsize(c) > 1000

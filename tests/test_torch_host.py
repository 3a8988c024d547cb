"""The port's own numpy host layer against the JAX package's.

The port keeps copies of `timeutils`, `grid`, `field`, `io/`, `data/`,
`train/splits.py`, `profiling.StageTimer`, the realtime figures'
`viz/regions.py` and `viz/maps.default_shapes_dir`, and the numpy parts of
the reporting slice (`analysis.RpssTable` / `rpss_records`,
`pipelines.notebooks.default_barplot_runs`, `viz/maps`' levels,
`viz/reliability._bin_stats`) so that it imports nothing of
`s2s_ismr_tpu`. These tests hold each copy to its original on
the CPU: synthetic bundles and fold masks bit-equal for the same seed, week
tables equal, netcdf files interchangeable both ways, IRIDL URLs equal,
shapefiles read and rasterized bit-equal (tests/test_regions.py's writers).
"""

import os

import numpy as np
import pytest

from s2s_ismr_tpu import grid as jgrid
from s2s_ismr_tpu import profiling as jprofiling
from s2s_ismr_tpu import timeutils as jtime
from s2s_ismr_tpu.data import gateway as jgateway
from s2s_ismr_tpu.data import iridl as jiridl
from s2s_ismr_tpu.data import synthetic as jsyn
from s2s_ismr_tpu.field import Field as JField
from s2s_ismr_tpu.io import read_netcdf as jread
from s2s_ismr_tpu.io import write_netcdf as jwrite
from s2s_ismr_tpu.train import splits as jsplits
from s2s_ismr_tpu.viz import maps as jmaps
from s2s_ismr_tpu.viz import regions as jregions
from s2s_ismr_tpu_torch import grid as tgrid
from s2s_ismr_tpu_torch import profiling as tprofiling
from s2s_ismr_tpu_torch import timeutils as ttime
from s2s_ismr_tpu_torch.data import gateway as tgateway
from s2s_ismr_tpu_torch.data import iridl as tiridl
from s2s_ismr_tpu_torch.data import synthetic as tsyn
from s2s_ismr_tpu_torch.field import Field as TField
from s2s_ismr_tpu_torch.io import read_netcdf as tread
from s2s_ismr_tpu_torch.io import write_netcdf as twrite
from s2s_ismr_tpu_torch.train import splits as tsplits
from s2s_ismr_tpu_torch.viz import maps as tmaps
from s2s_ismr_tpu_torch.viz import regions as tregions
from test_regions import write_dbf, write_shp

_BUNDLE_FIELDS = ("x", "y", "t", "lats", "lons", "name", "weeks", "years")


def _same_bundle(a, b):
    for f in _BUNDLE_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f
        # bit-equal, NaN where NaN
        np.testing.assert_array_equal(va, vb, err_msg=f, strict=True)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(model="IITM", years=(2003, 2006), seed=7, step=2.0, signal=0.8),
    dict(model="GEFS", obs="CPC", years=(2001, 2003), season="Jun-Aug",
         seed=3, step=4.0, ocean_frac=0.3, lead=(9, 15)),
    dict(years=(2003, 2005), grid_shape=(23, 24), seed=11)])
def test_synthetic_hindcast_bit_equal(kw):
    _same_bundle(tsyn.synthetic_hindcast(**kw), jsyn.synthetic_hindcast(**kw))


def test_synthetic_ensemble_bit_equal():
    kw = dict(models=("IITM", "ECMWF"), seed=4, years=(2003, 2006),
              step=2.0, lead=(16, 29))
    txs, tys = tsyn.synthetic_ensemble(**kw)
    jxs, jys = jsyn.synthetic_ensemble(**kw)
    assert list(txs) == list(jxs) == ["IITM", "ECMWF"]
    for m in txs:
        _same_bundle(txs[m], jxs[m])
        np.testing.assert_array_equal(tys[m], jys[m], strict=True)


def test_bundle_transforms_bit_equal():
    kw = dict(years=(2003, 2005), grid_shape=(23, 24), seed=2)
    t, j = tsyn.synthetic_hindcast(**kw), jsyn.synthetic_hindcast(**kw)
    _same_bundle(t.pad_to_grid(3, 40.5), j.pad_to_grid(3, 40.5))
    _same_bundle(t.standardize(), j.standardize())
    _same_bundle(t.fillna(0.0), j.fillna(0.0))
    _same_bundle(t.stacked(), j.stacked())
    for mode in ("mean", "multi_predictor"):
        np.testing.assert_array_equal(t.predictor_images(mode),
                                      j.predictor_images(mode), strict=True)
    np.testing.assert_array_equal(t.valid_pixels(), j.valid_pixels())
    tg, jg = t.grid(3, 40.5), j.grid(3, 40.5)
    assert (tg.pad_y, tg.pad_x, tg.pad_lat_value) == \
        (jg.pad_y, jg.pad_x, jg.pad_lat_value)
    np.testing.assert_array_equal(tg.padded_lats(), jg.padded_lats())
    np.testing.assert_array_equal(tg.padded_lons(), jg.padded_lons())
    np.testing.assert_array_equal(tg.valid_mask(), jg.valid_mask())
    for a, b in ((t.x_field(), j.x_field()), (t.y_field(), j.y_field())):
        assert a.dims == b.dims and a.name == b.name
        np.testing.assert_array_equal(a.values, b.values, strict=True)
        assert list(a.coords) == list(b.coords)
        for d in a.coords:
            np.testing.assert_array_equal(a.coords[d], b.coords[d])


@pytest.mark.parametrize("n_boot", [1, 3, 10])
def test_fold_masks_equal(n_boot):
    years = jsyn.synthetic_hindcast(years=(2003, 2018), step=4.0).years
    for fn in ("bootstrap_masks", "bootstrap_masks_elr"):
        t = getattr(tsplits, fn)(years, n_bootstraps=n_boot)
        j = getattr(jsplits, fn)(years, n_bootstraps=n_boot)
        for f in ("train", "val", "test", "train_years", "val_years",
                  "test_years"):
            a, b = getattr(t, f), getattr(j, f)
            if a is None or b is None:
                assert a is b, (fn, f)
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f"{fn}.{f}")


def test_timeutils_week_tables_equal():
    assert ttime.N_ISO_WEEKS == jtime.N_ISO_WEEKS == 53
    for window in range(4):
        np.testing.assert_array_equal(ttime.week_window_matrix(window),
                                      jtime.week_window_matrix(window))
        for w in (1, 2, 27, 52, 53):
            assert ttime.week_window(w, window) == jtime.week_window(w, window)
    for season in ("May-Sep", "Jun-Aug", "Jan-Dec"):
        assert ttime.season_months(season) == jtime.season_months(season)
        t = ttime.weekly_mondays((2003, 2005), season)
        np.testing.assert_array_equal(t, jtime.weekly_mondays((2003, 2005),
                                                              season))
        for fn in ("iso_week", "year", "month", "day_of_year"):
            np.testing.assert_array_equal(getattr(ttime, fn)(t),
                                          getattr(jtime, fn)(t), strict=True)
    assert ttime.MONTHS == jtime.MONTHS


def test_grid_equal():
    d = tgrid.Domain(67, 98, 7, 38)
    assert d.as_tuple() == jgrid.Domain(67, 98, 7, 38).as_tuple()
    jd = jgrid.Domain(*d.as_tuple())
    for step in (1.0, 2.0, 1.5):
        for a, b in zip(tgrid.regular_grid(d, step),
                        jgrid.regular_grid(jd, step)):
            np.testing.assert_array_equal(a, b, strict=True)
    for a, b in zip(tgrid.fixed_grid(d, 23, 24), jgrid.fixed_grid(jd, 23, 24)):
        np.testing.assert_array_equal(a, b, strict=True)
    for ny, nx, nb in ((32, 32, 3), (24, 24, 3), (16, 16, 4)):
        assert tgrid.divisible_by(ny, nb) == jgrid.divisible_by(ny, nb)
    with pytest.raises(ValueError):
        tgrid.check_divisible(23, 24, 3)
    with pytest.raises(ValueError):
        jgrid.check_divisible(23, 24, 3)


def _field(cls, rng):
    t = ttime.weekly_mondays((2003, 2004), "May-Sep")
    v = rng.normal(size=(len(t), 3, 4)).astype(np.float32)
    v[1, 2, 3] = np.nan
    return cls(v, ("T", "Y", "X"), {"T": t, "Y": np.arange(3.0) + 7.5,
                                    "X": np.arange(4.0) + 67.5}, "rpss")


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_netcdf_interchange(tmp_path, rng, direction):
    """A file written by one package is read by the other, data equal."""
    if direction == "port_to_jax":
        fld, write, read, cls = _field(TField, rng), twrite, jread, JField
    else:
        fld, write, read, cls = _field(JField, rng), jwrite, tread, TField
    path = str(tmp_path / "f.nc")
    write(fld, path, var_name="rpss")
    back = read(path, var_name="rpss")
    assert isinstance(back, cls)
    assert back.dims == fld.dims
    # netcdf3 stores big-endian: the same float32 values, another byte order
    assert back.values.dtype.newbyteorder("=") == fld.values.dtype
    np.testing.assert_array_equal(back.values, fld.values)
    for d in fld.coords:
        np.testing.assert_array_equal(back.coords[d], fld.coords[d])
    # both readers decode the same bytes the same way
    other = (jread if read is tread else tread)(path, var_name="rpss")
    np.testing.assert_array_equal(other.values, back.values, strict=True)
    # the gateway's IRIDL decoder, too
    a = tgateway.open_netcdf_da(path, ("rpss",))
    b = jgateway.open_netcdf_da(path, ("rpss",))
    assert a.dims == b.dims
    np.testing.assert_array_equal(a.values, b.values, strict=True)
    np.testing.assert_array_equal(a.coords["T"], b.coords["T"])


def test_gateway_to_bundle_and_urls_equal():
    b = tsyn.synthetic_hindcast(years=(2003, 2004), step=4.0)
    _same_bundle(tgateway.to_bundle(b.x_field(), b.y_field(), "m"),
                 jgateway.to_bundle(b.x_field(), b.y_field(), "m"))
    assert tgateway.LEAD_MAPPING == jgateway.LEAD_MAPPING
    dom = (67, 98, 7, 38)
    for model in ("ECMWF_perturbed", "GEFS", "IITM1"):
        args = (model, (2003, 2018), (16, 29), "May-Sep", dom)
        assert tiridl.hindcast_url(*args) == jiridl.hindcast_url(*args)
        assert tiridl.hindcast_url(*args, regrid=1.0) == \
            jiridl.hindcast_url(*args, regrid=1.0)
    for model in ("ECMWF_control", "GEFS"):
        args = (model, "IMD", (2003, 2018), (16, 29), "May-Sep", dom)
        assert tiridl.predictand_url(*args) == jiridl.predictand_url(*args)


def test_stage_timer_summary_schema():
    t, j = tprofiling.StageTimer(), jprofiling.StageTimer()
    for timer in (t, j):
        with timer.stage("nn"):
            pass
        timer.count("train_steps", 4)
        timer.count("train_steps", 2)
    st, sj = t.summary(), j.summary()
    assert set(st) == set(sj) and st["counters"] == sj["counters"]
    assert set(st["stages_s"]) == set(sj["stages_s"]) == {"nn"}
    for mod in (tprofiling, jprofiling):      # trace(None) is a no-op
        with mod.trace(None) as rec:
            assert rec is None


def test_shapefile_reader_and_masks_bit_equal(tmp_path):
    """read_shapefile, region_masks and the .dbf names of the port's
    viz/regions.py against the JAX module's on a polygon file with a hole
    and a polyline-free multi-record layout."""
    shp = str(tmp_path / "r.shp")
    square = [(10.5, 10.5), (20.5, 10.5), (20.5, 20.5), (10.5, 20.5)]
    hole = [(13.5, 13.5), (16.5, 13.5), (16.5, 16.5), (13.5, 16.5)]
    tri = [(30.5, 5.5), (45.5, 5.5), (38.5, 25.5)]
    write_shp(shp, [[square, hole], [tri]])
    write_dbf(str(tmp_path / "r.dbf"), ["South", "North West"])
    a, b = tregions.read_shapefile(shp), jregions.read_shapefile(shp)
    assert len(a) == len(b) == 2
    for s, t in zip(a, b):
        assert s.shape_type == t.shape_type and s.bbox == t.bbox
        for r, q in zip(s.rings, t.rings, strict=True):
            np.testing.assert_array_equal(r, q, strict=True)
    lats, lons = np.arange(0.0, 32.0), np.arange(0.0, 50.0)
    np.testing.assert_array_equal(tregions.region_masks(shp, lats, lons),
                                  jregions.region_masks(shp, lats, lons),
                                  strict=True)
    assert tregions.region_names_from_dbf(shp) == \
        jregions.region_names_from_dbf(shp) == ["South", "North West"]


def test_default_shapes_dir_as_jax(tmp_path, monkeypatch):
    """The environment override and a shapes/ dir beside the outputs
    resolve as in JAX, and the boundary rings read from it are equal."""
    monkeypatch.delenv("S2S_SHAPES_DIR", raising=False)
    shapes = tmp_path / "out" / "shapes"
    shapes.mkdir(parents=True)
    write_shp(str(shapes / "indian_borders.shp"),
              [[[(1.0, 1.0), (5.0, 1.0), (5.0, 5.0)]]])
    root = str(tmp_path / "out")
    assert tmaps.default_shapes_dir(root) == jmaps.default_shapes_dir(root) \
        == str(shapes)
    env = tmp_path / "env"
    env.mkdir()
    monkeypatch.setenv("S2S_SHAPES_DIR", str(env))
    assert tmaps.default_shapes_dir(root) == jmaps.default_shapes_dir(root) \
        == str(env)
    for r, q in zip(tmaps._boundary_segments(str(shapes)),
                    jmaps._boundary_segments(str(shapes)), strict=True):
        np.testing.assert_array_equal(r, q, strict=True)
    monkeypatch.delenv("S2S_SHAPES_DIR")
    assert tmaps.default_shapes_dir(str(tmp_path / "none")) is None


@pytest.mark.parametrize("n", [0, 1, 7, 500])
def test_reliability_curve_binning_bit_equal(rng, n):
    """viz/reliability._bin_stats, the float64 curve binning with its real
    edge scaling, including NaN pairs and sparse bins."""
    from s2s_ismr_tpu.viz import reliability as jrel
    from s2s_ismr_tpu_torch.viz import reliability as trel
    p = rng.random(n)
    t = (rng.random(n) < p).astype(np.float32)
    p[::5] = np.nan
    p[1::7] = np.round(p[1::7], 1)            # values at the bin edges
    for a, b in zip(trel._bin_stats(p, t), jrel._bin_stats(p, t),
                    strict=True):
        np.testing.assert_array_equal(a, b, strict=True)


def test_reporting_tables_and_matrix_bit_equal(tmp_path):
    """RpssTable from rpss_records (regions included) and its subset,
    the Bar_plot.ipynb run matrix, and the CC/ACC levels equal the JAX
    package's."""
    from s2s_ismr_tpu import analysis as janalysis
    from s2s_ismr_tpu.pipelines import notebooks as jnb
    from s2s_ismr_tpu_torch import analysis as tanalysis
    from s2s_ismr_tpu_torch.pipelines import notebooks as tnb
    from test_barplot_matrix import _fake_suite_tree
    root = str(tmp_path)
    _fake_suite_tree(root)
    runs = [r for r in tnb.default_barplot_runs()
            if r["week"] == "wk3-4" and r["period"] != "2MME"]
    assert runs == [r for r in jnb.default_barplot_runs()
                    if r["week"] == "wk3-4" and r["period"] != "2MME"]
    masks = np.zeros((2, 6, 6), bool)
    masks[0, :3], masks[1, 3:] = True, True
    kw = dict(region_masks=masks, region_names=["S", "N"])
    present = [r for r in runs if os.path.exists(janalysis.rpss_path(
        root, r["period_dir"], r["model"], r["obs"], r["arch"], r["week"]))]
    t = tanalysis.rpss_records(present, root, **kw)
    j = janalysis.rpss_records(present, root, **kw)
    for sub in ({}, {"region": "N", "model": ("ECMWF", "MME")}):
        a, b = t.subset(**sub), j.subset(**sub)
        for f in ("values", "lead", "model", "arch", "region", "period"):
            np.testing.assert_array_equal(a._col(f), b._col(f), strict=True)
    assert tmaps.CC_LEVELS == jmaps.CC_LEVELS
    assert tmaps.ACC_LEVELS == jmaps.ACC_LEVELS

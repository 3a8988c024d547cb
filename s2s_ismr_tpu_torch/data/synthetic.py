"""Synthetic hindcast/observation generator — the fake IRIDL gateway.

The port's own copy of s2s_ismr_tpu/data/synthetic.py (numpy only), so
the port imports nothing of the JAX package; the same seed gives the same
arrays bit for bit.

The reference has no offline data source and no tests; every run hits the
IRI Data Library over curl (dataloader.py:140). For CI and development we
need statistically monsoon-like data with a controllable predictable
signal, an ocean NaN mask, and the exact coordinate conventions of the
real gateway (weekly init dates over a season window, ensemble dim M,
T = S + mean lead).
"""

from __future__ import annotations

import numpy as np

from .. import timeutils
from ..grid import Domain, fixed_grid, regular_grid
from .bundle import DataBundle

# ensemble sizes mirroring the real sources: GEFS ~11, IITM 6 sub-models x
# 4 members, ECMWF 10 perturbed + 1 control (dataloader.py:178-257)
ENSEMBLE_SIZES = {"ECMWF": 11, "GEFS": 11, "IITM": 24}


def _smooth2d(a, k=3):
    """Cheap separable box smoothing to induce spatial correlation.

    Accumulates k shifted views in place instead of materializing a
    k-way stack (the stack cost ~20 s of the 28 s IITM-full generation;
    for k <= 8 numpy's add.reduce over the stacked axis is the same
    sequential summation, so results are bit-identical)."""
    for axis in (-2, -1):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (k // 2, k // 2)
        ap = np.pad(a, pad, mode="edge")
        n = a.shape[axis]
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(0, n)
        acc = ap[tuple(sl)].copy()
        for i in range(1, k):
            sl[axis] = slice(i, i + n)
            acc += ap[tuple(sl)]
        a = acc / k
    return a


def _truth(years, season, domain, step, seed, ocean_frac, lead,
           grid_shape=None):
    """Shared 'observed' world: init dates, grid, truth anomalies, obs field."""
    rng = np.random.default_rng(seed)
    lats, lons = (fixed_grid(domain, *grid_shape) if grid_shape
                  else regular_grid(domain, step))
    ny, nx = len(lats), len(lons)
    s = timeutils.weekly_mondays(years, season)
    # T = S + mean lead (dataloader.py:214,277)
    t = s + np.timedelta64(int(round((lead[0] + lead[1]) / 2)), "D")
    nt = len(t)

    weeks = timeutils.iso_week(t).astype(float)
    seasonal = 3.0 + 2.5 * np.sin((weeks - 18) / 22 * np.pi)[:, None, None]
    topo = _smooth2d(rng.gamma(2.0, 1.0, size=(ny, nx)), 5)
    truth_anom = _smooth2d(rng.normal(0, 1, size=(nt, ny, nx)), 5)
    y = (seasonal * topo * np.exp(0.5 * truth_anom)).astype(np.float32)

    # static ocean mask on y only (IMD obs are land-only; predictors cover ocean)
    blob = _smooth2d(rng.normal(0, 1, size=(ny, nx)), 7)
    y[:, blob < np.quantile(blob, ocean_frac)] = np.nan
    return t, lats, lons, seasonal, topo, truth_anom, y


def _forecast(model, truth, n_members, seed, signal):
    t, lats, lons, seasonal, topo, truth_anom, _y = truth
    nt, ny, nx = truth_anom.shape
    m = n_members or ENSEMBLE_SIZES.get(model, 8)
    rng = np.random.default_rng(seed)
    fc_signal = signal * truth_anom + np.sqrt(1 - signal ** 2) * \
        _smooth2d(rng.normal(0, 1, size=(nt, ny, nx)), 5)
    member_noise = _smooth2d(rng.normal(0, 0.7, size=(m, nt, ny, nx)), 3)
    bias = 0.8 + 0.4 * rng.random()
    x = bias * seasonal * topo * np.exp(0.5 * (fc_signal[None] + member_noise))
    return np.transpose(x, (1, 0, 2, 3)).astype(np.float32)  # (T, M, Y, X)


def synthetic_hindcast(model="ECMWF", obs="IMD", years=(2003, 2018),
                       season="May-Sep", domain=Domain(67, 98, 7, 38),
                       step=1.0, n_members=None, seed=0, signal=0.6,
                       ocean_frac=0.15, lead=(16, 30), grid_shape=None):
    """Generate a DataBundle shaped exactly like gateway.get_data output.

    signal: correlation strength between the ensemble-mean forecast and the
    observed field (gives the U-Net something learnable).
    ocean_frac: fraction of pixels NaN-masked in y (IMD is land-only).
    grid_shape: (n_lat, n_lon) native-grid point counts (overrides step).
    """
    truth = _truth(years, season, domain, step, seed, ocean_frac, lead,
                   grid_shape)
    x = _forecast(model, truth, n_members, seed + 1000, signal)
    t, lats, lons = truth[0], truth[1], truth[2]
    return DataBundle(x=x, y=truth[6], t=t, lats=lats, lons=lons,
                      name=f"{model}_{obs}_synthetic")


def synthetic_ensemble(models=("GEFS", "IITM", "ECMWF"), seed=0, **kw):
    """Dict-of-models variant mirroring gateway.get_data_ensemble
    (dataloader.py:300-330): one shared truth/obs, per-model forecasts with
    independent noise and biases."""
    defaults = dict(years=(2003, 2018), season="May-Sep",
                    domain=Domain(67, 98, 7, 38), step=1.0, signal=0.6,
                    ocean_frac=0.15, lead=(16, 30), grid_shape=None)
    defaults.update(kw)
    truth = _truth(defaults["years"], defaults["season"], defaults["domain"],
                   defaults["step"], seed, defaults["ocean_frac"],
                   defaults["lead"], defaults["grid_shape"])
    t, lats, lons, y = truth[0], truth[1], truth[2], truth[6]
    xs, ys = {}, {}
    for i, model in enumerate(models):
        x = _forecast(model, truth, None, seed + 1000 + 17 * i, defaults["signal"])
        xs[model] = DataBundle(x=x, y=y, t=t, lats=lats, lons=lons,
                               name=f"{model}_synthetic")
        ys[model] = y
    return xs, ys

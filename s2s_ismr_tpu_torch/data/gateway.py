"""The host-side data gateway: fetch, cache, decode, pack.

The port's own copy of s2s_ismr_tpu/data/gateway.py (numpy, pandas and
scipy only), so the port imports nothing of the JAX package.

Mirrors the reference acquisition layer (dataloader.py:95-330) with the
same external contract — cookie-authenticated curl against IRIDL, a
download/{model}_{obs}/ cache, per-model ensemble assembly — but packs
straight into DataBundles (dense arrays + masks) instead of xarray.

Assembly semantics reproduced:
  * IITM = 6 sub-model fetches concatenated along the ensemble axis M
    (dataloader.py:178-215);
  * ECMWF = perturbed + control streams concatenated along M, the
    control member tagged M=11 (dataloader.py:217-257);
  * non-ECMWF sources re-stamp time as T = S + (lead_start+lead_end)/2
    days (dataloader.py:214,277);
  * x and y must agree on T exactly (assert, dataloader.py:295).
"""

from __future__ import annotations

import os
import re
import subprocess

import numpy as np

from .. import timeutils
from ..field import Field
from . import iridl
from .bundle import DataBundle

LEAD_MAPPING = {"wk1": (2, 8), "wk2": (9, 15), "wk3-4": (16, 29)}


# --------------------------------------------------------------- CF decoding
_UNITS_RE = re.compile(r"(\w+)\s+since\s+(.+)")


def decode_cf_time(values, units):
    import pandas as pd
    m = _UNITS_RE.match(units.strip())
    if not m:
        raise ValueError(f"unsupported time units {units!r}")
    step, origin = m.group(1).lower(), m.group(2).strip()
    origin = pd.Timestamp(origin.split(" ")[0])
    vals = np.asarray(values, float)
    if step in ("day", "days"):
        delta = vals * 86400e9
    elif step in ("hour", "hours"):
        delta = vals * 3600e9
    elif step in ("week", "weeks"):
        delta = vals * 7 * 86400e9
    elif step in ("month", "months"):
        # IRIDL monthly grids use 30-day-ish pseudo-months; approximate
        delta = vals * 30.4375 * 86400e9
    else:
        raise ValueError(f"unsupported time step {step!r}")
    return (np.datetime64(origin, "ns")
            + delta.astype("timedelta64[ns]"))


def open_netcdf_da(path, var_names=("prcp", "temp", "pr", "aprod")):
    """Decode one IRIDL download into a Field with datetime T/S coords."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        name = next((v for v in var_names if v in f.variables), None)
        if name is None:
            cands = [k for k in f.variables if k not in f.dimensions]
            if not cands:
                raise ValueError(f"{path}: no data variable")
            name = cands[0]
        var = f.variables[name]
        vals = np.array(var[:], np.float32).copy()
        miss = getattr(var, "missing_value", None)
        if miss is not None:
            vals = np.where(vals == np.float32(miss), np.nan, vals)
        dims = tuple(var.dimensions)
        coords = {}
        for d in dims:
            if d not in f.variables:
                continue
            cv = f.variables[d]
            units = getattr(cv, "units", b"")
            units = units.decode() if isinstance(units, bytes) else units
            raw = np.array(cv[:]).copy()
            if "since" in units:
                coords[d] = decode_cf_time(raw, units)
            else:
                coords[d] = raw.astype(float)
        return Field(vals, dims, coords, name)


# ------------------------------------------------------------------ fetching
# per-path in-process locks: the suite's compile-ahead thread prefetches
# the RUNNING config's bundles concurrently with the foreground load, so
# the same cache file can be requested twice at once — the lock makes the
# second requester wait and reuse the first download instead of racing it
import threading as _threading

_fetch_locks: dict = {}
_fetched_this_process: set = set()
_fetch_locks_guard = _threading.Lock()


def _path_lock(fname):
    with _fetch_locks_guard:
        return _fetch_locks.setdefault(os.path.abspath(fname),
                                       _threading.Lock())


def fetch(url, fname, download=True, cookies="cookies.txt", log=print):
    os.makedirs(os.path.dirname(fname) or ".", exist_ok=True)
    with _path_lock(fname):
        # download=True refreshes stale caches ACROSS runs (operational
        # obs grow weekly and the cache names carry no revision), but at
        # most once per process — the second same-file requester (e.g.
        # the prefetch thread racing the foreground load) reuses it
        fresh = os.path.abspath(fname) in _fetched_this_process
        if download and not fresh:
            log(f"Downloading: {url.replace('data.nc', '')}")
            # curl to a temp path + atomic rename: a reader (or a kill)
            # must never see a partially-written cache file
            tmp = fname + ".part"
            rc = subprocess.call(["curl", "-b", cookies, "-k", url,
                                  "-o", tmp])
            if rc != 0 or not os.path.exists(tmp):
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(f"curl failed (rc={rc}) for {url}")
            os.replace(tmp, fname)
            _fetched_this_process.add(os.path.abspath(fname))
        if not os.path.exists(fname):
            raise FileNotFoundError(
                f"{fname} not cached; run with download=True first")
    return fname


def _cache_path(cache_dir, model, obs, name, years):
    group = "IITM" if "IITM" in model else ("ECMWF" if "ECMWF" in model
                                            else model)
    return os.path.join(cache_dir, f"{group}_{obs}",
                        f"{name}_{years[0]}-{years[1]}.nc")


# ------------------------------------------------------------- public API
def get_data(years, download, week, model, obs, domain, season,
             regrid=None, custom_lead=None, cache_dir="download",
             cookies="cookies.txt", log=print):
    """Hindcast x (T,M,Y,X) + aligned obs y (T,Y,X) as Fields."""
    lead = custom_lead or LEAD_MAPPING[week]

    def fetch_one(source_key, name, url_fn):
        url = url_fn(source_key)
        fname = _cache_path(cache_dir, source_key, obs, name, years)
        fetch(url, fname, download, cookies, log)
        return open_netcdf_da(fname)

    def hc_url(key):
        return iridl.hindcast_url(key, years, lead, season, domain, regrid)

    def pd_url(key):
        return iridl.predictand_url(key, obs, years, lead, season, domain,
                                    regrid)

    if model == "IITM":
        members = [fetch_one(k, f"{k}_{week}", hc_url)
                   for k in iridl.IITM_MEMBERS]
        y = fetch_one(iridl.IITM_MEMBERS[0], f"IITM_{obs}_{week}", pd_url)
        x = _concat_members(members)
        x = _stamp_midlead_time(x, lead)
    elif model == "ECMWF":
        streams = []
        for k in iridl.ECMWF_STREAMS:
            da = fetch_one(k, f"{k}_{week}", hc_url)
            if "M" not in da.dims:   # control: single member tagged M=11
                da = Field(da.values[:, None], (da.dims[0], "M") + da.dims[1:],
                           {**da.coords, "M": np.array([11.0])}, da.name)
            streams.append(da)
        y = fetch_one(iridl.ECMWF_STREAMS[0], f"ECMWF_{obs}_{week}", pd_url)
        x = _concat_members(streams)
    else:
        x = fetch_one(model, f"{model}_{week}", hc_url)
        y = fetch_one(model, f"{model}_{obs}_{week}", pd_url)
        x = _stamp_midlead_time(x, lead)

    tx = x.coords.get("T")
    ty = y.coords.get("T")
    if tx is None or ty is None or len(tx) != len(ty) or \
            not (timeutils.to_datetime64(tx) == timeutils.to_datetime64(ty)).all():
        raise AssertionError("Mismatch in time dimensions between x and y.")
    x = x.transpose("T", "M", "Y", "X")
    y = y.transpose("T", "Y", "X") if y.ndim == 3 else y
    return x, y


def _concat_members(fields):
    """Concatenate along M (create it if missing), aligned on first dims."""
    parts = []
    m_coords = []
    for f in fields:
        if "M" not in f.dims:
            f = Field(f.values[:, None], (f.dims[0], "M") + f.dims[1:],
                      {**f.coords, "M": np.array([0.0])}, f.name)
        order = (f.dims[0], "M") + tuple(d for d in f.dims
                                         if d not in (f.dims[0], "M"))
        f = f.transpose(*order)
        parts.append(f.values)
        m_coords.append(f.coords.get("M", np.arange(f.values.shape[1])))
    vals = np.concatenate(parts, axis=1)
    first = fields[0]
    lead_dim = first.dims[0]
    dims = (lead_dim, "M") + tuple(d for d in first.dims
                                   if d not in (lead_dim, "M"))
    coords = {k: v for k, v in first.coords.items() if k != "M"}
    coords["M"] = np.concatenate([np.asarray(c, float) for c in m_coords])
    return Field(vals, dims, coords, first.name)


def _stamp_midlead_time(x, lead):
    """T = S + mean(lead) days, then S becomes T (dataloader.py:214,277)."""
    if "T" in x.dims:
        return x
    s = timeutils.to_datetime64(x.coords["S"])
    t = s + np.timedelta64(int(round((lead[0] + lead[1]) / 2)), "D")
    dims = tuple("T" if d == "S" else d for d in x.dims)
    coords = {("T" if k == "S" else k): v for k, v in x.coords.items()}
    coords["T"] = t
    return Field(x.values, dims, coords, x.name)


def get_data_ensemble(years, download, week, models, obs, domain, season,
                      regrid=1, custom_leads=None, custom_seasons=None,
                      **kw):
    """Dict-of-models fetch (dataloader.py:300-330)."""
    xs, ys = {}, {}
    for model in models:
        lead = custom_leads.get(model) if custom_leads else None
        sea = custom_seasons.get(model) if custom_seasons else season
        x, y = get_data(years=years, download=download, week=week,
                        model=model, obs=obs, domain=domain, season=sea,
                        regrid=regrid, custom_lead=lead, **kw)
        xs[model], ys[model] = x, y
    return xs, ys


def download_forecast(model, obs, day, month, year, domain, week,
                      out_dir="", download=True, regrid=None,
                      custom_lead=None, cache_dir="download",
                      cookies="cookies.txt", log=print):
    """Realtime forecast fetch (dataloader.py:338-430).

    Cache naming DEVIATES from the reference's
    forecast_{day}_{month}_{year}.nc (dataloader.py:388): that name
    omits the URL key and lead window, so the reference's cache holds
    only the LAST IITM member fetched, and a wk2 run with download=False
    would silently be served a cached wk3-4 accumulation. Here the key
    and lead are part of the filename, making offline reuse safe."""
    lead = custom_lead or LEAD_MAPPING[week]

    def one(key):
        url = iridl.forecast_url(key, day, month, year, lead, domain, regrid)
        fname = os.path.join(
            cache_dir, out_dir, f"{model}_{obs}",
            f"forecast_{key}_{day}_{month}_{year}_ld{lead[0]}-{lead[1]}.nc")
        fetch(url, fname, download, cookies, log)
        return open_netcdf_da(fname)

    if model == "IITM":
        x = _concat_members([one(k) for k in iridl.IITM_MEMBERS])
    else:
        x = one(model)
    return _stamp_midlead_time(x, lead)


def get_obs(model, obs, domain, week, years, season, out_dir="",
            download=True, regrid=None, cache_dir="download",
            cookies="cookies.txt", log=print):
    """Realtime observations on the model grid, season/year filtered
    (dataloader.py:433-495)."""
    url = iridl.obs_url(model, obs, LEAD_MAPPING[week], domain, regrid)
    fname = os.path.join(cache_dir, out_dir, f"{model}_{obs}",
                         f"{obs}_{week}.nc")
    fetch(url, fname, download, cookies, log)
    y = open_netcdf_da(fname)
    t = timeutils.to_datetime64(y.coords["T"])
    months = timeutils.month(t)
    sm = timeutils.season_months(season)
    # the reference widens the season window by one month at the end
    # (dataloader.py:486-487: end_month+1 then range(...end+1))
    keep = np.isin(months, sm + [sm[-1] + 1])
    keep &= (timeutils.year(t) >= years[0]) & (timeutils.year(t) <= years[1])
    return y.isel(T=np.where(keep)[0])


def get_gefs_climatology(domain, lead, download=True, cache_dir="download",
                         cookies="cookies.txt", log=print):
    """Fetch the GEFS dc0018 lead-dependent climatology and average it
    over the lead-day window (ACCs.ipynb cell 28: open, L->days,
    sel(L=lead window).mean('L')). Returns (s_dates (S,) datetime64,
    clim (S, Y, X) float32)."""
    url = iridl.gefs_climatology_url(domain)
    dom = "_".join(str(v) for v in domain)
    fname = os.path.join(cache_dir, f"gefs_climo_{dom}.nc")
    fetch(url, fname, download, cookies, log)
    da = open_netcdf_da(fname, var_names=("pr",))
    s = timeutils.to_datetime64(da.coords["S"])
    lvals = np.asarray(da.coords["L"], np.float64)   # lead days
    keep = (lvals >= lead[0] - 0.01) & (lvals <= lead[1] + 0.99)
    axes = list(da.dims)
    li = axes.index("L")
    vals = np.take(np.asarray(da.values, np.float32),
                   np.where(keep)[0], axis=li).mean(axis=li)
    # remaining dims (S, Y, X) in file order
    return s, vals


def get_index_series(key, years=None, download=True, cache_dir="download",
                     cookies="cookies.txt", log=print) -> Field:
    """Fetch one climate-index series (RMM1/RMM2/NINO34) as a (T,) Field
    — the acquisition layer for the MJO/ENSO diagnostics of the missing
    Realtime_fcast_MME.ipynb (README.md:22). Cached under
    download/indices/ and honoring download=False like every other
    gateway fetch."""
    url = iridl.index_url(key, years)
    tag = f"_{years[0]}-{years[1]}" if years else ""
    fname = os.path.join(cache_dir, "indices", f"{key}{tag}.nc")
    fetch(url, fname, download, cookies, log)
    return open_netcdf_da(fname, var_names=(key, key.lower(), "anom",
                                            "amplitude", "index"))


def _index_at_dates(field: Field, dates, max_gap_days: float) -> np.ndarray:
    """Sample a (T,) index series at the given dates: nearest stamp
    within max_gap_days, NaN otherwise (a missing index must not
    fabricate a composite group)."""
    t = timeutils.to_datetime64(field.coords["T"])
    want = timeutils.to_datetime64(np.asarray(dates, "datetime64[ns]"))
    out = np.full(len(want), np.nan, np.float64)
    if len(t) == 0:
        return out
    vals = np.asarray(field.values, np.float64).reshape(len(t), -1)[:, 0]
    for i, w in enumerate(want):
        d = np.abs((t - w) / np.timedelta64(1, "D")).astype(float)
        j = int(np.argmin(d))
        if d[j] <= max_gap_days:
            out[i] = vals[j]
    return out


def get_rmm_index(dates, download=True, cache_dir="download",
                  cookies="cookies.txt", log=print,
                  max_gap_days=3.0) -> np.ndarray:
    """(N, 2) BOM RMM1/RMM2 at the given init dates (daily series;
    nearest stamp within max_gap_days, else NaN)."""
    cols = []
    for key in ("RMM1", "RMM2"):
        f = get_index_series(key, download=download, cache_dir=cache_dir,
                             cookies=cookies, log=log)
        cols.append(_index_at_dates(f, dates, max_gap_days))
    return np.stack(cols, axis=1)


def get_nino34(dates, download=True, cache_dir="download",
               cookies="cookies.txt", log=print,
               max_gap_days=45.0) -> np.ndarray:
    """(N,) Nino3.4 SST anomalies at the given dates (monthly series;
    a date maps to its month's stamp — nearest within max_gap_days)."""
    f = get_index_series("NINO34", download=download, cache_dir=cache_dir,
                         cookies=cookies, log=log)
    return _index_at_dates(f, dates, max_gap_days)


def external_clim_for_times(t, lead, s_dates, clim):
    """Build a per-sample (T, Y, X) climatology by matching each sample's
    start date S = T - mean(lead) to the climatology's S month/day
    (ACCs.ipynb cell 38). Unmatched samples get the nearest
    day-of-year entry."""
    t = timeutils.to_datetime64(t)
    mid = (lead[0] + lead[1]) / 2.0
    s_est = t - np.timedelta64(1, "h") * int(round(mid * 24))
    doy_clim = timeutils.day_of_year(s_dates)
    doy_t = timeutils.day_of_year(s_est)
    # nearest day-of-year with wraparound
    d = np.abs(doy_t[:, None] - doy_clim[None, :])
    d = np.minimum(d, 366 - d)
    idx = np.argmin(d, axis=1)
    return clim[idx]


def to_bundle(x: Field, y: Field, name="") -> DataBundle:
    return DataBundle(x=x.values, y=y.values, t=x.coords["T"],
                      lats=np.asarray(x.coords.get("Y")),
                      lons=np.asarray(x.coords.get("X")), name=name)

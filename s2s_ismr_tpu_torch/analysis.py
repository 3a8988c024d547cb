"""Skill analysis: CC/ACC maps and RPSS aggregation, the programmatic
equivalents of the reference's ACCs.ipynb and Bar_plot.ipynb (port of
s2s_ismr_tpu/analysis.py).

ACCs.ipynb (40 cells): per model and lead week, ensemble-mean climatology
maps, CC = corr(x, y) over T, ACC = corr of per-ISO-week anomalies, with
the GEFS variant using an external lead-dependent climatology (dc0018)
instead of the sample mean (cell 38). CC and ACC run as torch ops on the
chosen device (`compute_skill_maps(device=None)`: the card).

Bar_plot.ipynb (21 cells): loads outputs/**/{ELR,unet}_rpss_test_*.nc,
builds NaN masks from the ELR maps, boxplots pixel-wise RPSS by
lead/model/architecture, and aggregates per homogeneous climate region by
rasterizing the met-subdivision shapefile. That part is numpy on the host;
`rpss_boxplot` imports matplotlib, pandas and seaborn inside the call.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import device as devices
from .data.bundle import DataBundle
from .field import Field
from .io import read_netcdf
from .ops import metrics


# ------------------------------------------------------------- ACC/CC maps
@dataclass
class SkillMaps:
    cc: np.ndarray                # (Y, X)
    acc: np.ndarray               # (Y, X)
    climatology: np.ndarray       # (Y, X) obs time-mean (climo_obs maps)
    climatology_fcst: np.ndarray  # (Y, X) fcst ens+time mean, obs-masked
    lats: np.ndarray
    lons: np.ndarray


def compute_skill_maps(bundle: DataBundle, external_clim=None,
                       device=None) -> SkillMaps:
    """CC/ACC for one (model, lead) dataset (ACCs.ipynb cells 13/25/38),
    computed on `device` (None: the card).

    external_clim: optional (53, Y, X) or (T, Y, X) model climatology
    (the GEFS dc0018 path); default anomalies use the sample weekly mean.
    Also carries both climatology maps the notebook renders: the obs
    time-mean (cell 10, climo_obs) and the forecast ensemble+time mean
    masked to obs land pixels (cells 11/23/36, climo).
    """
    device = devices.resolve(device)
    xm = bundle.ensemble_mean()
    xm_d = torch.as_tensor(xm, dtype=torch.float32, device=device)
    y_d = torch.as_tensor(bundle.y, dtype=torch.float32, device=device)
    cc = metrics.masked_corr(xm_d, y_d).cpu().numpy()
    acc = metrics.anomaly_cc(xm_d, y_d, bundle.weeks,
                             x_clim=external_clim).cpu().numpy()
    with warnings.catch_warnings():      # all-NaN ocean pixels give NaN
        warnings.simplefilter("ignore", RuntimeWarning)
        clim = np.nanmean(bundle.y, axis=0)
        # cells 11/23/36: x.mean('M').mean('T').where(~y_mask), the
        # forecast climatology masked wherever the obs climatology is NaN
        clim_fcst = np.where(np.isnan(clim), np.nan, np.nanmean(xm, axis=0))
    return SkillMaps(cc=cc, acc=acc, climatology=clim,
                     climatology_fcst=clim_fcst,
                     lats=bundle.lats, lons=bundle.lons)


def weekly_lead_sweep(make_bundle, leads: Dict[str, tuple], device=None) \
        -> Dict[str, SkillMaps]:
    """Run compute_skill_maps across lead windows (the notebook's wk1..wk4
    & wk3-4 sweep, cells 4-8). make_bundle(lead) -> DataBundle."""
    return {wk: compute_skill_maps(make_bundle(lead), device=device)
            for wk, lead in leads.items()}


# ------------------------------------------------------- RPSS aggregation
@dataclass
class RpssTable:
    """Long-form pixel-wise RPSS records for boxplots."""
    values: np.ndarray            # (n,)
    lead: np.ndarray              # (n,) str
    model: np.ndarray             # (n,) str
    arch: np.ndarray              # (n,) str
    region: np.ndarray            # (n,) str
    period: np.ndarray = None     # (n,) str ('' when runs carry no period)

    def _col(self, name):
        v = getattr(self, name)
        return (np.full(self.values.shape, "", dtype=object)
                if v is None else v)

    def subset(self, **conds) -> "RpssTable":
        """Rows matching all conditions; values may be str or a set."""
        keep = np.ones(self.values.shape, bool)
        for k, want in conds.items():
            want = (want,) if isinstance(want, str) else tuple(want)
            keep &= np.isin(self._col(k), want)
        return RpssTable(*(self._col(f)[keep] if f != "values"
                           else self.values[keep] for f in
                           ("values", "lead", "model", "arch", "region",
                            "period")))


# legacy round-2 output naming for MME trees (pre-MME_IMD contract);
# load_rpss falls back to these so existing results stay readable
_LEGACY_MODEL_NAMES = {"MME": "GEFS_IITM_ECMWF", "2MME": "IITM_ECMWF"}


def rpss_path(outputs_root, period_dir, model, obs, arch, week,
              tag="test") -> str:
    """Resolve one outputs/**/{arch}_rpss_{tag}_{week}.nc artifact
    (Bar_plot.ipynb cell 5 pathing), with a legacy-name fallback for
    MME trees written before the MME_IMD naming fix."""
    path = os.path.join(outputs_root, "outputs", period_dir,
                        f"{model}_{obs}", f"{arch}_rpss_{tag}_{week}.nc")
    if not os.path.exists(path) and model in _LEGACY_MODEL_NAMES:
        alias = os.path.join(
            outputs_root, "outputs", period_dir,
            f"{_LEGACY_MODEL_NAMES[model]}_{obs}",
            f"{arch}_rpss_{tag}_{week}.nc")
        if os.path.exists(alias):
            return alias
    return path


def load_rpss(outputs_root, period_dir, model, obs, arch, week) -> Field:
    return read_netcdf(rpss_path(outputs_root, period_dir, model, obs,
                                 arch, week))


def elr_nan_mask(outputs_root, period_dir, model, obs, week) -> np.ndarray:
    """NaN mask derived from the ELR maps (Bar_plot.ipynb cell 3)."""
    f = load_rpss(outputs_root, period_dir, model, obs, "ELR", week)
    m = f.mean("bootstrap") if "bootstrap" in f.dims else f
    return np.isnan(m.values)


def rpss_records(runs, outputs_root, region_masks=None,
                 region_names=None, log=None) -> RpssTable:
    """Collect pixel-wise bootstrap-mean RPSS for boxplotting.

    runs: iterable of dicts with keys period_dir/model/obs/arch/week/label
    (+ optional 'period' display name). Masking follows Bar_plot.ipynb
    cells 3/5: each run is masked by an ELR wk3-4 NaN map whose
    (period_dir, model) may differ from the run's own — callers set
    'mask_period_dir'/'mask_model'/'mask_week' per run (the notebook uses
    the Common-Period ECMWF mask for MME rows); default is the run's own
    ELR map. A missing mask source falls back to the run's own ELR map,
    then to no mask (reported via log).

    region_masks: optional (R, Y, X) bool; pixels falling in no region get
    region='All'.
    """
    vals, leads, models_, archs, regions, periods = [], [], [], [], [], []
    for run in runs:
        f = load_rpss(outputs_root, run["period_dir"], run["model"],
                      run["obs"], run["arch"], run["week"])
        m = f.mean("bootstrap") if "bootstrap" in f.dims else f
        v = m.values
        mask = None
        specs = [(run.get("mask_period_dir", run["period_dir"]),
                  run.get("mask_model", run["model"]),
                  run.get("mask_week", run["week"])),
                 (run["period_dir"], run["model"], run["week"])]
        for pd_, mod_, wk_ in specs:
            try:
                mask = elr_nan_mask(outputs_root, pd_, mod_, run["obs"], wk_)
                break
            except FileNotFoundError:
                continue
        if mask is not None and mask.shape == v.shape:
            v = np.where(mask, np.nan, v)
        elif log:
            why = "shape mismatch" if mask is not None else "not found"
            log(f"[barplot] ELR mask for {run['period_dir']}"
                f"{run['model']} {run['week']}: {why}; unmasked")
        ok = np.isfinite(v)
        if region_masks is None:
            sel = [("All", ok)]
        else:
            sel = [(region_names[r], ok & region_masks[r])
                   for r in range(len(region_masks))]
        for rname, rm in sel:
            vv = v[rm]
            vals.append(vv)
            leads.append(np.full(vv.shape, run.get("label", run["week"])))
            models_.append(np.full(vv.shape, run["model"]))
            archs.append(np.full(vv.shape, run["arch"]))
            regions.append(np.full(vv.shape, rname))
            periods.append(np.full(vv.shape, run.get("period", "")))
    cat = lambda xs: np.concatenate(xs) if xs else np.array([])
    return RpssTable(values=cat(vals), lead=cat(leads), model=cat(models_),
                     arch=cat(archs), region=cat(regions),
                     period=cat(periods))


def rpss_boxplot(table: RpssTable, path, by="lead", hue="arch",
                 ylim=(-0.2, 0.5), percent=True, dpi=150,
                 order=None, hue_order=None, rename=None):
    """Boxplots of pixel-wise RPSS (Bar_plot.ipynb cells 7/9/10/16/19).

    order/hue_order: category orders (the notebook pins lead order
    week 1/2/3-4 and model order ECMWF/IITM/GEFS/2MME/3MME).
    rename: optional {column: {old: new}} display renames applied before
    plotting (cell 9 renames MME -> 3MME)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    import seaborn as sns

    df = pd.DataFrame({"RPSS": table.values * (100.0 if percent else 1.0),
                       "lead": table.lead, "model": table.model,
                       "arch": table.arch, "region": table.region})
    for col, mapping in (rename or {}).items():
        df[col] = df[col].replace(mapping)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 4))
    # drop order entries absent from the data: seaborn draws empty slots,
    # and a fully-empty hue level crashes older seaborn paints
    if order is not None:
        order = [o for o in order if (df[by] == o).any()] or None
    if hue_order is not None:
        hue_order = [h for h in hue_order if (df[hue] == h).any()] or None
    sns.boxplot(data=df, x=by, y="RPSS", hue=hue, ax=ax, fliersize=1,
                order=order, hue_order=hue_order)
    scale = 100.0 if percent else 1.0
    ax.set_ylim(ylim[0] * scale, ylim[1] * scale)
    ax.axhline(0, color="k", lw=0.5)
    ax.set_ylabel("RPSS (%)" if percent else "RPSS")
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path


def concat_tables(tables: Sequence[RpssTable]) -> RpssTable:
    cols = ("values", "lead", "model", "arch", "region", "period")
    if not tables:
        e = np.array([])
        return RpssTable(e, e, e, e, e, e)
    return RpssTable(*(np.concatenate([t._col(c) if c != "values"
                                       else t.values for t in tables])
                       for c in cols))


def region_rpss(outputs_root, shapefile_path, runs,
                region_names: Optional[Sequence[str]] = None, log=None):
    """Homogeneous-climate-region aggregation (Bar_plot.ipynb cells 12-19):
    rasterize the subdivision shapefile onto EACH run's own data grid
    (the notebook builds per-model masks at each model's resolution,
    cells 13/18) and build the combined per-region RPSS table."""
    from .viz.regions import region_masks as rasterize_regions
    from .viz.regions import region_names_from_dbf
    mask_cache: dict = {}
    tables = []
    for run in runs:
        f = load_rpss(outputs_root, run["period_dir"], run["model"],
                      run["obs"], run["arch"], run["week"])
        lats, lons = f.coords["Y"], f.coords["X"]
        key = (lats.tobytes(), lons.tobytes())
        if key not in mask_cache:
            masks = rasterize_regions(shapefile_path, lats, lons)
            if region_names:
                names = list(region_names)
            else:
                # region labels from the .dbf attribute sidecar when one
                # matches (Bar_plot.ipynb cell 12 reads via geopandas)
                dbf_names = region_names_from_dbf(shapefile_path)
                names = (dbf_names
                         if dbf_names and len(dbf_names) == len(masks)
                         else [f"region{i}" for i in range(len(masks))])
            mask_cache[key] = (masks, names)
        masks, names = mask_cache[key]
        tables.append(rpss_records([run], outputs_root, region_masks=masks,
                                   region_names=names, log=log))
    return concat_tables(tables)

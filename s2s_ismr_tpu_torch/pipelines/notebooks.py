"""CLI drivers replacing the reference's analysis notebooks (port of
s2s_ismr_tpu/pipelines/notebooks.py).

`accs`   = ACCs.ipynb (40 cells): per model and lead week, climatology
           maps + CC/ACC skill maps, written as netcdfs + PNG panels.
           Lead windows per the notebook: wk1/wk2 from the standard
           mapping, wk3=(16,22), wk4=(23,29) ((23,30) for ECMWF),
           wk3-4 combined (cells 4-8/17-21/30-34). CC and ACC run on
           the chosen device (`run_accs(device=None)`: the card).
`barplot`= Bar_plot.ipynb (21 cells): aggregate saved RPSS netcdfs into
           lead/model/arch boxplots, optionally split by homogeneous
           climate regions rasterized from a met-subdivision shapefile.
           Host only: numpy and drawing, no device.

Drawing (`make_plots`, every barplot figure) needs matplotlib, and the
boxplots pandas and seaborn; each is imported inside the call that draws.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from .. import analysis
from ..field import Field
from ..io import write_netcdf

# ACCs.ipynb lead windows (cells 4-8); ECMWF wk4 runs to day 30
ACC_LEADS = {"wk1": (2, 8), "wk2": (9, 15), "wk3": (16, 22),
             "wk4": (23, 29), "wk3-4": (16, 29)}
ACC_LEADS_ECMWF = {**ACC_LEADS, "wk4": (23, 30), "wk3-4": (16, 30)}


def run_accs(models: Sequence[str] = ("IITM", "ECMWF", "GEFS"),
             source="synthetic", out_root=".", years=(2003, 2018),
             obs="IMD", domain=None, seed=0, step=2.0, make_plots=False,
             fig_format="png", log=print, device=None) -> Dict[str, dict]:
    """CC/ACC skill-map sweep across models and lead weeks, on `device`
    (None: the card).

    fig_format: 'png' or 'pdf'; the notebook exports every figure as a
    dpi-300 PDF (ACCs.ipynb cells 10-13/23-25/36-38)."""
    from .. import device as devices
    from ..grid import Domain
    device = devices.resolve(device)
    domain = domain or Domain(67, 98, 7, 38)
    out: Dict[str, dict] = {}
    for model in models:
        leads = ACC_LEADS_ECMWF if model == "ECMWF" else ACC_LEADS

        def make_bundle(wk, lead, model=model):
            if source == "synthetic":
                from ..data import synthetic
                return synthetic.synthetic_hindcast(
                    model=model, obs=obs, years=years, domain=domain,
                    step=step, seed=seed, lead=lead)
            from ..data import gateway
            # week=wk keys the download cache per lead window: a shared
            # name would silently serve one lead's data for another
            x, y = gateway.get_data(years=years, download=True, week=wk,
                                    model=model, obs=obs,
                                    domain=domain.as_tuple(),
                                    season="May-Sep", custom_lead=lead)
            return gateway.to_bundle(x, y, name=f"{model}_{obs}")

        if model == "GEFS" and source == "iridl":
            # GEFS ACC uses the dc0018 lead-dependent model climatology
            # instead of the sample weekly mean (ACCs.ipynb cells 28/38);
            # the file is lead-independent, so download it once
            from ..data import gateway
            _clim_dl = {"download": True}

            def make_clim(lead, bundle):
                s_dates, clim = gateway.get_gefs_climatology(
                    domain.as_tuple(), lead, log=log, **_clim_dl)
                _clim_dl["download"] = False
                return gateway.external_clim_for_times(
                    bundle.t, lead, s_dates, clim)
        else:
            make_clim = None

        maps = {}
        for wk, lead in leads.items():
            b = make_bundle(wk, lead)
            ext = make_clim(lead, b) if make_clim else None
            maps[wk] = analysis.compute_skill_maps(b, external_clim=ext,
                                                   device=device)
        out_dir = os.path.join(out_root, "outputs", "ACC", f"{model}_{obs}")
        paths = {}
        for wk, sm in maps.items():
            coords = {"Y": sm.lats, "X": sm.lons}
            fld = Field(np.stack([sm.cc, sm.acc, sm.climatology,
                                  sm.climatology_fcst]),
                        ("metric", "Y", "X"), coords, "skill")
            paths[wk] = write_netcdf(
                fld, os.path.join(out_dir, f"ccacc_{wk}.nc"))
            log(f"[accs] {model} {wk}: CC mean "
                f"{np.nanmean(sm.cc):+.3f}, ACC mean {np.nanmean(sm.acc):+.3f}")
        if make_plots:
            from ..viz import maps as vmaps
            figdir = os.path.join(out_root, "figures", "ACC",
                                  f"{model}_{obs}")
            for wk, sm in maps.items():
                # separate CC and ACC figures with the notebook's exact
                # styling (cells 13/25/38): discrete 0.1 levels, CC to
                # +-0.6 / ACC to +-0.5, RdBu_r pinned at +-0.4
                for metric, vals, levels in (
                        ("CC", sm.cc, vmaps.CC_LEVELS),
                        ("ACC", sm.acc, vmaps.ACC_LEVELS)):
                    paths[f"fig_{metric.lower()}_{wk}"] = \
                        vmaps.plot_skill_map(
                            vals, sm.lats, sm.lons,
                            os.path.join(
                                figdir, f"{metric}_{wk}.{fig_format}"),
                            title=f"{metric} {model} {wk}",
                            levels=levels)
                # mm/day climatology maps: the notebook renders these
                # ONLY for the weeks3-4 window (cells 10-11/23/36 all
                # plot x_week34/y_week34); ECMWF's forecast field is a
                # 14-day accumulation there, divided by 14 (cell 23;
                # IITM/GEFS cells 11/36 have no division)
                if wk == "wk3-4":
                    scale = 1.0 / 14.0 if model == "ECMWF" else 1.0
                    paths[f"fig_climo_obs_{wk}"] = vmaps.plot_climatology(
                        sm.climatology, sm.lats, sm.lons,
                        os.path.join(figdir,
                                     f"climo_obs_{wk}.{fig_format}"))
                    paths[f"fig_climo_{wk}"] = vmaps.plot_climatology(
                        sm.climatology_fcst * scale, sm.lats, sm.lons,
                        os.path.join(figdir, f"climo_{wk}.{fig_format}"))
        out[model] = paths
    return out


# Bar_plot.ipynb cell-5 run matrix: periods x models x leads x archs.
# The notebook spells the period "Full period" in cell 5 but reads
# "outputs/Full Period/..." in cells 3/13 — its Windows host is
# case-insensitive; this package writes and reads "Full Period".
BARPLOT_PERIODS = ("Common Period", "Full Period", "MME", "2MME")
BARPLOT_MODELS = ("IITM", "GEFS", "ECMWF", "MME", "2MME")
BARPLOT_WEEKS = {"wk1": "week 1", "wk2": "week 2", "wk3-4": "week 3-4"}
LEAD_ORDER = ("week 1", "week 2", "week 3-4")
# cell 9/10/19 model display order; MME rows render as "3MME"
MME_HUE_ORDER = ("ECMWF", "IITM", "GEFS", "2MME", "3MME")
# cell 16 per-lead y-limits for the region facets
REGION_YLIMS = {"week 1": (-0.15, 0.5), "week 2": (-0.15, 0.3),
                "week 3-4": (-0.15, 0.15)}


def default_barplot_runs(obs="IMD", periods=None, weeks=None,
                         archs=("ELR", "unet")) -> list:
    """The full Bar_plot.ipynb cell-5 probe matrix. Masking mirrors
    cells 3/5: Common/MME/2MME rows are masked by the Common-Period
    wk3-4 ELR map of the row's model (ECMWF standing in for MME/2MME);
    Full-Period rows by the Full-Period map; and Full-Period MME rows
    don't exist (the notebook KeyErrors its mask lookup and skips)."""
    runs = []
    for period in periods or BARPLOT_PERIODS:
        for model in BARPLOT_MODELS:
            if period == "Full Period" and model in ("MME", "2MME"):
                continue
            mask_model = "ECMWF" if model in ("MME", "2MME") else model
            mask_period = (period if period == "Full Period"
                           else "Common Period")
            for week, label in (weeks or BARPLOT_WEEKS).items():
                for arch in archs:
                    runs.append({
                        "period_dir": period + "/", "period": period,
                        "model": model, "obs": obs, "arch": arch,
                        "week": week, "label": label,
                        "mask_period_dir": mask_period + "/",
                        "mask_model": mask_model, "mask_week": "wk3-4"})
    return runs


# kept for back-compat with round-2 callers; superseded by
# default_barplot_runs()
DEFAULT_BARPLOT_RUNS = default_barplot_runs(
    periods=("Common Period",), archs=("ELR", "unet"))


def _region_figures(out_root, shapefile, region_names, table_runs, figdir,
                    paths, log):
    """Per-region facets (Bar_plot.ipynb cells 12-19): Full-Period
    single-model facet per lead (cell 16) + Common+MME facet (cell 19)."""
    rt = analysis.region_rpss(out_root, shapefile, table_runs,
                              region_names=region_names, log=log)
    paths["by_region"] = analysis.rpss_boxplot(
        rt, os.path.join(figdir, "rpss_by_region.png"),
        by="region", hue="arch", ylim=(-0.2, 0.5))
    for lead in LEAD_ORDER:
        tag = lead.replace(" ", "_")
        fp = rt.subset(period="Full Period", lead=lead,
                       model=("ECMWF", "IITM", "GEFS"))
        if fp.values.size:
            paths[f"region_full_{tag}"] = analysis.rpss_boxplot(
                fp, os.path.join(figdir, f"facet_region_bar_{tag}.png"),
                by="region", hue="arch",
                ylim=REGION_YLIMS[lead], hue_order=("unet", "ELR"))
        mm = rt.subset(period=("Common Period", "MME", "2MME"), lead=lead)
        if mm.values.size:
            paths[f"region_mme_{tag}"] = analysis.rpss_boxplot(
                mm, os.path.join(figdir, f"MME_region_facet_{tag}.png"),
                by="region", hue="model", ylim=(-0.2, 0.5),
                hue_order=MME_HUE_ORDER,
                rename={"model": {"MME": "3MME"}})


def run_barplot(out_root=".", runs: Optional[list] = None,
                shapefile: Optional[str] = None,
                region_names: Optional[Sequence[str]] = None,
                ylim=(-0.2, 0.5), log=print) -> Dict[str, object]:
    """Aggregate saved RPSS netcdfs into the Bar_plot.ipynb figure set.

    Probes the full cell-5 matrix (Common/Full/MME/2MME x models x
    wk1/wk2/wk3-4 x ELR/unet) by default; absent artifacts are skipped
    AND reported in the returned dict under 'skipped' (the notebook
    prints-and-continues, which after a full `run suite` silently drops
    half the matrix; here the report makes coverage visible).

    Emits: by_model/by_lead summaries, Full-Period per-arch plots
    (cell 7, ylim -0.2..0.5), MME per-arch plots (cell 9), the
    MME-compare wk3-4 boxplot (cell 10, ylim -0.2..0.2), and, given a
    subdivision shapefile, per-region facets (cells 16/19)."""
    runs = runs if runs is not None else default_barplot_runs()
    present, skipped = [], []
    for r in runs:
        p = analysis.rpss_path(out_root, r["period_dir"], r["model"],
                               r["obs"], r["arch"], r["week"])
        (present.append(r) if os.path.exists(p)
         else skipped.append(os.path.relpath(p, out_root)))
    if not present:
        raise FileNotFoundError(
            f"no rpss outputs found under {out_root}/outputs — run tune "
            f"pipelines first")
    figdir = os.path.join(out_root, "figures", "barplots")
    paths: Dict[str, object] = {}
    table = analysis.rpss_records(present, out_root, log=log)
    paths["by_model"] = analysis.rpss_boxplot(
        table, os.path.join(figdir, "rpss_by_model.png"),
        by="model", hue="arch", ylim=ylim)
    paths["by_lead"] = analysis.rpss_boxplot(
        table, os.path.join(figdir, "rpss_by_lead.png"),
        by="lead", hue="arch", ylim=ylim, order=LEAD_ORDER)

    # cell 7: Full-Period per-arch, models side by side per lead
    for arch in ("ELR", "unet"):
        sub = table.subset(period="Full Period", arch=arch)
        if sub.values.size:
            paths[f"full_period_{arch}"] = analysis.rpss_boxplot(
                sub, os.path.join(figdir, f"Full_period_{arch}_plots.png"),
                by="lead", hue="model", ylim=(-0.2, 0.5), order=LEAD_ORDER)
    # cells 9/10: Common+MME+2MME, the multi-model-ensemble story
    mme_scope = table.subset(period=("Common Period", "MME", "2MME"))
    for arch in ("ELR", "unet"):
        sub = mme_scope.subset(arch=arch)
        if sub.values.size and set(sub.period) & {"MME", "2MME"}:
            paths[f"mme_{arch}"] = analysis.rpss_boxplot(
                sub, os.path.join(figdir, f"MME_{arch}_plots.png"),
                by="lead", hue="model", ylim=(-0.2, 0.5), order=LEAD_ORDER,
                hue_order=MME_HUE_ORDER, rename={"model": {"MME": "3MME"}})
    cmp_ = mme_scope.subset(lead="week 3-4")
    if cmp_.values.size and set(cmp_.period) & {"MME", "2MME"}:
        # cell 10: the paper's headline MME-vs-single-model comparison
        paths["mme_compare"] = analysis.rpss_boxplot(
            cmp_, os.path.join(figdir, "MME_RPSS_wk3-4.png"),
            by="arch", hue="model", ylim=(-0.2, 0.2),
            hue_order=MME_HUE_ORDER,
            rename={"model": {"MME": "3MME"},
                    "arch": {"ELR": "ELR", "unet": "UNET"}})
    if shapefile:
        _region_figures(out_root, shapefile, region_names, present,
                        figdir, paths, log)
    paths["skipped"] = skipped
    n_run = len(present)
    log(f"[barplot] aggregated {n_run}/{len(runs)} matrix rows; "
        f"{len(skipped)} absent"
        + (f" (first: {skipped[0]})" if skipped else ""))
    log(f"[barplot] {json.dumps({k: v for k, v in paths.items()})}")
    return paths

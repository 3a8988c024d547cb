"""Realtime forecast evaluation with GradCAM + MJO/ENSO diagnostics (port
of s2s_ismr_tpu/pipelines/realtime.py).

Rebuilds the capability of the reference's Realtime_fcast_MME.ipynb,
which is missing from its snapshot (README.md:22 describes it: 2023
realtime forecast evaluation, GradCAM maps, MJO/ENSO diagnostics). The
surviving plumbing it relied on, download_forecast and get_obs
(dataloader.py:338-495), maps to data/gateway.py.

Flow: load per-fold winner checkpoints -> fetch realtime forecasts for a
set of init dates -> predict tercile probabilities (optionally MME-blend
across models) -> label verifying obs with the hindcast-trained rolling
terciler -> score (RPS, RPSS) -> GradCAM (U-Net) or saliency (cnn, mlp)
per date -> composite p(above) by MJO phase and ENSO state.

The entry points take `device=` (None: the card, raising without one).
Predictions run through `engine.predict` and attributions through
`attrib.attribution`, both in fixed row chunks with the winner's state
frozen; labels and scores are torch ops on the device; the host fetches,
composites and writes the JAX package's outputs tree.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, replace
from typing import Dict, Optional

import numpy as np
import torch

from .. import attrib, timeutils
from .. import device as devices
from ..field import Field
from ..io import write_netcdf
from ..ops import elr as elr_ops
from ..ops import metrics, terciles
from ..train import checkpoint
from ..train.engine import predict


# ---------------------------------------------------- MJO / ENSO machinery
def mjo_phase(rmm1, rmm2, active_threshold=1.0):
    """Standard WH04 8-phase MJO classification from the RMM index.
    Returns (phase 1..8 int array — 0 where the index is missing,
    active bool array — False there)."""
    rmm1 = np.asarray(rmm1, float)
    rmm2 = np.asarray(rmm2, float)
    finite = np.isfinite(rmm1) & np.isfinite(rmm2)
    amp = np.where(finite, np.hypot(rmm1, rmm2), np.nan)
    ang = np.arctan2(np.where(finite, rmm2, 0.0),
                     np.where(finite, rmm1, 1.0))  # [-pi,pi), 0=+RMM1 axis
    # phase 1 starts at 180 deg and advances clockwise through the WH04 wheel
    phase = (np.floor((ang + np.pi) / (np.pi / 4)).astype(int) % 8) + 1
    return np.where(finite, phase, 0), finite & (amp >= active_threshold)


def enso_state(nino34_anom, threshold=0.5):
    """'elnino' / 'neutral' / 'lanina' per sample from Nino3.4 anomalies;
    'unknown' where the index is missing (never fabricate a group)."""
    a = np.asarray(nino34_anom, float)
    out = np.full(a.shape, "neutral", dtype=object)
    out[a >= threshold] = "elnino"
    out[a <= -threshold] = "lanina"
    out[~np.isfinite(a)] = "unknown"
    return out


def composite_by(values, groups):
    """Mean of `values` (T, ...) per distinct group label."""
    groups = np.asarray(groups)
    out = {}
    for g in np.unique(groups):
        sel = groups == g
        with np.errstate(all="ignore"):
            out[str(g)] = np.nanmean(values[sel], axis=0)
    return out


# ------------------------------------------------------------ the pipeline
@dataclass
class RealtimeResult:
    probs: np.ndarray                     # (T, Y, X, 3)
    labels: Optional[np.ndarray]          # (T, Y, X) verifying terciles
    rps_map: Optional[np.ndarray]         # (Y, X)
    rpss_map: Optional[np.ndarray]        # (Y, X) vs climatology
    gradcam_maps: Optional[np.ndarray]    # (T, Y, X)
    mjo_composites: Dict[str, np.ndarray] = field(default_factory=dict)
    enso_composites: Dict[str, np.ndarray] = field(default_factory=dict)


def evaluate_realtime(model, variables, x_images, hindcast_obs,
                      hindcast_weeks, fcst_weeks, obs=None,
                      obs_t_mask=None,
                      rmm=None, nino34=None, gradcam_category=2,
                      window=1, probs=None, device=None):
    """Evaluate realtime forecasts against the hindcast climatology, on
    `device` (None: the card).

    model/variables: a winner checkpoint (train/checkpoint.py).
    x_images:     (T, H, W, C) realtime ensemble-mean forecast images
    hindcast_obs: (Th, H, W) the obs record used to fit tercile edges
                  (labels realtime obs exactly like training labels)
    hindcast_weeks/fcst_weeks: ISO weeks of both axes
    obs:          optional (T, H, W) verifying observations
    obs_t_mask:   optional (T,) bool — which forecast rows actually have
                  verifying obs. Without it, an all-NaN obs row would be
                  labeled category 1 wherever the hindcast edges are
                  finite (NaN fails both `< q0` and `> q1` comparisons),
                  silently scoring unverified dates as "observed normal"
    rmm:          optional (T, 2) RMM1/RMM2 MJO index at init time
    nino34:       optional (T,) Nino3.4 anomaly at init time
    probs:        optional precomputed (T, H, W, 3) probabilities — the
                  MME path blends per-model winner predictions upstream
                  (training.py:344-350 semantics) and scores the blend
                  here; model/variables/x_images then only drive the
                  attribution
    The attribution is GradCAM for a U-Net and input saliency for the cnn
    and mlp (attrib.attribution).
    """
    device = devices.resolve(device)
    x = torch.as_tensor(np.asarray(x_images, np.float32), device=device)
    state = attrib.frozen_state(model, variables, device)
    if probs is None:
        probs = predict(model, state, x).cpu().numpy()
    else:
        probs = np.asarray(probs)

    labels = rps_map = rpss_map = None
    if obs is not None:
        wm = timeutils.week_window_matrix(window)
        pool = np.ones(hindcast_obs.shape[0], bool)
        edges, present = terciles.rolling_edges(
            torch.as_tensor(np.asarray(hindcast_obs), device=device),
            hindcast_weeks, pool, wm)
        labels = terciles.label_terciles(np.asarray(obs), fcst_weeks, edges,
                                         present).cpu().numpy()
        if obs_t_mask is not None:
            labels[~np.asarray(obs_t_mask, bool)] = np.nan
        p_dev = torch.as_tensor(probs, dtype=torch.float32, device=device)
        lab_dev = torch.as_tensor(labels, device=device)
        rps_map = metrics.rps(p_dev, lab_dev, obs_t_mask).cpu().numpy()
        climo = torch.full_like(p_dev, 1.0 / 3.0)
        rpss_map = metrics.rpss(climo, p_dev, lab_dev,
                                obs_t_mask).cpu().numpy()

    cams = attrib.attribution(model, state, x,
                              category=gradcam_category).cpu().numpy()

    res = RealtimeResult(probs=probs, labels=labels, rps_map=rps_map,
                         rpss_map=rpss_map, gradcam_maps=cams)
    above = probs[..., 2]
    if rmm is not None:
        phase, active = mjo_phase(rmm[:, 0], rmm[:, 1])
        lab = np.where(active, phase.astype(str), "inactive")
        lab = np.where(phase == 0, "unknown", lab)   # missing index rows
        res.mjo_composites = composite_by(above, lab)
    if nino34 is not None:
        res.enso_composites = composite_by(above, enso_state(nino34))
    return res


def fetch_indices_for_dates(dates, download=True, cache_dir="download",
                            cookies="cookies.txt", log=print):
    """Operational RMM + Nino3.4 acquisition for a set of init dates
    (IRIDL BOM RMM daily / Kaplan Nino3.4 monthly; data/iridl.py
    INDEX_PATHS). Returns (rmm (N,2) | None, nino34 (N,) | None) — a
    failed fetch degrades to None with a log line rather than failing
    the forecast run (composites are a diagnostic, not the product)."""
    from ..data import gateway
    rmm = nino34 = None
    try:
        rmm = gateway.get_rmm_index(dates, download=download,
                                    cache_dir=cache_dir, cookies=cookies,
                                    log=log)
    except Exception as e:
        log(f"[realtime] RMM index unavailable "
            f"({type(e).__name__}: {e}); MJO composites skipped")
    try:
        nino34 = gateway.get_nino34(dates, download=download,
                                    cache_dir=cache_dir, cookies=cookies,
                                    log=log)
    except Exception as e:
        log(f"[realtime] Nino3.4 index unavailable "
            f"({type(e).__name__}: {e}); ENSO composites skipped")
    return rmm, nino34


def write_composites(res: RealtimeResult, out_dir, coords, week,
                     tag=None) -> Dict[str, str]:
    """Persist MJO/ENSO composite maps as mjo_*/enso_* netcdfs next to
    the other realtime outputs (one (Y, X) map per group label)."""
    paths = {}
    mid = f"{tag}_" if tag else ""
    for kind, comps in (("mjo", res.mjo_composites),
                        ("enso", res.enso_composites)):
        for label, m in comps.items():
            key = f"{kind}_{label}"
            paths[key] = write_netcdf(
                Field(np.asarray(m), ("Y", "X"), coords, "p_above"),
                os.path.join(out_dir, f"{key}_{mid}{week}.nc"))
    return paths


def render_figures(res: RealtimeResult, lats, lons, titles, fig_dir, week,
                   tag=None, out_root=".") -> Dict[str, str]:
    """Render the missing notebook's deliverable as figures (README.md:22
    'GradCAM maps and MJO/ENSO diagnostics', in the reference repo's map
    style plots.py:394-461): p(above) maps and GradCAM overlays per
    forecast date, MJO-phase / ENSO-state composite panels. Written under
    figures/Realtime/ next to the outputs/ netcdfs. Needs matplotlib,
    imported here and nowhere else on the realtime path."""
    from ..viz import realtime as vrt
    from ..viz.maps import default_shapes_dir
    sd = default_shapes_dir(out_root)
    mid = f"{tag}_" if tag else ""
    figs = {
        "fig_probs": vrt.plot_probability_maps(
            res.probs[..., 2], lats, lons,
            os.path.join(fig_dir, f"probs_above_{mid}{week}.png"),
            titles=titles, shapes_dir=sd),
        "fig_gradcam": vrt.plot_gradcam_overlays(
            res.probs[..., 2], res.gradcam_maps, lats, lons,
            os.path.join(fig_dir, f"gradcam_{mid}{week}.png"),
            titles=titles, shapes_dir=sd),
    }
    if res.mjo_composites:
        figs["fig_mjo"] = vrt.plot_composite_panels(
            res.mjo_composites, lats, lons,
            os.path.join(fig_dir, f"mjo_composites_{mid}{week}.png"),
            kind="mjo", shapes_dir=sd)
    if res.enso_composites:
        figs["fig_enso"] = vrt.plot_composite_panels(
            res.enso_composites, lats, lons,
            os.path.join(fig_dir, f"enso_composites_{mid}{week}.png"),
            kind="enso", shapes_dir=sd)
    return figs


def load_winner_for_realtime(models_dir, week, architecture="unet",
                             device=None):
    """Pick the best fold's checkpoint by stored val_loss; returns (model,
    state dict) on `device` (None: the card)."""
    with open(os.path.join(models_dir, f"winners_{week}.json")) as f:
        manifest = json.load(f)
    best = min(manifest, key=lambda e: e["val_loss"])
    return checkpoint.load_winner(models_dir, week, best["fold"],
                                  architecture, device=device)


_MONTH_NAMES = {v: k for k, v in timeutils.MONTHS.items()}


def fetch_realtime_set(cfg, dates, download=True, cache_dir="download",
                       cookies="cookies.txt", log=print, model=None):
    """Operational fetch (dataloader.py:338-495 flow): one dated forecast
    per init date via download_forecast, plus the verifying obs series on
    the model grid via get_obs, matched to the forecasts' mid-lead valid
    times. Returns a DataBundle whose y is NaN where no verifying obs
    exists yet (e.g. a true future forecast).

    model: which of cfg.models to fetch (default the first; MME realtime
    fetches each model with its own per-model lead, cfg.lead(m))."""
    from ..data import gateway
    from ..data.bundle import DataBundle

    model, obs = model or cfg.models[0], cfg.obs
    lead = cfg.lead(model)
    xs, t_valid = [], []
    for d in dates:
        y_, m_, day_ = (int(v) for v in str(d).split("-"))
        x = gateway.download_forecast(
            model, obs, day_, _MONTH_NAMES[m_], y_,
            domain=cfg.domain.as_tuple(), week=cfg.week, out_dir=cfg.out_dir,
            download=download, regrid=cfg.regrid, custom_lead=lead,
            cache_dir=cache_dir, cookies=cookies, log=log)
        x = x.transpose("T", "M", "Y", "X")
        xs.append(np.asarray(x.values, np.float32))
        t_valid.append(timeutils.to_datetime64(x.coords["T"]))
    t = np.concatenate(t_valid)
    lats = np.asarray(x.coords["Y"])
    lons = np.asarray(x.coords["X"])
    x_all = np.concatenate(xs, axis=0)

    years = (int(timeutils.year(t).min()), int(timeutils.year(t).max()))
    yf = gateway.get_obs(model, obs, domain=cfg.domain.as_tuple(),
                         week=cfg.week, years=years, season=cfg.season,
                         out_dir=cfg.out_dir, download=download,
                         regrid=cfg.regrid, cache_dir=cache_dir,
                         cookies=cookies, log=log)
    t_obs = timeutils.to_datetime64(yf.coords["T"])
    y_all = np.full((len(t),) + x_all.shape[2:], np.nan, np.float32)
    for i, tv in enumerate(t):
        if len(t_obs) == 0:
            continue
        d = np.abs((t_obs - tv) / np.timedelta64(1, "D")).astype(float)
        j = int(np.argmin(d))
        # the obs URL running-averages on the obs dataset's native T grid
        # (iridl.obs_url), so a stamp matching the forecast valid time
        # exists whenever the window is actually observed — allow only
        # calendar jitter (<=1 day), NOT nearest-within-half-a-week: a
        # future forecast a few days past the record's newest obs must
        # stay unverified (NaN), not be scored against the wrong window
        if d[j] <= 1.0:
            y_all[i] = yf.values[j]
    n_match = int(np.isfinite(y_all).any(axis=(1, 2)).sum())
    log(f"[realtime] fetched {len(dates)} forecasts; verifying obs for "
        f"{n_match}/{len(t)} valid times")
    return DataBundle(x=x_all, y=y_all, t=t, lats=lats, lons=lons,
                      name=f"{model}_{obs}_realtime")


def _validate_winner_fingerprint(models_dir, cfg):
    """Fail loudly if the persisted winners were tuned under a different
    input/output contract than the realtime cfg (mirrors the 'load'
    replay's validation, tune.py run_nn_branch_load): a predictor or
    head mismatch would otherwise surface as a shape error — or worse,
    silently wrong probabilities — only after the downloads complete."""
    path = os.path.join(models_dir, f"winners_{cfg.week}.json")
    if not os.path.exists(path):
        return                       # load_winner_for_realtime will raise
    with open(path) as f:
        manifest = json.load(f)
    fp = (manifest[0] or {}).get("fingerprint") if manifest else None
    if not fp:
        return                       # pre-fingerprint checkpoint
    for key, want in (("predictor", cfg.predictor), ("output", cfg.output),
                      ("standardize", bool(cfg.standardize)),
                      # a winners tree copied across week dirs (manifest
                      # renamed) must not silently blend leads: the
                      # tuned week travels in the fingerprint
                      ("week", cfg.week)):
        got = fp.get(key, "proba" if key == "output" else None)
        if got is not None and got != want:
            raise ValueError(
                f"winners at {path} were tuned with {key}={got!r} but the "
                f"realtime run requests {key}={want!r}; pass the matching "
                f"--{key} flag (or retune)")


def _standardize_rt(hb, rt):
    """Hindcast-fitted per-pixel standardization for operational inputs:
    the winner was trained on hindcast-standardized tensors (run_pipeline
    pads then standardizes), so the realtime forecasts and their
    verifying obs get the HINDCAST's transform — images land in the
    trained input distribution and obs are labeled against the
    standardized hindcast's tercile edges."""
    stats = hb.standardize_stats()
    xm, xs, ym, ys = stats
    hb = hb.standardize(stats=stats)
    if rt.x.shape[1] == xm.shape[0]:
        rt = rt.standardize(stats=stats)
    else:
        # realtime ensembles can carry a different member count than the
        # hindcast (e.g. ECMWF 51 vs 11); members are exchangeable, so
        # pool the per-member hindcast stats (law of total variance)
        pm = np.nanmean(xm, 0)
        ps = np.sqrt(np.nanmean(xs ** 2, 0) + np.nanvar(xm, 0))
        rt = replace(rt, x=(rt.x - pm) / ps, y=(rt.y - ym) / ys)
    return hb, rt


def _load_winners(cfg, out_root, device):
    """Each model's best-fold winner under out_root, every fingerprint
    validated first."""
    winners = {}
    for m in cfg.models:
        mdir = os.path.join(out_root, "models", cfg.out_dir,
                            f"{m}_{cfg.obs}", cfg.week)
        _validate_winner_fingerprint(mdir, cfg)
        winners[m] = load_winner_for_realtime(mdir, cfg.week,
                                              cfg.architecture, device)
    return winners


def _predict(winner, x, device):
    model, variables = winner
    return predict(model, variables,
                   torch.as_tensor(np.asarray(x, np.float32), device=device))


def _write_outputs(res, out_dir, coords, week, names):
    """The probs / gradcam (/ rpss) netcdfs under out_dir, named
    {names[key]}_{week}.nc."""
    paths = {
        "probs": write_netcdf(
            Field(res.probs[..., 2], ("T", "Y", "X"), coords, "p_above"),
            os.path.join(out_dir, f"{names['probs']}_{week}.nc")),
        "gradcam": write_netcdf(
            Field(res.gradcam_maps, ("T", "Y", "X"), coords, "gradcam"),
            os.path.join(out_dir, f"{names['gradcam']}_{week}.nc")),
    }
    if res.rpss_map is not None:
        paths["rpss"] = write_netcdf(
            Field(res.rpss_map[None], ("bootstrap", "Y", "X"), coords,
                  "rpss"),
            os.path.join(out_dir, f"{names['rpss']}_{week}.nc"))
    return paths


def run_realtime_forecast(cfg, dates, out_root=".", download=True,
                          cache_dir="download", cookies="cookies.txt",
                          rmm=None, nino34=None, hindcast_source="iridl",
                          seed=0, synthetic_step=None, log=print,
                          fetch_indices=True, make_plots=False,
                          device=None):
    """The full operational pipeline the reference's missing
    Realtime_fcast_MME.ipynb performed (README.md:22), on `device` (None:
    the card): download dated realtime forecasts + verifying obs
    (dataloader.py:338-495), predict tercile probabilities with the
    persisted tuned winner, label/score against hindcast-fitted tercile
    edges, attach GradCAM and MJO/ENSO composites, and write netcdfs.

    dates: iterable of 'YYYY-MM-DD' init dates.
    hindcast_source: where the tercile-edge-fitting hindcast record comes
    from ('iridl' cached fetch = the tuning data; 'synthetic' for tests).

    MME configs (tune_MME/tune_2MME winners) fetch each model's dated
    forecast with its own lead, predict with each model's persisted
    winner, and blend the tercile probabilities with renormalization
    (training.py:344-350); tercile edges come from the cross-model-mean
    obs record exactly like tune_MME's y (tune_MME.py:77). GradCAM is
    attributed through the FIRST model's winner (an attribution needs a
    single network; the blend has none).
    """
    from .tune import _apply_pad, load_bundles

    device = devices.resolve(device)
    if cfg.predictor == "stacked":
        raise ValueError("realtime forecasting does not support the "
                         "stacked predictor mode")
    if cfg.output == "deterministic":
        raise ValueError("realtime forecasting needs tercile probabilities"
                         " — winners tuned with output='deterministic' "
                         "emit raw precipitation")
    model_names = list(cfg.models)
    winners = _load_winners(cfg, out_root, device)   # before any fetch

    hind = load_bundles(cfg, hindcast_source, seed=seed,
                        synthetic_step=synthetic_step, download=download)
    rts, hbs, probs_per_model = {}, {}, []
    have_obs_per_model = []
    for m in model_names:
        rt = fetch_realtime_set(cfg, dates, download=download,
                                cache_dir=cache_dir, cookies=cookies,
                                log=log, model=m)
        # which forecast rows have verifying obs — computed per model
        # BEFORE padding (the ECMWF-full pad zero-fills y, which would
        # count as "observed"). MME valid times differ per model lead
        # (e.g. IITM (16,29) vs ECMWF (16,30)): a date is verified only
        # if EVERY model's window is observed — the blended score uses
        # the cross-model-mean obs, which is NaN if any model's is
        have_obs_per_model.append(np.isfinite(rt.y).any(axis=(1, 2)))
        rt = _apply_pad(cfg, rt)
        hb = _apply_pad(cfg, hind[m])
        if cfg.standardize:
            hb, rt = _standardize_rt(hb, rt)
        rts[m], hbs[m] = rt, hb
        x_m = rt.fillna(0.0).predictor_images(cfg.predictor)
        if not probs_per_model:
            x_imgs = x_m                 # first model's images (GradCAM)
        probs_per_model.append(_predict(winners[m], x_m, device))

    # operational MJO/ENSO composites: auto-acquire the real RMM/Nino3.4
    # series at the init dates unless the caller supplied them or opted
    # out (honors --no-download via the same cache discipline)
    if fetch_indices and rmm is None and nino34 is None:
        rmm, nino34 = fetch_indices_for_dates(
            dates, download=download, cache_dir=cache_dir,
            cookies=cookies, log=log)

    have_obs = np.logical_and.reduce(have_obs_per_model)
    first = model_names[0]
    rt0, hb0 = rts[first], hbs[first]
    if cfg.is_mme:
        probs = elr_ops.blend_probabilities(probs_per_model)
        hind_y = np.mean(np.stack([hbs[m].y for m in model_names]), 0)
        rt_y = np.mean(np.stack([rts[m].y for m in model_names]), 0)
    else:
        probs = probs_per_model[0]
        hind_y, rt_y = hb0.y, rt0.y
    model, variables = winners[first]
    res = evaluate_realtime(
        model, variables, x_imgs, hind_y, hb0.weeks, rt0.weeks,
        obs=rt_y if have_obs.any() else None, obs_t_mask=have_obs,
        rmm=rmm, nino34=nino34, probs=probs.cpu().numpy(), device=device)

    model_name = "_".join(model_names)
    out_dir = os.path.join(out_root, "outputs", "Realtime",
                           f"{model_name}_{cfg.obs}")
    coords = {"Y": rt0.lats, "X": rt0.lons}
    tag = f"{dates[0]}_{dates[-1]}" if len(dates) > 1 else str(dates[0])
    paths = _write_outputs(res, out_dir, coords, cfg.week, {
        "probs": f"fcst_probs_above_{tag}", "gradcam": f"fcst_gradcam_{tag}",
        "rpss": f"fcst_rpss_{tag}"})
    paths.update(write_composites(res, out_dir, coords, cfg.week, tag=tag))
    if make_plots:
        fig_dir = os.path.join(out_root, "figures", "Realtime",
                               f"{model_name}_{cfg.obs}")
        titles = [f"init {d}" for d in dates]
        paths.update(render_figures(res, rt0.lats, rt0.lons, titles,
                                    fig_dir, cfg.week, tag=tag,
                                    out_root=out_root))
    log(f"[realtime] operational {model_name} {cfg.week}: "
        f"{len(dates)} init dates, verified {int(have_obs.sum())}; "
        f"outputs: {sorted(paths)}")
    return res, paths


def run_realtime_eval(cfg, out_root=".", source="synthetic", seed=0,
                      synthetic_step=None, rmm=None, nino34=None,
                      log=print, fetch_indices=True, download=True,
                      cache_dir="download", cookies="cookies.txt",
                      make_plots=False, device=None):
    """The CLI's realtime run, on `device` (None: the card): load the tuned winner for
    `cfg`, evaluate held-out 'realtime' forecasts, write
    probability/RPSS/GradCAM netcdfs.

    The final year of the record plays the realtime period, scored
    against hindcast-fitted terciles (the reference evaluated its 2023
    forecasts the same way; true operational fetches go through
    run_realtime_forecast). MJO/ENSO composites require real index series
    via `rmm` ((T,2) RMM1/RMM2) and `nino34` ((T,) anomalies); with
    source='synthetic' absent indices are filled with synthetic stand-ins
    so the composite machinery runs — they are never fabricated for real
    data.

    MME configs predict with each model's winner and blend with
    renormalization (training.py:344-350), scored against the
    cross-model-mean obs record (tune_MME.py:77); GradCAM attributes
    through the first model's winner.

    Known leak, kept as the JAX package has it: the winner is the fold
    of least val loss, and that fold's training years can include the
    final year scored here (ROADMAP section C), so this RPSS is not a
    held-out score.
    """
    from .tune import _apply_pad, load_bundles

    device = devices.resolve(device)
    model_names = list(cfg.models)
    winners = _load_winners(cfg, out_root, device)

    if cfg.predictor == "stacked":
        raise ValueError("realtime eval does not support the stacked "
                         "predictor mode (members are batch rows there)")
    if cfg.output == "deterministic":
        raise ValueError("realtime eval needs tercile probabilities — "
                         "winners tuned with output='deterministic' emit "
                         "raw precipitation")
    bundles = load_bundles(cfg, source, seed=seed,
                           synthetic_step=synthetic_step)
    # replay preprocessing EXACTLY as the tune run that persisted the
    # winner: grid pad (tune_ECMWF_full's 23->24 rows — the checkpoint's
    # conv shapes expect the padded grid) then optional standardization
    bundles = {n: _apply_pad(cfg, v) for n, v in bundles.items()}
    if cfg.standardize:
        bundles = {n: v.standardize() for n, v in bundles.items()}
    first = model_names[0]
    b = bundles[first].fillna(0.0)
    years = b.years
    rt = years == years.max()             # realtime period = final year
    hc = ~rt
    x_rt = b.predictor_images(cfg.predictor)[rt]
    if source == "synthetic":
        rng = np.random.default_rng(seed)
        if rmm is None:
            rmm = rng.normal(0, 1.2, size=(int(rt.sum()), 2))
        if nino34 is None:
            nino34 = rng.normal(0, 0.8, size=int(rt.sum()))
    elif fetch_indices and rmm is None and nino34 is None:
        # real data: acquire the REAL RMM/Nino3.4 series at each
        # forecast's init time (valid T minus the mid-lead offset —
        # _stamp_midlead_time inverted)
        lead = cfg.lead(first)
        t_init = (timeutils.to_datetime64(b.t[rt]) - np.timedelta64(
            int(round((lead[0] + lead[1]) / 2)), "D"))
        rmm, nino34 = fetch_indices_for_dates(
            t_init, download=download, cache_dir=cache_dir,
            cookies=cookies, log=log)

    probs = None
    if cfg.is_mme:
        per_model = [
            _predict(winners[m], bundles[m].fillna(0.0).predictor_images(
                cfg.predictor)[rt], device) for m in model_names]
        probs = elr_ops.blend_probabilities(per_model).cpu().numpy()
        y_shared = np.mean(np.stack([bundles[m].y for m in model_names]), 0)
    else:
        y_shared = bundles[first].y

    # tercile edges are fit on the RAW obs record: the fillna'd tensor
    # would give ocean pixels finite all-zero edges, labeling the NaN
    # verifying obs as 'normal' and polluting the RPSS map with fake
    # skill values (raw NaN pools -> NaN edges -> NaN labels -> NaN RPSS)
    model, variables = winners[first]
    res = evaluate_realtime(
        model, variables, x_rt, y_shared[hc],
        b.weeks[hc], b.weeks[rt],
        obs=y_shared[rt], rmm=rmm, nino34=nino34, probs=probs,
        device=device)

    model_name = "_".join(model_names)
    out_dir = os.path.join(out_root, "outputs", "Realtime",
                           f"{model_name}_{cfg.obs}")
    coords = {"Y": b.lats, "X": b.lons}
    paths = _write_outputs(res, out_dir, coords, cfg.week, {
        "probs": "probs_above", "gradcam": "gradcam",
        "rpss": "rpss_realtime"})
    paths.update(write_composites(res, out_dir, coords, cfg.week))
    if make_plots:
        fig_dir = os.path.join(out_root, "figures", "Realtime",
                               f"{model_name}_{cfg.obs}")
        t_valid = timeutils.to_datetime64(b.t[rt])
        titles = [f"valid {s}" for s in
                  np.datetime_as_string(t_valid, unit="D")]
        paths.update(render_figures(res, b.lats, b.lons, titles,
                                    fig_dir, cfg.week, out_root=out_root))
    log(f"[realtime] {model_name} {cfg.week}: "
        f"{res.probs.shape[0]} forecasts, mean RPSS "
        f"{np.nanmean(res.rpss_map) if res.rpss_map is not None else 'n/a'}; "
        f"MJO composites: {sorted(res.mjo_composites)}; "
        f"ENSO composites: {sorted(res.enso_composites)}")
    return res, paths

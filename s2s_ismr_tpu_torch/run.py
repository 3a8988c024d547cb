"""CLI: `python -m s2s_ismr_tpu_torch.run <config> [options]` (port of
s2s_ismr_tpu/run.py).

One entry point runs any registered tune config on one device:

    python -m s2s_ismr_tpu_torch.run tune_ECMWF_com --synthetic --fast
    python -m s2s_ismr_tpu_torch.run tune_ECMWF_com --synthetic --fast --cpu
    python -m s2s_ismr_tpu_torch.run suite --configs tune_ECMWF_com,tune_2MME
    python -m s2s_ismr_tpu_torch.run realtime --from-config tune_ECMWF_com \
        --synthetic --out DIR      # after a tune run into the same --out
    python -m s2s_ismr_tpu_torch.run accs --synthetic --out DIR
    python -m s2s_ismr_tpu_torch.run barplot --out DIR   # after tune runs
    python -m s2s_ismr_tpu_torch.run --list

The run goes to the GPU (`cuda`) unless `--cpu` is given; without `--cpu`
and without a card it exits non-zero and never falls back to the CPU.
`barplot` reads saved outputs on the host and needs no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

def _check_suite(results, expected_path):
    """Regression gate (suite --check): per-config elr/nn RPSS test means
    vs a checked-in expectation file. Returns a list of human-readable
    failure strings (empty = pass); expected configs that were not run
    this session are reported but do not fail (a --configs subset run
    checks only its subset)."""
    with open(expected_path) as fh:
        expected = json.load(fh)
    tol = float(expected.get("tolerance", 0.0))
    failures = []
    for name, want in expected.get("configs", {}).items():
        got = results.get(name)
        if got is None:
            print(f"[check] skip {name}: not run this session",
                  file=sys.stderr)
            continue
        if "error" in got:
            failures.append(f"{name}: run errored: {got['error']}")
            continue
        for key in ("elr_rpss_test_mean", "nn_rpss_test_mean"):
            if key not in want:
                continue
            drift = abs(float(got[key]) - float(want[key]))
            if not (drift <= tol):        # catches NaN too
                failures.append(
                    f"{name}.{key}: got {got[key]!r}, expected "
                    f"{want[key]!r} (drift {drift:.3e} > tol {tol:.1e})")
    return failures


def _run(cfg, args, device, **kw):
    """One tune config through run_pipeline; returns (outputs, summary)."""
    import numpy as np
    from .pipelines import tune
    out = tune.run_pipeline(cfg, source=args.source, out_root=args.out,
                            seed=args.seed, synthetic_step=args.step,
                            training_type=args.training_type,
                            make_plots=args.plots, device=device, **kw)
    return out, {
        "config": cfg.name,
        "elapsed_s": round(out.elapsed_s, 2),
        "elr_rpss_test_mean": float(np.nanmean(out.elr.rpss_test.values)),
        "nn_rpss_test_mean": float(np.nanmean(out.nn.rpss_test.values)),
    }


def _device(args):
    """'cpu' with --cpu, else 'cuda' — or None (with a message) when there
    is no card."""
    if args.cpu:
        return "cpu"
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device; the port runs on the GPU. Pass --cpu "
              "to run on the CPU.", file=sys.stderr)
        return None
    return "cuda"


def _parser():
    ap = argparse.ArgumentParser(prog="s2s_ismr_tpu_torch.run",
                                 description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("config", nargs="?",
                    help="pipeline name (e.g. tune_ECMWF_com) or `suite`")
    ap.add_argument("--list", action="store_true", help="list configs")
    ap.add_argument("--source", default=None,
                    choices=["synthetic", "iridl"],
                    help="data source (default: synthetic, except for the "
                         "operational `realtime --date`, whose tercile "
                         "edges must come from the real hindcast record: "
                         "iridl there)")
    ap.add_argument("--synthetic", dest="source", action="store_const",
                    const="synthetic")
    ap.add_argument("--fast", action="store_true",
                    help="shrunken smoke variant (2 folds, 2 trials)")
    ap.add_argument("--plots", action="store_true",
                    help="render figures (needs matplotlib; the barplot "
                         "boxplots also pandas and seaborn)")
    ap.add_argument("--out", default=".", help="output root directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--step", type=float, default=None,
                    help="synthetic grid step in degrees")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--folds", type=int, default=None)
    ap.add_argument("--training-type", dest="training_type",
                    default="tune", choices=["tune", "train", "load"],
                    help="'tune' the grid search, 'train' the first grid "
                         "entry only, 'load' replay the winners saved "
                         "under --out")
    ap.add_argument("--week", default=None,
                    help="re-target the config at another lead week (wk1, "
                         "wk2, wk3-4); `suite` accepts a comma list and "
                         "runs the configs x weeks cross product")
    ap.add_argument("--standardize", action="store_true",
                    help="per-pixel standardize x/y over T before splits")
    ap.add_argument("--output", choices=("proba", "deterministic"),
                    default="proba",
                    help="U-Net head: tercile probabilities or a ReLU "
                         "precipitation regression")
    ap.add_argument("--predictor", choices=("mean", "multi_predictor",
                                            "stacked"), default=None,
                    help="predictor images: the ensemble mean, members "
                         "as channels, or members as extra rows")
    ap.add_argument("--batch-size", dest="batch_size", default=None,
                    metavar="N|full",
                    help="override the tuning grid's batch sizes with one "
                         "value; 'full' trains whole-training-set batches "
                         "(changes SGD semantics, never a default)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the GPU")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write torch.profiler Chrome traces of the ELR "
                         "stage to DIR/trace.json and of the NN stage to "
                         "DIR/nn/trace.json (`suite`: DIR/<config>/...)")
    ap.add_argument("--models", default=None,
                    help="comma-separated model list for `accs`")
    ap.add_argument("--fig-format", dest="fig_format", default="png",
                    choices=("png", "pdf"),
                    help="accs: figure file format; the reference notebook "
                         "exports dpi-300 PDFs (ACCs.ipynb cells "
                         "10-13/23-25/36-38)")
    ap.add_argument("--configs", default=None,
                    help="comma-separated config list for `suite` "
                         "(default: all tune configs)")
    ap.add_argument("--resume", action="store_true",
                    help="suite: skip configs already recorded in "
                         "<out>/suite_summary.json by a run with the same "
                         "settings")
    ap.add_argument("--check", default=None, metavar="JSON",
                    help="suite: exit 1 if a config's elr/nn_rpss_test_mean "
                         "drifts from JSON ({'tolerance': t, 'configs': "
                         "{name: {...}}}) by more than the tolerance")
    ap.add_argument("--from-config", dest="from_config",
                    default="tune_ECMWF_com",
                    help="tune config whose winners `realtime` evaluates")
    ap.add_argument("--date", default=None,
                    help="realtime: comma-separated YYYY-MM-DD init dates; "
                         "fetches dated forecasts + verifying obs through "
                         "the gateway and predicts with the tuned winner; "
                         "without --date, realtime scores the held-out "
                         "final hindcast year")
    ap.add_argument("--no-download", dest="download", action="store_false",
                    help="realtime: use cached files only")
    ap.add_argument("--no-indices", dest="indices", action="store_false",
                    help="realtime: skip RMM/Nino3.4 index acquisition "
                         "(MJO/ENSO composites are then omitted)")
    ap.add_argument("--shapefile", default=None,
                    help="barplot: region polygon shapefile for "
                         "per-region RPSS boxplots (Bar_plot.ipynb "
                         "cells 12-19)")
    ap.add_argument("--regions", default=None,
                    help="barplot: comma-separated region names matching "
                         "--shapefile polygon order (default: .dbf "
                         "attribute names, else region{i})")
    ap.add_argument("--runs", default=None, metavar="JSON",
                    help="barplot: path to a JSON list of run dicts "
                         "(period_dir/model/obs/arch/week[/label/period/"
                         "mask_*]) overriding the default Bar_plot.ipynb "
                         "cell-5 matrix")
    return ap


def _check_weeks(args):
    """Validate --week up front; returns an exit code or None."""
    from .pipelines.configs import LEAD_MAPPING
    if args.config in ("barplot", "accs"):
        # these aggregate across all weeks; silently ignoring --week would
        # look like a filter that never applied
        raise SystemExit(f"--week is not consumed by `{args.config}` "
                         f"(use --runs to select barplot rows)")
    if args.config != "suite" and "," in args.week:
        raise SystemExit("--week takes a single week outside `suite`")
    wk_list = args.week.split(",")
    bad = [w for w in wk_list if w not in LEAD_MAPPING]
    if bad:
        # catches typos AND stray empties ('wk1,' would otherwise
        # silently run the config's BASE week under a '[ ]' key)
        print(f"error: unknown week(s) {bad}; choose from "
              f"{sorted(LEAD_MAPPING)}", file=sys.stderr)
        return 2
    if len(set(wk_list)) != len(wk_list):
        print("error: duplicate weeks in --week", file=sys.stderr)
        return 2
    return None


def _resolve(name, args):
    from .pipelines import get_config
    cfg = get_config(name)
    if args.fast:
        cfg = cfg.fast_variant()
    if args.epochs:
        cfg = replace(cfg, epochs=args.epochs)
    if args.folds:
        cfg = replace(cfg, n_bootstraps=args.folds)
    if args.standardize:
        cfg = replace(cfg, standardize=True)
    if args.output != "proba":
        cfg = replace(cfg, output=args.output)
    if args.predictor:
        cfg = replace(cfg, predictor=args.predictor)
    if args.batch_size:
        try:
            bs = 0 if args.batch_size == "full" else int(args.batch_size)
        except ValueError:
            raise SystemExit("--batch-size must be a positive integer "
                             "or 'full'") from None
        if args.batch_size != "full" and bs <= 0:
            raise SystemExit("--batch-size must be a positive integer "
                             "or 'full'")
        cfg = replace(cfg, tuning=replace(cfg.tuning, batch_sizes=(bs,)))
    return cfg


def _realtime(args):
    """`realtime`: the held-out final year scored with the winners of
    --from-config (run_realtime_eval), or the operational forecast of the
    --date init dates (run_realtime_forecast); prints the paths JSON."""
    from .pipelines import get_config, realtime
    try:
        cfg = get_config(args.from_config)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    # the tune-path overrides, so the cfg matches the winners being
    # loaded (their manifest fingerprint is validated downstream)
    if args.output != "proba":
        cfg = replace(cfg, output=args.output)
    if args.predictor:
        cfg = replace(cfg, predictor=args.predictor)
    if args.standardize:
        cfg = replace(cfg, standardize=True)
    if args.week:
        cfg = cfg.with_week(args.week)
    device = _device(args)
    if device is None:
        return 2
    kw = dict(out_root=args.out, seed=args.seed, synthetic_step=args.step,
              download=args.download, fetch_indices=args.indices,
              make_plots=args.plots, device=device)
    if args.date:
        _, paths = realtime.run_realtime_forecast(
            cfg, args.date.split(","), hindcast_source=args.source, **kw)
    else:
        _, paths = realtime.run_realtime_eval(cfg, source=args.source, **kw)
    print(json.dumps(paths, indent=1))
    return 0


def _stderr(msg):
    print(msg, file=sys.stderr)


def _accs(args):
    """`accs`: the CC/ACC skill-map sweep (ACCs.ipynb) on the chosen
    device; logs to stderr, the paths JSON to stdout."""
    from .pipelines.notebooks import run_accs
    device = _device(args)
    if device is None:
        return 2
    kw = {}
    if args.models:
        kw["models"] = tuple(args.models.split(","))
    out = run_accs(source=args.source, out_root=args.out, seed=args.seed,
                   step=args.step or 2.0, make_plots=args.plots,
                   fig_format=args.fig_format, log=_stderr, device=device,
                   **kw)
    print(json.dumps(out, indent=1))
    return 0


def _barplot(args):
    """`barplot`: RPSS boxplots of saved outputs (Bar_plot.ipynb), on the
    host; logs to stderr, the figure paths JSON to stdout."""
    from .pipelines.notebooks import run_barplot
    rnames = tuple(args.regions.split(",")) if args.regions else None
    runs = None
    if args.runs:
        with open(args.runs) as fh:
            runs = json.load(fh)
    print(json.dumps(run_barplot(out_root=args.out, runs=runs,
                                 shapefile=args.shapefile,
                                 region_names=rnames, log=_stderr),
                     indent=1))
    return 0


def suite_fingerprint(args):
    """The run settings a suite records in its summary: --resume only
    reuses results produced under identical settings (a fast smoke must
    not satisfy a later production resume), and a --check file holds
    numbers valid at its own."""
    return {k: getattr(args, k) for k in
            ("fast", "epochs", "folds", "standardize", "output",
             "predictor", "source", "seed", "step", "training_type",
             "batch_size", "week", "cpu")}


def _suite(args):
    """Several configs (x weeks) in one process; the summary is rewritten
    atomically after every config, so a killed session can --resume."""
    from .pipelines import CONFIGS
    names = (args.configs.split(",") if args.configs
             else [n for n in CONFIGS])
    weeks = args.week.split(",") if args.week else [None]
    # resolve every name up front: a typo in the 3rd config must not
    # abort the session after an hour of work on the first two
    try:
        cfgs = []
        for nm in names:
            base = _resolve(nm, args)
            for w in weeks:
                c = base.with_week(w) if w else base
                if w:
                    # distinct summary keys per (config, week), even for a
                    # single --week; file names carry the week already
                    c = replace(c, name=f"{c.name}[{w}]")
                cfgs.append(c)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    device = _device(args)
    if device is None:
        return 2
    fingerprint = suite_fingerprint(args)
    t0 = time.time()
    prior_total = 0.0   # wall already spent in resumed-over sessions
    spath = os.path.join(args.out, "suite_summary.json")
    results = {}
    if args.resume and os.path.exists(spath):
        try:
            with open(spath) as fh:
                prior = json.load(fh)
        except json.JSONDecodeError:
            print(f"[suite] {spath} is corrupt; starting fresh",
                  file=sys.stderr)
            prior = {}
        if prior.get("settings", {}) == fingerprint:
            # keep successes; failed configs are retried
            results = {k: v for k, v in prior.get("configs", {}).items()
                       if "error" not in v}
            prior_total = float(prior.get("total_s", 0.0))
            if results:
                print(f"[suite] resuming past {sorted(results)}",
                      file=sys.stderr)
        elif prior:
            print("[suite] prior summary has different run settings; "
                  "starting fresh", file=sys.stderr)
    os.makedirs(args.out, exist_ok=True)

    def _dump(summary):
        tmp = spath + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(summary, fh, indent=1)
        os.replace(tmp, spath)    # atomic: a kill can't truncate it

    def _summary(partial):
        return {"configs": results, "settings": fingerprint,
                "total_s": round(prior_total + time.time() - t0, 2),
                "partial": partial}

    for cfg in [c for c in cfgs if c.name not in results]:
        kw = {}
        if args.profile:
            kw["profile_dir"] = os.path.join(args.profile, cfg.name)
        try:
            _, results[cfg.name] = _run(cfg, args, device, **kw)
        except Exception as e:
            # one config must not kill the session; --resume retries it
            results[cfg.name] = {"config": cfg.name,
                                 "error": f"{type(e).__name__}: {e}"}
            print(f"[suite] {cfg.name} FAILED: {e}", file=sys.stderr)
        _dump(_summary(partial=True))   # survive a kill mid-suite
    summary = _summary(partial=False)
    check_failures = []
    if args.check:
        check_failures = _check_suite(results, args.check)
        summary["check"] = {"expected": args.check,
                            "failures": check_failures,
                            "ok": not check_failures}
        for line in check_failures:
            print(f"[check] FAIL {line}", file=sys.stderr)
        if not check_failures:
            print("[check] ok: all configs within tolerance",
                  file=sys.stderr)
    _dump(summary)
    print(json.dumps(summary, indent=1))
    if any("error" in r for r in results.values()) or check_failures:
        return 1
    return 0


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.list or not args.config:
        from .pipelines import CONFIGS
        for name, cfg in CONFIGS.items():
            print(f"{name:18s} models={'+'.join(cfg.models):16s} "
                  f"years={cfg.years} week={cfg.week} dir={cfg.out_dir!r}")
        print("suite              run several tune configs in one process")
        print("accs               CC/ACC skill-map sweep (ACCs.ipynb)")
        print("barplot            RPSS boxplot aggregation (Bar_plot.ipynb)")
        print("realtime           realtime eval + GradCAM + MJO/ENSO "
              "(Realtime_fcast_MME)")
        return 0
    if args.source is None:
        # operational realtime fits tercile edges on the hindcast record;
        # a synthetic default there would silently score real forecasts
        # against random-data edges
        args.source = ("iridl" if args.config == "realtime" and args.date
                       else "synthetic")
    if args.week:
        rc = _check_weeks(args)
        if rc is not None:
            return rc
    if args.profile and not args.fast:
        print("[warn] --profile records every op and kernel of the run, "
              "so the trace of a full sweep is very large and slow to "
              "write. Stage timings (outputs/**/profile_{week}.json) are "
              "written without it; use --profile with --fast for a trace "
              "you can open.", file=sys.stderr)
    if args.config == "accs":
        return _accs(args)
    if args.config == "barplot":
        return _barplot(args)
    if args.config == "suite":
        return _suite(args)
    if args.config == "realtime":
        return _realtime(args)

    try:
        cfg = _resolve(args.config, args)
        if args.week:
            cfg = cfg.with_week(args.week)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    device = _device(args)
    if device is None:
        return 2
    out, summary = _run(cfg, args, device, profile_dir=args.profile)
    summary["outputs"] = out.paths
    summary["figures"] = out.figures
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

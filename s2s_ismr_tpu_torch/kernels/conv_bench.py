"""On-card measurements of the conv3x3 kernel (csrc/conv3x3.cu). Needs a
CUDA card; prints its results and writes them as JSON under `--out`.

    python -m s2s_ismr_tpu_torch.kernels.conv_bench check [--tile T ...]
            [--shape N H W C O ...]
        every tile of the kernel's table (or the tiles named), forward and
        dx mode, both acts, against the float64 plain version (rtol 1e-4 /
        atol 1e-5) at the slice's extreme shapes, the edge shapes and the
        families' cases (or the shapes named), wherever the tile takes the
        shape, and bit-equal repeats;
    python -m s2s_ismr_tpu_torch.kernels.conv_bench lanes [--tile T ...]
        the lane mode: every tile at the slice's extreme shapes and two
        bottlenecks for 4 and 20 lanes, forward and dx mode, both acts,
        against the float64 plain lane version, and every lane bit-equal
        to a one-lane launch of it with the same tile;
    python -m s2s_ismr_tpu_torch.kernels.conv_bench tiles [--shapes JSON]
        device time of every tile at every slice shape (batch 16), or at
        the shapes of a JSON list (`chip_smoke.py --shapes-json` writes the
        shapes phases 3, 10, 11 and 12 time), forward and dx mode, wherever
        the tile takes the shape, beside the tile the wrapper picks;
    python -m s2s_ismr_tpu_torch.kernels.conv_bench fit TILES_JSON
        fits each family's constants of the wrapper's tile cost model
        (conv.COST) to a `tiles` sweep by least squares on log time, and
        prints them with the times its picks would take and the tiles it
        picks at no shape (runs on the CPU);
    python -m s2s_ismr_tpu_torch.kernels.conv_bench step [--backend B]
        one lane of the tune_ECMWF_com fast sweep (fold 0, trial 0) under
        torch.profiler: device ops, device busy time and kernel launches
        per optimizer step, for the conv backends `kernel` and `torch`,
        and the host time of the wrapper's tile choice per launch.

The `step` mode uses only the package's public entry points, so the same
file can profile another checkout of the package (put that checkout first
on PYTHONPATH and run this file by its path).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# H100 SXM peaks (NVIDIA's data sheet, dense): float32 outside the tensor
# cores, TF32 on them, and HBM3 bandwidth. The bound of a conv is the larger
# of its FLOP and its bytes (each input read once, each output written once)
# over these: its FLOP at the float32 rate, the function's own type; and,
# beside it, at the rate of the kernel's route, 3xTF32 (three TF32 mma per
# float32 product, PEAK_TF32_FLOPS / 3)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
RTOL, ATOL = 1e-4, 1e-5
# the kernel's edges: 1x1 maps, ragged tiles (W up to 64 in the 64x64
# configs), channel counts off every tile width and off 4, C = O = 384
EDGE_SHAPES = ((2, 1, 1, 3, 5), (3, 64, 64, 17, 33), (1, 33, 65, 2, 1),
               (1, 9, 70, 130, 40), (2, 4, 4, 384, 384))


def unet_shapes(torch, ucfg, n, hw, c_in=1, device="cuda"):
    """(N, H, W, C, O) of every kernel conv of one forward of the port's
    U-Net of `ucfg` on n rows of hw = (H, W) images with c_in channels, in
    call order (recorded by forward pre-hooks)."""
    from s2s_ismr_tpu_torch.models.layers import FusedConv3x3
    from s2s_ismr_tpu_torch.models.unet import UNet
    shapes = []

    def hook(mod, args):
        shapes.append(tuple(args[0].shape) + (mod.conv.kernel.shape[-1],))
    model = UNet(ucfg, c_in, generator=torch.Generator().manual_seed(0),
                 device=device)
    for m in model.modules():
        if isinstance(m, FusedConv3x3):
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        model(torch.zeros((n,) + tuple(hw) + (c_in,), device=device))
    return shapes


def trial_shapes(torch, grid, hw, c_in=1, rows=None, device="cuda"):
    """(N, H, W, C, O) of every kernel conv of every trial of the tuning
    grid on hw images, at the trial's batch size (or at each row count of
    `rows`), in the trials' product order, each shape once."""
    from s2s_ismr_tpu_torch.models.unet import UNetConfig
    from s2s_ismr_tpu_torch.train.sweep import enumerate_trials
    shapes, seen = [], set()
    for t in enumerate_trials(grid):
        for n in rows or (t.batch_size,):
            # the conv shapes depend on the rows, filters and depth only
            if (n, t.filters, t.n_blocks) in seen:
                continue
            seen.add((n, t.filters, t.n_blocks))
            ucfg = UNetConfig(filters=t.filters, n_blocks=t.n_blocks,
                              ct_kernel=t.ct_kernel)
            for s in unet_shapes(torch, ucfg, n, hw, c_in, device):
                if s not in shapes:
                    shapes.append(s)
    return shapes


def config_shapes(torch, cfg, device="cuda"):
    """(training shapes, eval shapes) of a PipelineConfig's tune run on its
    synthetic data: every kernel conv of every trial of cfg.tuning at the
    trial's batch size on the config's grid, and at the eval row counts,
    the val rows (each epoch's val forward) and all T (the winner
    forward), each cut into engine.row_chunk chunks. The multi_predictor
    puts the members into the first conv's channels; the stacked predictor
    makes them extra rows, so its splits and eval rows are the members
    times the record's."""
    from s2s_ismr_tpu_torch.pipelines.tune import (_apply_pad, load_bundles,
                                                   resolve_batch_sizes)
    from s2s_ismr_tpu_torch.train import splits
    from s2s_ismr_tpu_torch.train.engine import row_chunk
    b = _apply_pad(cfg, load_bundles(cfg)[cfg.models[0]])
    if cfg.predictor == "stacked":
        b = b.stacked()
    x = b.predictor_images(cfg.predictor, shape_only=True)
    fm = splits.bootstrap_masks(b.years, cfg.n_bootstraps,
                                frac_valid=cfg.nn_frac_valid,
                                frac_test=cfg.nn_frac_test)
    chunk = row_chunk(torch.empty((1,) + x[1:]))
    rows = []
    for n in (int(fm.val.sum(1).max()), x[0]):
        rows += [min(chunk, n - i) for i in range(0, n, chunk)]
    grid = resolve_batch_sizes(cfg.tuning, x[0])
    hw, c_in = x[1:3], x[3]
    return (trial_shapes(torch, grid, hw, c_in, device=device),
            trial_shapes(torch, grid, hw, c_in, rows=rows, device=device))


def slice_shapes(torch, filters=(2, 3), batch=16, device="cuda"):
    """(N, H, W, C, O) of every kernel conv of the tune_ECMWF_com U-Nets
    with these filters (n_blocks 3) on the 32x32 grid at `batch` rows, in
    first-seen order."""
    from dataclasses import replace

    from s2s_ismr_tpu_torch.pipelines import get_config
    grid = replace(get_config("tune_ECMWF_com").tuning,
                   n_filters=tuple(filters), batch_sizes=(batch,))
    return trial_shapes(torch, grid, (32, 32), device=device)


def bound_parts(shape, dx=False, elu=True, flops=PEAK_F32_FLOPS):
    """(ms of its FLOP at `flops` per second, ms of its bytes at the memory
    rate) of one launch: the forward reads x, w, b and writes out; the dx
    mode reads g, w (and the saved output for ELU) and writes dx (and g' for
    ELU)."""
    n, h, w, c, o = shape
    m = n * h * w
    flop = 2 * m * 9 * c * o
    if dx:
        floats = m * o * (3 if elu else 1) + 9 * c * o + m * c
    else:
        floats = m * c + 9 * c * o + o + m * o
    return flop / flops * 1e3, 4 * floats / PEAK_BYTES * 1e3


def bound(shape, dx=False, elu=True, flops=PEAK_F32_FLOPS):
    """(least time in ms, 'operations' | 'bytes') of one launch; `flops`
    PEAK_TF32_FLOPS / 3 gives the bound of the 3xTF32 route."""
    t_ops, t_bytes = bound_parts(shape, dx, elu, flops)
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def device_ms_many(torch, fns, reps=50, tries=3):
    """Device time per call of each fn of `fns` from ONE torch.profiler
    window: fn i's `reps` calls, then a marker kernel (torch.cuda._sleep's
    spin_kernel); the device events up to each marker are that fn's. One
    window instead of one per fn saves the profiler's fixed cost per
    window. None if no window held every group (now and then a window
    comes back empty on the card)."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(reps):
                    fn()
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if str(getattr(e, "device_type", "")).endswith("CUDA")),
                        key=lambda e: e.time_range.start)
        groups, us = [], 0.0
        for e in events:
            if "spin_kernel" in e.name:
                groups.append(us)
                us = 0.0
            else:
                us += e.time_range.elapsed_us()
        if len(groups) == len(fns) and all(groups):
            return [g / 1e3 / reps for g in groups]
    return None


def inputs(torch, shape, gen):
    """x, w, b, and an upstream gradient at the scale of a mean loss."""
    n, h, w, c, o = shape
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    k = torch.randn(3, 3, c, o, device="cuda", generator=gen) \
        * (1.0 / (9 * c)) ** 0.5
    b = 0.1 * torch.randn(o, device="cuda", generator=gen)
    g = torch.randn(n, h, w, o, device="cuda", generator=gen) \
        / (n * h * w) ** 0.5
    return x, k, b, g


def lane_inputs(torch, shape, lanes, gen):
    """inputs() for `lanes` lanes, stacked on a leading lane dim: each lane
    its own x, w, b and g."""
    return tuple(torch.stack(ts) for ts in
                 zip(*(inputs(torch, shape, gen) for _ in range(lanes))))


def grouped_layouts(x, w, b, g, w_adj=None):
    """cuDNN's operands for the lane mode as one grouped conv (groups = L):
    x (L, N, H, W, C) -> (N, L*C, H, W) channels-last, w (L, 3, 3, C, O) ->
    (L*O, C, 3, 3), b -> (L*O,), g (L, N, H, W, O) -> (N, L*O, H, W); and
    the adjoint taps (L*C, O, 3, 3) for the dx as a grouped conv of g."""
    L, n, h, wd, c = x.shape
    o = w.shape[-1]

    def nchw(t):
        return t.permute(1, 2, 3, 0, 4).reshape(n, h, wd, -1) \
            .permute(0, 3, 1, 2)
    w_g = w.permute(0, 4, 3, 1, 2).reshape(L * o, c, 3, 3).contiguous()
    w_a = w.flip((1, 2)).permute(0, 3, 4, 1, 2).reshape(L * c, o, 3, 3) \
        .contiguous()
    return nchw(x), w_g, b.reshape(-1), nchw(g), w_a


def excess(got, want):
    """(max abs error, how far the worst element lies past atol + rtol *
    |want|; <= 0 passes)."""
    d = (got.double() - want).abs()
    return float(d.max()), float((d - (ATOL + RTOL * want.abs())).max())


def takes(conv, tile, shape, dx=False, elu=True):
    """Whether the kernel takes tile index `tile` (None: the wrapper's
    pick) for the conv of shape (N, H, W, C, O) in the forward or the dx
    mode."""
    if tile is None:
        return True
    n, h, w, c, o = shape
    ks = (n, h, w, o, c) if dx else shape
    return conv.applicable(conv.TILES[tile], ks, 2 if dx and elu else 1)


def check_tile(torch, conv, shape, tile, gen):
    """The kernel with `tile` (None: the wrapper's pick) against the
    float64 plain version: forward (both acts), dx mode (dx and g', both
    acts), each where the tile takes the shape; each launch twice, which
    must be bit-equal. Returns {case: max abs err} or raises."""
    x, k, b, g = inputs(torch, shape, gen)
    errs = {}
    for act in ("elu", "none"):
        want = conv.conv3x3_bias_act_plain(x.double(), k.double(),
                                           b.double(), act)
        if takes(conv, tile, shape):
            outs = [conv._launch(x, k, b, act, tile=tile) for _ in range(2)]
            ea, ex = excess(outs[0], want)
            if ex > 0 or not torch.equal(outs[0], outs[1]):
                raise AssertionError(
                    f"tile {tile} fwd {act} {shape}: err {ea:.3e}, repeat "
                    f"equal {torch.equal(*outs)}")
            errs[f"fwd_{act}"] = ea
            out = outs[0]
        else:
            out = conv._launch(x, k, b, act)
        if not takes(conv, tile, shape, True, act == "elu"):
            continue
        # the dx mode reads the kernel's own f32 output as the saved output
        dx_w, gp_w = conv.conv3x3_dx_plain(g.double(), out.double(),
                                           k.double(), act)
        runs = [conv._launch_dx(g, out, k, act, tile=tile) for _ in range(2)]
        for name, got, want, again in (("dx", runs[0][0], dx_w, runs[1][0]),
                                       ("gp", runs[0][1], gp_w, runs[1][1])):
            ea, ex = excess(got, want)
            if ex > 0 or not torch.equal(got, again):
                raise AssertionError(
                    f"tile {tile} {name} {act} {shape}: err {ea:.3e}, "
                    f"repeat equal {torch.equal(got, again)}")
            errs[f"{name}_{act}"] = ea
    return errs


# beside the slice's extremes and the edge shapes, the families' cases:
# halo tiles on 64-, 24- (ragged rows) and 12-wide maps, split tiles at the
# deep bottlenecks
FAMILY_SHAPES = ((16, 64, 64, 16, 8), (32, 24, 24, 16, 8),
                 (16, 12, 12, 12, 24), (16, 1, 1, 384, 384),
                 (16, 2, 2, 192, 384), (32, 2, 2, 128, 128))


def check_picks(torch):
    """The shapes `check` and `lanes` run: the slice's extremes (C = 1,
    the widest 4x4 and 8x8 layers, 32x32), the edge shapes and the
    families' cases."""
    shapes = slice_shapes(torch)
    return ([shapes[0], (16, 4, 4, 96, 96), (16, 8, 8, 96, 48),
             (16, 32, 32, 24, 12)] + list(EDGE_SHAPES) + list(FAMILY_SHAPES))


def run_check(torch, conv, out_dir, tiles=None, shapes=None):
    """Every tile (or `tiles`) at every pick (or `shapes`) it takes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    picks = shapes or check_picks(torch)
    tiles = range(len(conv.TILES)) if tiles is None else tiles
    worst, cases = 0.0, 0
    for tile in tiles:
        for shape in picks:
            errs = check_tile(torch, conv, shape, tile, gen)
            if not errs:
                continue
            cases += len(errs)
            worst = max(worst, *errs.values())
            print(f"  tile {tile} {conv.TILES[tile]} {shape}: " + " ".join(
                f"{k} {v:.1e}" for k, v in errs.items()), flush=True)
    torch.cuda.synchronize()
    print(f"check: {len(tiles)} tiles x {len(picks)} shapes where each "
          f"tile takes them ({cases} cases), fwd/dx/g' x elu/none within "
          f"rtol {RTOL} / atol {ATOL} of float64, repeats bit-equal; max "
          f"abs err {worst:.3e}")
    return {"max_abs_err": worst, "cases": cases}


def run_lanes(torch, conv, out_dir, lane_counts=(4, 20), tiles=None):
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = slice_shapes(torch)
    picks = [shapes[0], (16, 4, 4, 96, 96), (16, 32, 32, 24, 12),
             EDGE_SHAPES[1], (16, 1, 1, 384, 384), (16, 2, 2, 192, 384)]
    tiles = range(len(conv.TILES)) if tiles is None else tiles
    worst = 0.0
    for lanes in lane_counts:
        for tile in tiles:
            for shape in picks:
                if not (takes(conv, tile, shape)
                        and takes(conv, tile, shape, True, False)
                        and takes(conv, tile, shape, True, True)):
                    continue
                x, w, b, g = lane_inputs(torch, shape, lanes, gen)
                for act in ("elu", "none"):
                    out = conv._launch_lanes(x, w, b, act, tile=tile)
                    dx, gp = conv._launch_dx_lanes(g, out, w, act, tile=tile)
                    want = conv.conv3x3_bias_act_lanes_plain(
                        x.double(), w.double(), b.double(), act)
                    dx_w, gp_w = conv.conv3x3_dx_lanes_plain(
                        g.double(), out.double(), w.double(), act)
                    for name, got, ref in (("fwd", out, want),
                                           ("dx", dx, dx_w),
                                           ("gp", gp, gp_w)):
                        ea, ex = excess(got, ref)
                        if ex > 0:
                            raise AssertionError(
                                f"L={lanes} tile {tile} {name} {act} "
                                f"{shape}: err {ea:.3e}")
                        worst = max(worst, ea)
                    for i in range(lanes):
                        one = conv._launch(x[i], w[i], b[i], act, tile=tile)
                        d1, g1 = conv._launch_dx(g[i], out[i], w[i], act,
                                                 tile=tile)
                        if not (torch.equal(one, out[i])
                                and torch.equal(d1, dx[i])
                                and torch.equal(g1, gp[i])):
                            raise AssertionError(
                                f"L={lanes} tile {tile} {act} {shape}: lane "
                                f"{i} differs from its one-lane launch")
            print(f"  L={lanes} tile {tile} {conv.TILES[tile]}: "
                  f"{len(picks)} shapes ok", flush=True)
    torch.cuda.synchronize()
    print(f"lanes: L {lane_counts} x {len(tiles)} tiles x {len(picks)} "
          f"shapes where each tile takes both modes, fwd/dx/g' x elu/none "
          f"within rtol {RTOL} / atol {ATOL} "
          f"of float64, every lane bit-equal to its one-lane launch; max abs "
          f"err {worst:.3e}")
    return {"max_abs_err": worst}


def kernel_shape(shape, mode, act="elu"):
    """(the kernel's shape (N, H, W, staged C, output C), A streams) of
    the launch of `mode` ('fwd' or 'dx') at a conv shape (N, H, W, C, O):
    the forward stages x; the dx mode stages g (and the saved output for
    ELU)."""
    n, h, w, c, o = shape
    if mode == "fwd":
        return (n, h, w, c, o), 1
    return (n, h, w, o, c), 2 if act == "elu" else 1


def read_shapes(path):
    """[(shape, act, modes)] from a JSON list of {"shape", "act",
    "modes"} (chip_smoke.py --shapes-json writes one)."""
    with open(path) as fh:
        return [(tuple(e["shape"]), e["act"], tuple(e["modes"]))
                for e in json.load(fh)]


def family_summary(conv, sweep, tiles):
    """Prints, from a tiles sweep, each family's best tile summed over the
    (shape, mode) cases it takes against the gather family's best at the
    same cases, the halo tiles' wgmma body against their mma.sync body
    (halo_mma) where both take a case, and how many cases cuDNN wins
    against each family's best."""
    import collections
    best = collections.defaultdict(dict)      # (shape, mode) -> family -> us
    lib = {}
    for r in sweep["rows"]:
        for mode in ("fwd", "dx"):
            if mode not in r:
                continue
            key = (tuple(r["shape"]), mode)
            lib[key] = r[mode].get("cudnn_us")
            for t, us in r[mode]["us"]:
                fam = conv.FAMILIES[tiles[t][0]]
                best[key][fam] = min(us, best[key].get(fam, us))
    for mode in ("fwd", "dx"):
        for fam in conv.FAMILIES[1:]:
            keys = [k for k in best if k[1] == mode and fam in best[k]]
            if keys:
                own = sum(best[k][fam] for k in keys)
                gat = sum(best[k]["gather"] for k in keys)
                wins = sum(best[k][fam] < best[k]["gather"] for k in keys)
                print(f"fit: {mode} {fam}: best tile {own:.2f} us against "
                      f"gather's best {gat:.2f} us over its {len(keys)} "
                      f"cases, faster at {wins}")
    # the same halo tile with either body, case by case
    for t, tile in enumerate(tiles):
        if tile[0] != conv.HALO:
            continue
        twin = (conv.HALO_MMA,) + tile[1:]
        if twin not in tiles:
            continue
        u = tiles.index(twin)
        pairs = [(dict(r[m]["us"])[t], dict(r[m]["us"])[u])
                 for r in sweep["rows"] for m in ("fwd", "dx")
                 if m in r and t in dict(r[m]["us"])]
        print(f"fit: halo tile {tile[1:3]}, wgmma against mma.sync at its "
              f"{len(pairs)} cases: wgmma faster at "
              f"{sum(a < b for a, b in pairs)}; summed "
              f"{sum(a for a, _ in pairs):.2f} against "
              f"{sum(b for _, b in pairs):.2f} us")
    both = [k for k in best if "halo" in best[k] and "halo_mma" in best[k]]
    if both:
        wg = sum(best[k]["halo"] < best[k]["halo_mma"] for k in both)
        print(f"fit: the best wgmma against the best mma.sync halo tile at "
              f"the {len(both)} cases both take: wgmma faster at {wg}; "
              f"summed {sum(best[k]['halo'] for k in both):.2f} against "
              f"{sum(best[k]['halo_mma'] for k in both):.2f} us")
    if all(v is not None for v in lib.values()):
        for fam in conv.FAMILIES:
            keys = [k for k in best if fam in best[k]]
            lost = [k for k in keys if lib[k] < best[k][fam]]
            print(f"fit: cuDNN faster than {fam}'s best at {len(lost)} of "
                  f"{len(keys)} cases")


def run_fit(path):
    """Least-squares fit of each family's conv.COST on log time to a tiles
    sweep, over the times of the tiles the kernel takes (conv.applicable:
    a sweep of an older table may hold times the kernel now refuses);
    prints the fitted picks' sums against the best per shape, and the
    tiles the fitted picker takes at no shape."""
    import numpy as np
    from scipy.optimize import minimize

    from s2s_ismr_tpu_torch.kernels import conv
    with open(path) as fh:
        sweep = json.load(fh)["result"]
    tiles = [tuple(t) for t in sweep["tiles"]]
    family_summary(conv, sweep, tiles)
    # a sweep of a wider table fits the table as it stands: the times of
    # tiles since deleted are left out
    for r in sweep["rows"]:
        for mode in ("fwd", "dx"):
            if mode in r:
                r[mode]["us"] = [(t, us) for t, us in r[mode]["us"]
                                 if tiles[t] in conv.TILES]
    data = []                     # (tile, kernel shape, A streams, us)
    for r in sweep["rows"]:
        for mode in ("fwd", "dx"):
            if mode not in r:
                continue
            ks, a = kernel_shape(tuple(r["shape"]), mode, r["act"])
            data += [(tiles[t], ks, a, us) for t, us in r[mode]["us"]
                     if conv.applicable(tiles[t], ks, a)]
    costs, res = {}, {"cost": {}}
    for fam, name in enumerate(conv.FAMILIES):
        pts = [d for d in data if d[0][0] == fam]
        if not pts:
            continue
        # a split tile runs the gather body on 1/S of the chunks: its mma
        # and byte rates are the gather tiles' (they cannot be told apart
        # from its chunks at the few shapes it takes); fit the rest
        tied = fam == conv.SPLIT and conv.GATHER in costs
        full = (lambda c: (c[0], c[1], costs[conv.GATHER][2],
                           costs[conv.GATHER][3], c[2])) if tied else tuple
        start = [conv.COST[fam][i] for i in (0, 1, 4)] if tied \
            else conv.COST[fam]

        def loss(c):
            if min(c) < 0:
                return 1e9
            return sum((np.log(conv.tile_cost(t, ks, a, cost=full(c)))
                        - np.log(us)) ** 2 for t, ks, a, us in pts)
        fit = minimize(loss, start, method="Nelder-Mead",
                       options=dict(maxiter=6000, xatol=1e-7, fatol=1e-10))
        costs[fam] = tuple(float(v) for v in full(fit.x))
        res["cost"][name] = costs[fam]
        print(f"fit: {name} COST = {tuple(round(v, 4) for v in costs[fam])},"
              f" rms log error {(fit.fun / len(pts)) ** 0.5:.3f} over "
              f"{len(pts)} times")
    chosen = {}
    for mode in ("fwd", "dx"):
        picked = best = 0.0
        n = 0
        for r in sweep["rows"]:
            if mode not in r:
                continue
            ks, a = kernel_shape(tuple(r["shape"]), mode, r["act"])
            us = dict(r[mode]["us"])
            pred = {t: conv.tile_cost(tiles[t], ks, a, cost=costs.get(
                tiles[t][0], conv.COST[tiles[t][0]])) for t in us
                if conv.applicable(tiles[t], ks, a)}
            t = min(pred, key=lambda t: (pred[t], t))
            chosen[t] = chosen.get(t, 0) + 1
            picked += us[t]
            best += min(us.values())
            n += 1
        print(f"fit: {mode} summed over {n} shapes: the fitted model's "
              f"picks {picked:.2f} us, best per shape {best:.2f} us")
        res[mode] = {"picked_us": picked, "best_us": best}
    res["chosen"] = {str(tiles[t]): c for t, c in sorted(chosen.items())}
    never = [tiles[t] for t in range(len(tiles))
             if tiles[t] in conv.TILES and t not in chosen]
    print(f"fit: times each tile is picked {res['chosen']}; tiles of the "
          f"table never picked: {never}")
    return res


def run_tiles(torch, conv, out_dir, shapes=None, reps=20):
    """Every tile at every shape (slice shapes, or [(shape, act, modes)])
    where the kernel takes it, forward and dx mode, in one profiler window
    per shape."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    one = torch.empty(1, device="cuda")
    floor = device_ms_many(torch, [lambda: one.fill_(0.0)])
    if floor is None:
        raise RuntimeError("the profiler saw no device time for the fill")
    floor = floor[0] * 1e3
    print(f"  floor: a one-element fill kernel takes {floor:.2f} us")
    shapes = shapes or [(s, "elu", ("fwd", "dx"))
                        for s in slice_shapes(torch)]
    import torch.nn.functional as F
    rows = []
    for shape, act, modes in shapes:
        x, k, b, g = inputs(torch, shape, gen)
        out = conv._launch(x, k, b, act)
        # cuDNN's F.conv2d beside the tiles (TF32 off; its dx a conv of g
        # with the adjoint taps, no ELU')
        x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        k_oihw = k.permute(3, 2, 0, 1).contiguous()
        k_adj = k.flip((0, 1)).transpose(2, 3).permute(3, 2, 0, 1) \
            .contiguous()
        calls = [lambda: F.conv2d(x_nchw, k_oihw, b, padding=1),
                 lambda: F.conv2d(g_nchw, k_adj, None, padding=1)]
        keys = [("fwd", "cudnn"), ("dx", "cudnn")]
        for mode in modes:
            ks, a = kernel_shape(shape, mode, act)
            for t, tile in enumerate(conv.TILES):
                if not conv.applicable(tile, ks, a):
                    continue
                calls.append(
                    (lambda t=t: conv._launch(x, k, b, act, tile=t))
                    if mode == "fwd" else
                    (lambda t=t: conv._launch_dx(g, out, k, act, tile=t)))
                keys.append((mode, t))
        ms = device_ms_many(torch, calls, reps)
        if ms is None:
            raise RuntimeError(f"{shape}: the profiler saw no device time")
        row = {"shape": shape, "act": act}
        for mode in modes:
            us = [(t, v * 1e3) for (m, t), v in zip(keys, ms)
                  if m == mode and t != "cudnn"]
            lib = dict(zip(keys, ms))[mode, "cudnn"] * 1e3
            picked = conv.launch_tile(shape, mode == "dx", act == "elu")
            best = min(us, key=lambda p: p[1])[0]
            row[mode] = {"us": us, "picked": picked, "best": best,
                         "cudnn_us": lib}
            by_t = dict(us)
            print(f"  {str(shape):<22} {act:<4} {mode:<3} picked {picked} "
                  f"{by_t[picked]:7.2f} us, best {best} {by_t[best]:7.2f} "
                  f"us, cuDNN {lib:7.2f} us; "
                  + " ".join(f"{t}:{v:.2f}" for t, v in us), flush=True)
        rows.append(row)
    for mode in ("fwd", "dx"):
        rs = [r[mode] for r in rows if mode in r]
        s_pick = sum(dict(r["us"])[r["picked"]] for r in rs)
        s_best = sum(dict(r["us"])[r["best"]] for r in rs)
        print(f"tiles: {mode} summed over {len(rs)} shapes: picked "
              f"{s_pick:.2f} us, best per shape {s_best:.2f} us")
    return {"tiles": conv.TILES, "floor_us": floor, "rows": rows}


def run_step(torch, out_dir, backends, steps=40, device="cuda"):
    """Device ops per optimizer step of one lane (fold 0, trial 0 of the
    tune_ECMWF_com fast sweep: filters 2, batch 16, 32x32) on the card."""
    from torch.profiler import ProfilerActivity, profile

    from s2s_ismr_tpu_torch.kernels import conv
    from s2s_ismr_tpu_torch.models.unet import UNet, UNetConfig
    from s2s_ismr_tpu_torch.pipelines import get_config
    from s2s_ismr_tpu_torch.pipelines.tune import _nn_setup, load_bundles
    from s2s_ismr_tpu_torch.train import engine
    from s2s_ismr_tpu_torch.train.losses import categorical_crossentropy
    from s2s_ismr_tpu_torch.train.sweep import enumerate_trials

    cfg = get_config("tune_ECMWF_com").fast_variant()
    bundles = load_bundles(cfg)
    _, filled, first, fm, _, y_oh, _ = _nn_setup(cfg, bundles,
                                                  lambda s: None, device)
    x = torch.as_tensor(first.predictor_images("mean"), device=device)
    trial = enumerate_trials(cfg.tuning)[0]
    rows = torch.nonzero(torch.as_tensor(fm.train[0])).flatten()
    rows = rows[torch.randperm(len(rows),
                               generator=torch.Generator().manual_seed(0))]
    bs = trial.batch_size
    bidx = [rows[i * bs % (len(rows) - bs):][:bs].to(device)
            for i in range(steps)]
    res = {}
    for backend in backends:
        model = UNet(UNetConfig(filters=trial.filters,
                                n_blocks=trial.n_blocks,
                                ct_kernel=trial.ct_kernel,
                                conv_backend=backend), x.shape[-1],
                     generator=torch.Generator().manual_seed(0),
                     device=device)
        lane = engine.LaneState.create(model, engine.TrainSettings(), device)
        wb = torch.ones(bs, device=device)

        def step(i):
            engine.train_step(lane, x[bidx[i]], y_oh[0][bidx[i]], wb,
                              trial.lr, categorical_crossentropy)
        for i in range(5):
            step(i)
        torch.cuda.synchronize()
        launches0 = conv.LAUNCHES
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                step(i)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = conv.LAUNCHES - launches0
        dev = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy_us = sum(e.time_range.elapsed_us() for e in dev)
        # unprofiled steps/s, same lane, same call
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        sps = steps / (time.perf_counter() - t1)
        busy_ms = busy_us / 1e3 / steps
        res[backend] = {"device_ops_per_step": len(dev) / steps,
                        "device_busy_ms_per_step": busy_ms,
                        "profiled_wall_ms_per_step": wall * 1e3 / steps,
                        "kernel_launches_per_step": launches / steps,
                        "steps_per_s_unprofiled": sps,
                        # device busy time over the unprofiled step time
                        "idle_share": 1 - busy_ms * sps / 1e3}
        if launches:
            # host time of the wrapper's tile choice: one call per launch,
            # timed over the lane's conv shapes, forward and dx
            picks = [(s, dx) for s in slice_shapes(torch, (trial.filters,), bs)
                     for dx in (False, True)]
            t2 = time.perf_counter()
            for _ in range(200):
                for s, dx in picks:
                    conv.launch_tile(s, dx)
            pick_us = (time.perf_counter() - t2) * 1e6 / (200 * len(picks))
            res[backend]["tile_pick_host_us"] = pick_us
            res[backend]["tile_pick_host_ms_per_step"] = \
                pick_us * launches / steps / 1e3
        print(f"step: backend {backend}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in res[backend].items()), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("check", "lanes", "tiles", "fit",
                                     "step"))
    ap.add_argument("sweep", nargs="?", help="fit: a tiles JSON")
    ap.add_argument("--backend", action="append",
                    help="step: conv backend(s) to profile "
                         "(default: kernel and torch)")
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--shapes", help="tiles: a JSON list of {shape, act, "
                    "modes} (chip_smoke.py --shapes-json) instead of the "
                    "slice shapes")
    ap.add_argument("--tile", type=int, action="append",
                    help="check, lanes: only these tiles")
    ap.add_argument("--shape", type=int, nargs=5, action="append",
                    help="check: only these shapes (N H W C O)")
    args = ap.parse_args(argv)
    if args.mode == "fit":
        run_fit(args.sweep)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("conv_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    print(f"conv_bench {args.mode} on {card}", flush=True)
    if args.mode == "step":
        res = run_step(torch, args.out, args.backend or ["kernel", "torch"])
    else:
        from s2s_ismr_tpu_torch.kernels import _build, conv
        info = _build.build()
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "warn", "wgmma", "entry")):
                print(f"  ptxas: {line.strip()}")
        print(f"  built in {info['seconds']:.1f} s", flush=True)
        if args.mode == "check":
            res = run_check(torch, conv, args.out, args.tile,
                            [tuple(v) for v in args.shape or ()])
        elif args.mode == "lanes":
            res = run_lanes(torch, conv, args.out, tiles=args.tile)
        else:
            res = run_tiles(torch, conv, args.out,
                            read_shapes(args.shapes) if args.shapes else None)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"conv_bench_{args.mode}.json")
    with open(path, "w") as fh:
        json.dump({"card": card, "mode": args.mode, "result": res}, fh,
                  indent=1)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""On-card measurements of the conv3x3 kernel (csrc/conv3x3.cu). Needs a
CUDA card; prints its results and writes them as JSON under `--out`.

    python -m s2s_ismr_tpu_torch.kernels.conv_bench check
        every tile of the kernel's table, forward and dx mode, both acts,
        against the float64 plain version (rtol 1e-4 / atol 1e-5) at the
        slice's extreme shapes and the edge shapes, and bit-equal repeats;
    python -m s2s_ismr_tpu_torch.kernels.conv_bench lanes
        the lane mode: every tile at the slice's extreme shapes for 4 and
        20 lanes, forward and dx mode, both acts, against the float64 plain
        lane version, and every lane bit-equal to a one-lane launch of it
        with the same tile;
    python -m s2s_ismr_tpu_torch.kernels.conv_bench tiles
        device time of every tile at every slice shape (batch 16), forward
        and dx mode (ELU), beside the tile the wrapper picks;
    python -m s2s_ismr_tpu_torch.kernels.conv_bench fit TILES_JSON
        fits the constants of the wrapper's tile cost model (conv.COST) to
        a `tiles` sweep by least squares on log time, and prints them with
        the times its picks would take (runs on the CPU);
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
import re
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


def check_tile(torch, conv, shape, tile, gen):
    """The kernel with `tile` against the float64 plain version: forward
    (both acts), dx mode (dx and g', both acts); each launch twice, which
    must be bit-equal. Returns {case: max abs err} or raises."""
    x, k, b, g = inputs(torch, shape, gen)
    errs = {}
    for act in ("elu", "none"):
        want = conv.conv3x3_bias_act_plain(x.double(), k.double(),
                                           b.double(), act)
        outs = [conv._launch(x, k, b, act, tile=tile) for _ in range(2)]
        ea, ex = excess(outs[0], want)
        if ex > 0 or not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"tile {tile} fwd {act} {shape}: err {ea:.3e}"
                                 f", repeat equal {torch.equal(*outs)}")
        errs[f"fwd_{act}"] = ea
        # the dx mode reads the kernel's own f32 output as the saved output
        out = outs[0]
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


def run_check(torch, conv, out_dir):
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = slice_shapes(torch)
    # the slice's extremes: C = 1, the widest 4x4 and 8x8 layers, 32x32
    picks = [shapes[0], (16, 4, 4, 96, 96), (16, 8, 8, 96, 48),
             (16, 32, 32, 24, 12)] + list(EDGE_SHAPES)
    worst = 0.0
    for tile in range(len(conv.TILES)):
        for shape in picks:
            errs = check_tile(torch, conv, shape, tile, gen)
            worst = max(worst, *errs.values())
            print(f"  tile {tile} {conv.TILES[tile]} {shape}: " + " ".join(
                f"{k} {v:.1e}" for k, v in errs.items()), flush=True)
    torch.cuda.synchronize()
    print(f"check: {len(conv.TILES)} tiles x {len(picks)} shapes, fwd/dx/g' "
          f"x elu/none within rtol {RTOL} / atol {ATOL} of float64, repeats "
          f"bit-equal; max abs err {worst:.3e}")
    return {"max_abs_err": worst}


def run_lanes(torch, conv, out_dir, lane_counts=(4, 20)):
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = slice_shapes(torch)
    picks = [shapes[0], (16, 4, 4, 96, 96), (16, 32, 32, 24, 12),
             EDGE_SHAPES[1]]
    worst = 0.0
    for lanes in lane_counts:
        for tile in range(len(conv.TILES)):
            for shape in picks:
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
    print(f"lanes: L {lane_counts} x {len(conv.TILES)} tiles x {len(picks)} "
          f"shapes, fwd/dx/g' x elu/none within rtol {RTOL} / atol {ATOL} "
          f"of float64, every lane bit-equal to its one-lane launch; max abs "
          f"err {worst:.3e}")
    return {"max_abs_err": worst}


def gemms(shape):
    """{mode: (m, n, k, A streams)} of the main path's launches at a conv
    shape: the forward, and the dx mode of an ELU conv."""
    n, h, w, c, o = shape
    return {"fwd": (n * h * w, o, 9 * c, 1), "dx": (n * h * w, c, 9 * o, 2)}


def run_fit(path):
    """Least-squares fit of conv.COST on log time to a tiles sweep."""
    import numpy as np
    from scipy.optimize import minimize

    from s2s_ismr_tpu_torch.kernels import conv
    with open(path) as fh:
        sweep = json.load(fh)["result"]
    tiles = [tuple(t) for t in sweep["tiles"]]
    data = [(gemms(tuple(r["shape"]))[mode], t, r[mode]["us"][i])
            for r in sweep["rows"] for mode in ("fwd", "dx")
            for i, t in enumerate(tiles)]

    def loss(cost):
        if min(cost) <= 0:
            return 1e9
        return sum((np.log(conv.tile_cost(t, *g, cost=cost)) - np.log(us))
                   ** 2 for g, t, us in data)
    fit = minimize(loss, conv.COST, method="Nelder-Mead",
                   options=dict(maxiter=4000, xatol=1e-7, fatol=1e-10))
    cost = tuple(float(v) for v in fit.x)
    print(f"fit: COST = {tuple(round(v, 4) for v in cost)}, rms log error "
          f"{(fit.fun / len(data)) ** 0.5:.3f} over {len(data)} times")
    res = {"cost": cost}
    for mode in ("fwd", "dx"):
        picked = best = 0.0
        for r in sweep["rows"]:
            g, us = gemms(tuple(r["shape"]))[mode], r[mode]["us"]
            pred = [conv.tile_cost(t, *g, cost=cost) for t in tiles]
            picked += us[pred.index(min(pred))]
            best += min(us)
        print(f"fit: {mode} summed over {len(sweep['rows'])} shapes: the "
              f"fitted model's picks {picked:.2f} us, best per shape "
              f"{best:.2f} us")
        res[mode] = {"picked_us": picked, "best_us": best}
    return res


_NAME = re.compile(r"conv3x3_mma_kernel<(\d+), (\d+), (\d+), (\d+), "
                   r"(true|false)>")


def run_tiles(torch, conv, out_dir, reps=30):
    """Every tile at every slice shape, forward and dx (ELU), in one
    profiler window per shape; the kernels' names carry their tile."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device="cuda").manual_seed(1)
    one = torch.empty(1, device="cuda")
    floor = device_ms_many(torch, [lambda: one.fill_(0.0)])
    if floor is None:
        raise RuntimeError("the profiler saw no device time for the fill")
    floor = floor[0] * 1e3
    print(f"  floor: a one-element fill kernel takes {floor:.2f} us")
    rows = []
    for shape in slice_shapes(torch):
        x, k, b, g = inputs(torch, shape, gen)
        out = conv._launch(x, k, b, "elu")
        calls = []
        for t in range(len(conv.TILES)):
            calls.append(lambda t=t: conv._launch(x, k, b, "elu", tile=t))
            calls.append(lambda t=t: conv._launch_dx(g, out, k, "elu",
                                                     tile=t))
        for fn in calls:
            fn()
        torch.cuda.synchronize()
        times = {}
        for _ in range(3):      # a window may come back empty: try again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    for fn in calls:
                        fn()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                mt = _NAME.search(e.key)
                if mt:
                    tile = conv.TILES.index(
                        tuple(int(v) for v in mt.groups()[:4]))
                    mode = "dx" if mt.group(5) == "true" else "fwd"
                    times[mode, tile] = e.self_device_time_total / e.count
            if len(times) == len(calls):
                break
        n, h, w, c, o = shape
        row = {"shape": shape}
        for mode, gemm in gemms((n, h, w, c, o)).items():
            us = [times[mode, t] for t in range(len(conv.TILES))]
            picked = conv._pick_tile(*gemm)
            best = min(range(len(us)), key=us.__getitem__)
            row[mode] = {"us": us, "picked": picked, "best": best}
            print(f"  {str(shape):<22} {mode:<3} picked {picked} "
                  f"{us[picked]:6.2f} us, best {best} {us[best]:6.2f} us; "
                  + " ".join(f"{v:.2f}" for v in us), flush=True)
        rows.append(row)
    for mode in ("fwd", "dx"):
        s_pick = sum(r[mode]["us"][r[mode]["picked"]] for r in rows)
        s_best = sum(r[mode]["us"][r[mode]["best"]] for r in rows)
        print(f"tiles: {mode} summed over {len(rows)} shapes: picked "
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
            picks = [g[:3] for s in slice_shapes(torch, (trial.filters,), bs)
                     for g in gemms(s).values()]
            t2 = time.perf_counter()
            for _ in range(200):
                for g in picks:
                    conv._pick_tile(*g)
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
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas: {line.strip()}")
        print(f"  built in {info['seconds']:.1f} s", flush=True)
        res = {"check": run_check, "lanes": run_lanes,
               "tiles": run_tiles}[args.mode](torch, conv, args.out)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"conv_bench_{args.mode}.json")
    with open(path, "w") as fh:
        json.dump({"card": card, "mode": args.mode, "result": res}, fh,
                  indent=1)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Fused 3x3 conv + bias + ELU: the hand-written CUDA kernel
(csrc/conv3x3.cu) with its autograd Functions and its plain PyTorch
versions.

Port of s2s_ismr_tpu/kernels/conv.py. Layouts are the JAX ones: x NHWC
(N, H, W, C), w HWIO (3, 3, C, O), b (O,), all float32.

Backward, as the JAX custom VJP: g' = g * ELU'(out), with ELU' recovered
from the saved output (`out > 0 ? 1 : out + 1`); dx is the adjoint conv of
g' (taps rotated 180 degrees, C<->O transposed); dw (the 3x3 patches
contracted with g', one matmul) and db (sum of g') are plain torch ops, as
they were XLA ops in JAX. On a CUDA tensor dx is the kernel's dx mode: one
launch that reads the forward's taps and the saved output as they are and
also writes g'. The dx mode is a Function of its own (`Conv3x3Dx`), called
from the conv's backward. A conv whose input needs no gradient (the U-Net's
first) computes g' with torch ops.

Lane mode, the counterpart of the Pallas kernel under `jax.vmap` (batched
lanes: folds x learning rates of one sweep bucket, each with its own
weights). Both Functions work under `torch.func` transforms: `forward`
takes no ctx, `setup_context` saves what the backward needs, and a `vmap`
rule moves each batched operand's lane dim to the front, leaves a shared
operand as it is (lane stride 0 in the kernel) and makes ONE lane-mode
launch for all L lanes (forward or dx mode; the lane is the grid's z
axis). So `torch.func.vmap(torch.func.grad(loss))` issues the same number
of launches per step as one lane does. dw and db stay torch ops, which
vmap turns into batched products. Only one level of vmap is batched into
the kernel (the sweep flattens folds x learning rates into one lane axis).

Tiles: the kernel has three tile families (csrc/conv3x3.cu): gather
(an implicit GEMM, A gathered per tap), halo (a block's image rows and
their halo, at most 16-32 channels, staged once, by TMA where the staged
channel count is a multiple of 4; wgmma products, or mma.sync in the
halo_mma tiles) and split (a cluster of blocks splitting K, reduced in rank order
through distributed shared memory). `_pick_tile` takes the tile of least
modelled time (`tile_cost`, constants fitted per family by `conv_bench
fit`) among those whose preconditions hold (`applicable`). Every family is
one launch per call.

Dispatch: on a CPU tensor the inner calls are the plain versions
(`conv3x3_bias_act_plain`, `conv3x3_dx_plain`, and for lanes
`conv3x3_bias_act_lanes_plain`, `conv3x3_dx_lanes_plain`, loops over
lanes); on a CUDA tensor they are the kernel, or an exception. `LAUNCHES`
counts kernel launches (a dx launch counts one, a lane-mode launch one);
`LANE_LAUNCHES` counts those of them that ran more than one lane.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0
LANE_LAUNCHES = 0
WARMUP_LAUNCHES = 0
_COUNT = threading.Lock()   # lanes of a mesh launch from several threads
_TALLIES = {}               # stream handle -> lane counts of its launches,
# while a program warms up or captures on that stream
MAX_CHANNELS = 384
MAX_LANES = 65535           # the grid's z extent
_MAX_SIDE = 16384
MAX_PIXELS = 2_000_000      # N*H*W: the kernel's fdiv and 32-bit indices
_ACTS = ("elu", "none")

# The kernel's tile table (csrc/conv3x3.cu, kTiles): (family, BM, BN, WM,
# WN, S). gather: a BM x BN output tile per block of 4 warps, WM x WN warps
# over the tile and the remaining 4 / (WM * WN) warps splitting each K
# chunk; halo (wgmma products) and halo_mma (mma.sync products): BM GEMM
# rows per block, R = min(BM // W, H) whole image rows of one image, their
# halo box (at most halo_ck(BN) channels) staged once; split: the gather
# tile over a cluster of S blocks, each walking 1/S of the K chunks.
FAMILIES = ("gather", "halo", "halo_mma", "split")
GATHER, HALO, HALO_MMA, SPLIT = range(4)
TILES = ((0, 64, 8, 4, 1, 1), (0, 16, 8, 1, 1, 1), (0, 64, 16, 4, 1, 1),
         (0, 32, 16, 2, 1, 1), (0, 16, 16, 1, 1, 1), (0, 64, 32, 2, 2, 1),
         (0, 32, 32, 2, 1, 1), (0, 16, 32, 1, 1, 1),
         (1, 64, 8, 4, 1, 1), (1, 64, 16, 4, 1, 1), (1, 128, 8, 4, 1, 1),
         (1, 128, 16, 4, 1, 1), (1, 64, 32, 4, 1, 1),
         (2, 128, 8, 4, 1, 1), (2, 128, 16, 4, 1, 1),
         (3, 16, 32, 1, 1, 4), (3, 16, 32, 1, 1, 8))
_SMS = 132          # H100 SXM
_BK = 64            # k values per gather chunk (csrc/conv3x3.cu, kBK)
HALO_SMEM = 200 * 1024    # a halo tile's dynamic shared memory, at most
SPLIT_MAX_M, SPLIT_MIN_K = 128, 576
# per family: (fixed us, us per chunk, us per mma of a warp per chunk, us
# per MB that the A loads read, and for a halo tile us per k8 step and
# 64-row slice of A fragments, for a split tile us per cluster rank);
# fitted by `conv_bench fit` to a `conv_bench tiles` sweep of every tile
# at the 245 shapes that chip_smoke.py's phases 3, 10, 11 and 12 time
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md), each family over the
# times of the tiles it takes. The split tiles share the gather tiles' mma
# and byte rates (the same body).
COST = {GATHER: (5.6587, 0.1255, 0.0168, 0.0791),
        HALO: (4.7567, 0.7634, 0.011, 0.0189, 0.0425),
        HALO_MMA: (5.2714, 0.8052, 0.011, 0.0, 0.0332),
        SPLIT: (4.1572, 0.4016, 0.0168, 0.0791, 0.0)}


def _cdiv(a, b):
    return -(-a // b)


def halo_ck(bn):
    """Staged channels a halo tile takes, at most (csrc: halo_ck)."""
    return 16 if bn >= 32 else 32


def halo_rows(tile, h, w):
    """R: the image rows a halo tile's block owns at an H x W map."""
    return min(tile[1] // w, h)


def halo_box(tile, shape):
    """(channel stride, W + 2, R + 2, TMA) of a halo tile's staged box at
    shape (N, H, W, Cin, Cout), Cin the staged channels. TMA where Cin is
    a multiple of 4 (the kernel also needs the tensors on 16-byte
    boundaries, else it stages by cp.async): the box's channel extent is
    Cin + 4, its pad read as zeros and unused; by cp.async the stride is
    Cin made odd. Either way the taps read shared memory without bank
    conflicts."""
    _, h, w, cst, _ = shape
    tma = cst % 4 == 0
    return (cst + 4 if tma else cst | 1), w + 2, halo_rows(tile, h, w) + 2, tma


def halo_smem(tile, shape, has_o=False):
    """Dynamic shared memory bytes of a halo tile at shape (N, H, W, Cin,
    Cout) (and the saved output's box beside the input's when has_o): the
    B hi and lo tiles (BN x 9 Cin, rounded up to 8) and the (R+2) x (W+2)
    box, as the kernel sizes them."""
    cs, bw, bh, _ = halo_box(tile, shape)
    box = _cdiv(bh * bw * cs, 32) * 32
    return 128 + 4 * (2 * tile[2] * _cdiv(9 * shape[3], 8) * 8
                      + box * (2 if has_o else 1))


def applicable(tile, shape, a_streams=1):
    """Whether the kernel takes `tile` at shape (N, H, W, Cin, Cout), Cin
    the staged (reduced) channels: a halo tile needs 8 <= W <= BM, Cin <=
    halo_ck(BN) (measured: over several channel chunks a halo tile lost to
    the gather tiles at every one of the 63 shapes it could take; PERF.md)
    and its box within HALO_SMEM; a split tile M <= 128, K >= 576
    and no more ranks than K chunks (the kernel refuses the rest)."""
    fam, bm = tile[0], tile[1]
    n, h, w, cst, _ = shape
    if fam in (HALO, HALO_MMA):
        return (8 <= w <= bm and cst <= halo_ck(tile[2])
                and halo_smem(tile, shape, a_streams == 2) <= HALO_SMEM)
    if fam == SPLIT:
        k = 9 * cst
        return (n * h * w <= SPLIT_MAX_M and k >= SPLIT_MIN_K
                and tile[5] <= _cdiv(k, _BK))
    return True


def tile_cost(tile, shape, a_streams=1, cost=None, lanes=1):
    """Modelled device us of one launch with `tile` at shape (N, H, W,
    Cin, Cout), Cin the staged (reduced) channels, Cout the output's: a
    fixed part, plus the K chunks of one block, each a fixed part and its
    warps' mma (3 per m16n8k8 step), stretched by the waves of blocks past
    one per SM, plus the bytes the A loads read. A gather tile reads A
    once per tap and n tile (a_streams = 2: the dx mode of an ELU conv
    also reads the saved output); a halo tile once per staged pixel of its
    (R+2) x (W+2) box and n tile; a split tile walks 1/S of the chunks and
    pays per rank of the reduction. A lane-mode launch of `lanes` lanes
    has `lanes` times the blocks and the bytes."""
    fam, bm, bn, wm, wn, s = tile
    cost = COST[fam] if cost is None else cost
    fixed, per_chunk, per_mma, per_mb = cost[:4]
    n, h, w, cst, cout = shape
    m, k, nt = n * h * w, 9 * cst, _cdiv(cout, bn)
    if fam in (HALO, HALO_MMA):
        r = halo_rows(tile, h, w)
        chunks = 1                  # the box holds all Cin <= halo_ck(BN)
        steps = _cdiv(9 * cst, 8)
        mma = steps * (bm // 64) * (bn // 8) * 3
        row_blocks = n * _cdiv(h, r)
        blocks = row_blocks * nt * lanes
        waves = max(1.0, blocks / _SMS)
        mb = lanes * (nt * row_blocks * (r + 2) * (w + 2) * cst * a_streams
                      + m * cout) * 4 / 1e6
        # per k8 step and 64-row slice, the A fragment each thread builds
        # from the box, whatever the tile's width
        frag = cost[4] * steps * (bm // 64)
        return fixed + waves * (chunks * per_chunk + per_mma * mma + frag) \
            + per_mb * mb
    ks = 4 // (wm * wn)
    mma = _cdiv(_BK // 8, ks) * (bm // wm // 16) * (bn // wn // 8) * 3
    blocks = _cdiv(m, bm) * nt * lanes * s
    waves = max(1.0, blocks / _SMS)
    mb = lanes * (nt * m * k * a_streams + m * cout) * 4 / 1e6
    t = (fixed + waves * _cdiv(_cdiv(k, _BK), s) * (per_chunk + per_mma * mma)
         + per_mb * mb)
    if fam == SPLIT:
        t += cost[4] * s
    return t


def kernel_tiles():
    """The tile table as the built library holds it; equals TILES."""
    lib = _build.library()
    vals = [ctypes.c_int() for _ in range(6)]
    count = lib.s2s_conv3x3_tile(-1, *map(ctypes.byref, vals))
    tiles = []
    for i in range(count):
        lib.s2s_conv3x3_tile(i, *map(ctypes.byref, vals))
        tiles.append(tuple(v.value for v in vals))
    return tuple(tiles)


def kernel_chunk():
    """The K chunk of the built library; equals _BK."""
    return _build.library().s2s_conv3x3_chunk()


@functools.lru_cache(maxsize=None)
def _pick_tile(shape, a_streams=1, lanes=1):
    """The tile of the least modelled time (tile_cost) among those the
    kernel takes at shape (N, H, W, Cin, Cout), Cin the staged channels;
    ties go to the earlier tile. Cached: a model has a few shapes and
    launches each many times."""
    costs = [tile_cost(t, shape, a_streams, lanes=lanes)
             if applicable(t, shape, a_streams) else float("inf")
             for t in TILES]
    return costs.index(min(costs))


def launch_tile(shape, dx=False, elu=True, lanes=1):
    """The tile the wrapper launches for the conv of shape (N, H, W, C, O)
    (the forward's names) in the forward or the dx mode."""
    n, h, w, c, o = shape
    if dx:
        return _pick_tile((n, h, w, o, c), 2 if elu else 1, lanes)
    return _pick_tile((n, h, w, c, o), 1, lanes)


def conv3x3_bias_act_plain(x, w, b, act="elu"):
    """The same function with F.conv2d: SAME conv3x3 + bias + act."""
    # contiguous OIHW: the CPU backward refuses the permuted view when O = 1
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b, padding=1)
    y = y.permute(0, 2, 3, 1)
    return F.elu(y) if act == "elu" else y


def elu_grad(g, out):
    """g * ELU'(z), with ELU' read from the output out = elu(z)."""
    # elu'(z) = 1 for z > 0 else exp(z) = elu(z) + 1
    return g * (out.clamp(max=0.0) + 1.0)


def conv3x3_dx_plain(g, out, w, act="elu"):
    """The backward's dx mode with F.conv2d: returns (dx, g') from the
    upstream gradient g (N, H, W, O), the saved output, the forward's taps
    w (3, 3, C, O) and its act. g' = g * ELU'(out) for 'elu', g for 'none';
    dx is the SAME conv of g' with the taps rotated 180 degrees and C<->O
    transposed."""
    if act == "elu":
        g = elu_grad(g, out)
    w_adj = w.flip((0, 1)).transpose(2, 3)
    return conv3x3_bias_act_plain(g, w_adj, None, "none"), g


def _expand(t, lanes, ndim):
    """t with a leading lane dim: as it is when it has one (rank ndim + 1),
    else the one-lane operand broadcast to `lanes` lanes."""
    if t is None or t.ndim == ndim + 1:
        return t
    return t.expand((lanes,) + tuple(t.shape))


def conv3x3_bias_act_lanes_plain(x, w, b, act="elu"):
    """The lane mode with F.conv2d, lane after lane: x (L, N, H, W, C) or
    (N, H, W, C) shared, w (L, 3, 3, C, O) or shared, b (L, O), (O,) or
    None. Returns (L, N, H, W, O)."""
    lanes = next(t.shape[0] for t, d in ((x, 4), (w, 4), (b, 1))
                 if t is not None and t.ndim == d + 1)
    x, w, b = _expand(x, lanes, 4), _expand(w, lanes, 4), _expand(b, lanes, 1)
    return torch.stack([conv3x3_bias_act_plain(
        x[i], w[i], None if b is None else b[i], act) for i in range(lanes)])


def conv3x3_dx_lanes_plain(g, out, w, act="elu"):
    """The dx mode's lane mode with F.conv2d, lane after lane: g and out
    (L, N, H, W, O) or shared, w (L, 3, 3, C, O) or shared. Returns (dx
    (L, N, H, W, C), g' (L, N, H, W, O))."""
    lanes = next(t.shape[0] for t in (g, out, w)
                 if t is not None and t.ndim == 5)
    g, out, w = (_expand(t, lanes, 4) for t in (g, out, w))
    pairs = [conv3x3_dx_plain(g[i], None if out is None else out[i], w[i],
                              act) for i in range(lanes)]
    return (torch.stack([p[0] for p in pairs]),
            torch.stack([p[1] for p in pairs]))


def _check(name, t, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"conv3x3 kernel: {name} must be on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"conv3x3 kernel: {name} must be float32, "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"conv3x3 kernel: {name} must be contiguous")


def _check_sizes(n, h, wd, cin, cout, lanes=1):
    if not (1 <= cin <= MAX_CHANNELS and 1 <= cout <= MAX_CHANNELS):
        raise ValueError(f"conv3x3 kernel takes 1 <= C, O <= {MAX_CHANNELS}; "
                         f"got {cin}, {cout}")
    if h > _MAX_SIDE or wd > _MAX_SIDE:
        raise ValueError(f"conv3x3 kernel takes H, W <= {_MAX_SIDE}")
    if n * h * wd > MAX_PIXELS:
        raise ValueError(f"conv3x3 kernel takes N*H*W <= {MAX_PIXELS}")
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"conv3x3 kernel takes 1 <= lanes <= {MAX_LANES}; "
                         f"got {lanes}")


def _lane_stride(t, ndim):
    """Floats between lanes of operand t: its one-lane size when it has a
    lane dim (rank ndim + 1), 0 when every lane shares it (or it is
    None)."""
    return 0 if t is None or t.ndim == ndim else t.numel() // t.shape[0]


def _count(lanes, stream=None):
    """One more launch on `stream` (a stream handle): in the tally of a
    program warming up or capturing there, else in the counters (under a lock: the lanes of a
    mesh launch from a host thread per card, and a backward's launches come
    from autograd's device thread)."""
    global LAUNCHES, LANE_LAUNCHES
    with _COUNT:
        tally = _TALLIES.get(stream)
        if tally is not None:
            tally.append(lanes)
            return
        LAUNCHES += 1
        LANE_LAUNCHES += lanes > 1


@contextlib.contextmanager
def tally(stream):
    """Inside the block the launches on `stream` (a torch.cuda.Stream) go
    into the list this yields (each launch's lane count), not into
    LAUNCHES."""
    key = stream.cuda_stream
    launches = []
    with _COUNT:
        _TALLIES[key] = launches
    try:
        yield launches
    finally:
        with _COUNT:
            del _TALLIES[key]


def add_warmup(n):
    """n launches of a program's warm-up ran."""
    global WARMUP_LAUNCHES
    with _COUNT:
        WARMUP_LAUNCHES += n


def replayed(launches, lane_launches):
    """One replay of a graph that captured `launches` launches, of which
    `lane_launches` ran more than one lane."""
    global LAUNCHES, LANE_LAUNCHES
    with _COUNT:
        LAUNCHES += launches
        LANE_LAUNCHES += lane_launches


def _run(a, act_out, w, b, y, gp, dims, dx_mode, elu, tile, lanes=1):
    """One launch over `lanes` lanes; `dims` (N, H, W, Cin, Cout) are one
    lane's. Each operand has a lane dim, or is shared by the lanes."""
    n, h, wd, cin, cout = dims
    if tile is None:
        tile = _pick_tile((n, h, wd, cin, cout), 2 if dx_mode and elu else 1,
                          lanes)
    strides = (_lane_stride(a, 4), _lane_stride(act_out, 4),
               _lane_stride(w, 4), _lane_stride(b, 1), _lane_stride(y, 4),
               _lane_stride(gp, 4))
    lib = _build.library()
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.s2s_conv3x3_f32(
            ptr(a), ptr(act_out), ptr(w), ptr(b), ptr(y), ptr(gp),
            n, h, wd, cin, cout, int(dx_mode), int(elu), tile, lanes,
            *strides, stream)
    _count(lanes, stream)
    if rc != 0:
        msg = lib.s2s_cuda_error_string(rc).decode()
        raise RuntimeError(f"conv3x3 kernel launch failed: {msg} ({rc})")


def _lanes_of(ops, lanes):
    """The lane count of a launch: `lanes` when given, else the leading dim
    of the operands that have a lane dim (they must agree). ops: (name,
    tensor or None, one-lane rank)."""
    found = {t.shape[0] for _, t, d in ops
             if t is not None and t.ndim == d + 1}
    if lanes is not None:
        found.add(lanes)
    if len(found) != 1:
        raise ValueError(f"conv3x3 kernel: lane counts {sorted(found)} of "
                         + ", ".join(f"{name} {tuple(t.shape)}"
                                     for name, t, _ in ops if t is not None))
    return found.pop()


def _launch_lanes(x, w, b, act, lanes=None, tile=None):
    """The forward over lanes: act(conv3x3(x, w) + b) of every lane in one
    launch. x (L, N, H, W, C) or (N, H, W, C) shared, w (L, 3, 3, C, O) or
    shared, b (L, O), (O,) or None; L from the lane dims, or `lanes` when
    every operand is shared. Returns (L, N, H, W, O)."""
    lanes = _lanes_of((("x", x, 4), ("w", w, 4), ("b", b, 1)), lanes)
    n, h, wd, c = x.shape[-4:]
    o = w.shape[-1]
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t is not None:
            _check(name, t, x.device)
    if tuple(w.shape[-4:-1]) != (3, 3, c) or (
            b is not None and b.shape[-1] != o):
        raise ValueError(f"conv3x3 kernel: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b "
                         f"{None if b is None else tuple(b.shape)}")
    _check_sizes(n, h, wd, c, o, lanes)
    out = torch.empty((lanes, n, h, wd, o), dtype=torch.float32,
                      device=x.device)
    if out.numel():
        _run(x, None, w, b, out, None, (n, h, wd, c, o), False,
             act == "elu", tile, lanes)
    return out


def _launch(x, w, b, act, tile=None):
    """The forward: act(conv3x3(x, w) + b) in one launch."""
    if x.ndim != 4 or w.ndim != 4 or (b is not None and b.ndim != 1):
        raise ValueError(f"conv3x3 kernel: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, b "
                         f"{None if b is None else tuple(b.shape)}")
    return _launch_lanes(x, w, b, act, 1, tile)[0]


def _launch_dx_lanes(g, out, w, act, lanes=None, tile=None):
    """The dx mode over lanes, one launch: (dx (L, N, H, W, C), g' (L, N,
    H, W, O)) from g and the saved output (L, N, H, W, O) or shared (out
    read for 'elu') and the forward's taps w (L, 3, 3, C, O) or shared."""
    elu = act == "elu"
    out = out if elu else None
    lanes = _lanes_of((("g", g, 4), ("out", out, 4), ("w", w, 4)), lanes)
    n, h, wd, o = g.shape[-4:]
    c = w.shape[-2]
    for name, t in (("g", g), ("w", w)) + ((("out", out),) if elu else ()):
        _check(name, t, g.device)
    if tuple(w.shape[-4:]) != (3, 3, c, o) or (
            elu and tuple(out.shape[-4:]) != (n, h, wd, o)):
        raise ValueError(f"conv3x3 kernel dx: g {tuple(g.shape)}, w "
                         f"{tuple(w.shape)}, out "
                         f"{None if out is None else tuple(out.shape)}")
    _check_sizes(n, h, wd, o, c, lanes)
    dx = torch.empty((lanes, n, h, wd, c), dtype=torch.float32,
                     device=g.device)
    gp = (torch.empty((lanes, n, h, wd, o), dtype=torch.float32,
                      device=g.device) if elu else _expand(g, lanes, 4))
    if dx.numel():
        _run(g, out, w, None, dx, gp if elu else None, (n, h, wd, o, c),
             True, elu, tile, lanes)
    return dx, gp


def _launch_dx(g, out, w, act, tile=None):
    """The dx mode: (dx, g') in one launch, from g (N, H, W, O), the saved
    output (read for 'elu') and the forward's taps w (3, 3, C, O)."""
    if g.ndim != 4 or w.ndim != 4 or (act == "elu" and out.ndim != 4):
        raise ValueError(f"conv3x3 kernel dx: g {tuple(g.shape)}, w "
                         f"{tuple(w.shape)}, out "
                         f"{None if out is None else tuple(out.shape)}")
    dx, gp = _launch_dx_lanes(g, out, w, act, 1, tile)
    return dx[0], (gp[0] if act == "elu" else g)


def _device_of(t):
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"conv3x3_bias_act: no kernel for {t.device}")
    return t.device.type


def _conv_call(x, w, b, act):
    """Kernel for a CUDA tensor, plain version for a CPU tensor."""
    if _device_of(x) == "cuda":
        return _launch(x, w, b, act)
    return conv3x3_bias_act_plain(x, w, b, act)


def _dx_call(g, out, w, act):
    """(dx, g'): the kernel's dx mode for a CUDA tensor, the plain version
    for a CPU tensor."""
    if _device_of(g) == "cuda":
        return _launch_dx(g, out, w, act)
    return conv3x3_dx_plain(g, out, w, act)


def _front(t, dim):
    """A vmap rule's operand with its lane dim first (contiguous), or as it
    is (contiguous) when every lane shares it."""
    if t is None:
        return None
    return (t if dim is None else t.movedim(dim, 0)).contiguous()


class _Function(torch.autograd.Function):
    """An autograd.Function whose eager apply passes its arguments as they
    are. Function.apply binds them to forward's signature with inspect on
    every call of a Function that has setup_context, which made each conv
    and dx call ~10-25 us slower on the host (a one-lane step of 27 calls
    ~14% slower on an H100's host, PERF.md); the forwards here take
    positional arguments without defaults, so the binding changes nothing.
    Under torch.func transforms apply is Function.apply."""

    @classmethod
    def apply(cls, *args):
        if torch._C._are_functorch_transforms_active():
            return super().apply(*args)
        return super(torch.autograd.Function, cls).apply(*args)


class Conv3x3BiasAct(_Function):
    """conv3x3_bias_act with the JAX custom VJP's backward; batched into
    one lane-mode launch under torch.func.vmap."""

    @staticmethod
    def forward(x, w, b, act):
        return _conv_call(x, w, b, act)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _, act = inputs
        ctx.act = act
        ctx.save_for_backward(x, w, output)

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx, g = Conv3x3Dx.apply(g.contiguous(), out, w, ctx.act)
        elif ctx.act == "elu":
            g = elu_grad(g, out)
        if ctx.needs_input_grad[1]:
            n, h, wd, c = x.shape
            o = w.shape[3]
            # tap-major patches (N*H*W, 9*C): a strided view of the padded
            # input, one copy, then one matmul straight into HWIO order
            # (F.unfold on CUDA launches one im2col kernel per sample)
            xp = F.pad(x, (0, 0, 1, 1, 1, 1))
            taps = xp.unfold(1, 3, 1).unfold(2, 3, 1)     # (N,H,W,C,3,3)
            taps = taps.permute(0, 1, 2, 4, 5, 3).reshape(n * h * wd, 9 * c)
            dw = torch.matmul(taps.t(), g.reshape(n * h * wd, o))
            dw = dw.reshape(3, 3, c, o)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 1, 2))
        return dx, dw, db, None

    @staticmethod
    def vmap(info, in_dims, x, w, b, act):
        x, w, b = (_front(t, d) for t, d in zip((x, w, b), in_dims))
        if _device_of(x) == "cuda":
            return _launch_lanes(x, w, b, act, info.batch_size), 0
        return conv3x3_bias_act_lanes_plain(
            _expand(x, info.batch_size, 4), w, b, act), 0


class Conv3x3Dx(_Function):
    """The backward's dx mode, (dx, g') from (g, the saved output, the
    forward's taps); a Function of its own so that the conv's backward
    under torch.func.vmap batches the dx launch too. Never differentiated
    (the conv's backward is not)."""

    @staticmethod
    def forward(g, out, w, act):
        return _dx_call(g, out, w, act)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, g, out, w, act):
        g, out, w = (_front(t, d) for t, d in zip((g, out, w), in_dims))
        lanes = info.batch_size
        if _device_of(g) == "cuda":
            return _launch_dx_lanes(g, out, w, act, lanes), (0, 0)
        return conv3x3_dx_lanes_plain(_expand(g, lanes, 4), out, w, act), \
            (0, 0)


def conv3x3_bias_act(x, w, b, act="elu"):
    """Fused SAME conv3x3 + bias + activation, differentiable, and batched
    into one lane-mode launch under torch.func.vmap.

    x: (N, H, W, C) float32; w: (3, 3, C, O); b: (O,); act: 'elu' | 'none'.
    Semantics match Keras Conv2D(padding='same') followed by ELU.
    """
    if act not in _ACTS:
        raise ValueError(f"act must be one of {_ACTS}, got {act!r}")
    return Conv3x3BiasAct.apply(x, w, b, act)

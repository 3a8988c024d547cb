"""Port vs JAX: the fused conv3x3 + bias + act and its custom backward.

Mirrors tests/test_pallas_conv.py. On the CPU the port's
`conv3x3_bias_act` runs its plain inner calls (the forward and the dx mode,
`conv3x3_dx_plain`) through the same `Conv3x3BiasAct` autograd Function
that wraps the CUDA kernel on the GPU; the JAX side runs its Pallas kernel
in interpret mode. The CUDA kernel itself is checked against the plain
versions on the card by chip_smoke.py. Tolerances: forward rtol/atol 1e-5,
gradients rtol 1e-4 / atol 1e-5 (float32, another sum order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2s_ismr_tpu.kernels import conv3x3_bias_act as jax_conv
from s2s_ismr_tpu_torch.kernels import conv as tconv
from s2s_ismr_tpu_torch.pipelines import CONFIGS


def _ref_conv(x, w, b, act):
    y = jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    return jax.nn.elu(y) if act == "elu" else y


def _inputs(rng, n, h, w, c, o):
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, o)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(o,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(n, h, w, o)).astype(np.float32)
    return x, k, b, g


def _port_grads(x, k, b, g, act):
    xs, ks, bs = (torch.tensor(a, requires_grad=True) for a in (x, k, b))
    out = tconv.conv3x3_bias_act(xs, ks, bs, act)
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (xs, ks, bs)]


def _jax_grads(fn, x, k, b, g, act):
    out = fn(x, k, b, act)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a, act) * g),
                     argnums=(0, 1, 2))(x, k, b)
    return np.asarray(out), [np.asarray(a) for a in grads]


@pytest.mark.parametrize("act", ["elu", "none"])
def test_forward_matches_pallas(rng, act):
    x, k, b, _ = _inputs(rng, 3, 8, 8, 4, 5)
    out = tconv.conv3x3_bias_act(torch.tensor(x), torch.tensor(k),
                                 torch.tensor(b), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_conv(x, k, b, act)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["elu", "none"])
def test_gradients_match_pallas(rng, act):
    x, k, b, g = _inputs(rng, 2, 8, 8, 3, 4)
    _, got = _port_grads(x, k, b, g, act)
    _, want = _jax_grads(jax_conv, x, k, b, g, act)
    for name, a, e in zip(("dx", "dw", "db"), got, want):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-5, err_msg=name)


def test_bottleneck_4x4_matches_xla_reference(rng):
    """4x4 maps (the U-Net bottleneck) go through the kernel in the port;
    the JAX gate sends them to XLA, so the reference is _ref_conv."""
    x, k, b, g = _inputs(rng, 2, 4, 4, 6, 7)
    out, got = _port_grads(x, k, b, g, "elu")
    ref_out, want = _jax_grads(_ref_conv, x, k, b, g, "elu")
    np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
    for name, a, e in zip(("dx", "dw", "db"), got, want):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("act", ["elu", "none"])
def test_gradcheck_float64(act):
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(s, dtype=torch.float64, generator=gen,
                        requires_grad=True)
            for s in ((2, 3, 4, 2), (3, 3, 2, 3), (3,))]
    assert torch.autograd.gradcheck(
        lambda x, w, b: tconv.conv3x3_bias_act(x, w, b, act), args)


def test_1x1_map_matches_plain(rng):
    x, k, b, g = _inputs(rng, 2, 1, 1, 3, 2)
    out, got = _port_grads(x, k, b, g, "elu")
    ref_out, want = _jax_grads(_ref_conv, x, k, b, g, "elu")
    np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-5)


def test_non_cpu_non_cuda_tensor_raises():
    x = torch.empty(1, 4, 4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tconv.conv3x3_bias_act(x, torch.empty(3, 3, 2, 2, device="meta"),
                               torch.empty(2, device="meta"))


def test_bad_act_raises():
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError, match="act"):
        tconv.conv3x3_bias_act(x, torch.zeros(3, 3, 2, 2), torch.zeros(2),
                               "relu")


def _jax_dx_and_gp(x, k, b, g, act):
    """JAX's dx (the Pallas custom VJP) and g' = g * ELU'(out)."""
    out = np.asarray(jax_conv(x, k, b, act))
    dx = jax.grad(lambda xx: jnp.sum(jax_conv(xx, k, b, act) * g))(x)
    gp = g * np.where(out > 0, 1.0, out + 1.0) if act == "elu" else g
    return out, np.asarray(dx), gp


@pytest.mark.parametrize("act", ["elu", "none"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 3, 4), (2, 8, 8, 1, 4),
                                   (3, 4, 4, 5, 6), (2, 16, 16, 4, 1)])
def test_dx_plain_matches_pallas_vjp(rng, shape, act):
    """conv3x3_dx_plain (dx and g') against the VJP of JAX's
    conv3x3_bias_act (the Pallas kernel in interpret mode), at C = 1,
    O = 1 and a 4x4 map."""
    x, k, b, g = _inputs(rng, *shape)
    out, dx, gp = _jax_dx_and_gp(x, k, b, g, act)
    got_dx, got_gp = tconv.conv3x3_dx_plain(
        torch.tensor(g), torch.tensor(out), torch.tensor(k), act)
    np.testing.assert_allclose(got_gp.numpy(), gp, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_dx.numpy(), dx, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("act", ["elu", "none"])
def test_dx_call_on_cpu_is_the_plain_dx(rng, act):
    x, k, b, g = _inputs(rng, 2, 8, 8, 3, 4)
    out = tconv.conv3x3_bias_act(torch.tensor(x), torch.tensor(k),
                                 torch.tensor(b), act)
    got = tconv._dx_call(torch.tensor(g), out, torch.tensor(k), act)
    want = tconv.conv3x3_dx_plain(torch.tensor(g), out, torch.tensor(k), act)
    for a, e in zip(got, want):
        assert torch.equal(a, e)


def test_first_conv_backward_without_input_grad_matches_pallas(rng):
    """The U-Net's first conv: its input needs no gradient, so the backward
    skips the dx mode and takes g' from torch ops; dw and db are JAX's."""
    x, k, b, g = _inputs(rng, 2, 8, 8, 1, 4)
    ks, bs = (torch.tensor(a, requires_grad=True) for a in (k, b))
    out = tconv.conv3x3_bias_act(torch.tensor(x), ks, bs, "elu")
    (out * torch.tensor(g)).sum().backward()
    _, want = _jax_grads(jax_conv, x, k, b, g, "elu")
    np.testing.assert_allclose(ks.grad.numpy(), want[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bs.grad.numpy(), want[2], rtol=1e-4, atol=1e-5)


def test_dx_call_non_cpu_non_cuda_tensor_raises():
    g = torch.empty(1, 4, 4, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tconv._dx_call(g, g, torch.empty(3, 3, 2, 2, device="meta"), "elu")


def test_tile_rule_covers_the_slice():
    """_pick_tile returns a tile the kernel takes for every slice shape,
    forward and dx, and the channel tile never pads O = 8/12/16 by more
    than one n8 fragment."""
    shapes = [(16, 32, 32, 1, 8), (16, 32, 32, 12, 12), (16, 16, 16, 8, 16),
              (16, 4, 4, 96, 96), (16, 8, 8, 96, 48), (349, 32, 32, 1, 8),
              (349, 4, 4, 96, 96), (2, 1, 1, 3, 5), (2, 4, 4, 384, 384)]
    for shape in shapes:
        for dx in (False, True):
            t = tconv.launch_tile(shape, dx)
            assert 0 <= t < len(tconv.TILES)
            n, h, w, c, o = shape
            ks = (n, h, w, o, c) if dx else shape
            assert tconv.applicable(tconv.TILES[t], ks, 2 if dx else 1)
            bn, nn = tconv.TILES[t][2], ks[4]
            if nn <= 16:
                assert -(-nn // bn) * bn - nn < 8, (nn, bn)


def test_tile_choice_is_the_cost_models_and_cached():
    """The wrapper's tile is the least tile_cost among the tiles the
    kernel takes (first on ties), and a repeated shape is answered from
    the cache."""
    for shape, a in (((16, 32, 32, 1, 8), 1), ((16, 4, 4, 96, 96), 1),
                     ((16, 16, 16, 24, 24), 2), ((16, 1, 1, 384, 384), 1)):
        costs = [tconv.tile_cost(t, shape, a)
                 if tconv.applicable(t, shape, a) else float("inf")
                 for t in tconv.TILES]
        assert tconv._pick_tile(shape, a) == costs.index(min(costs))
        hits = tconv._pick_tile.cache_info().hits
        tconv._pick_tile(shape, a)
        assert tconv._pick_tile.cache_info().hits == hits + 1


def _source_tiles():
    """kTiles as csrc/conv3x3.cu writes it."""
    import pathlib
    import re
    src = (pathlib.Path(tconv.__file__).resolve().parent.parent / "csrc"
           / "conv3x3.cu").read_text()
    body = src[src.index("constexpr Tile kTiles[] = {"):]
    body = body[:body.index("};")]
    fams = {"k" + "".join(p.capitalize() for p in f.split("_")): i
            for i, f in enumerate(tconv.FAMILIES)}
    return tuple((fams[f],) + tuple(int(v) for v in rest.split(","))
                 for f, rest in re.findall(r"\{(k\w+),\s*([\d,\s]+)\}",
                                           body))


def test_tile_table_is_the_sources():
    """The wrapper's tile table equals kTiles in the kernel's source, and
    each family keeps its shape rules (the card-side check is phase 2)."""
    assert _source_tiles() == tconv.TILES
    for fam, bm, bn, wm, wn, s in tconv.TILES:
        assert bn in (8, 16, 32) and 4 % (wm * wn) == 0
        if fam in (tconv.HALO, tconv.HALO_MMA):
            assert bm in (64, 128) and (wm, wn, s) == (4, 1, 1)
        elif fam == tconv.SPLIT:
            assert 2 <= s <= 8
        else:
            assert s == 1


def _grid_shapes():
    """{case: [conv shapes]}: every shape conv_bench.config_shapes gives
    over the eight configs (training and eval), and phase 12's."""
    import chip_smoke
    from s2s_ismr_tpu_torch.kernels import conv_bench
    chip_smoke.bench = conv_bench
    cases = {}
    for cfg in chip_smoke.suite_configs():
        tr, ev = conv_bench.config_shapes(torch, cfg, device="cpu")
        cases[cfg.name] = tr + ev
    first, multi, stacked = chip_smoke.member_shapes(torch, device="cpu")
    cases["phase 12"] = first + multi + stacked
    return cases


@pytest.fixture(scope="module")
def grid_shapes():
    return _grid_shapes()


@pytest.mark.parametrize("case", list(CONFIGS) + ["phase 12"])
def test_picks_hold_their_preconditions(grid_shapes, case):
    """At every shape of the case, forward and dx (ELU and none), one lane
    and 20, the wrapper's tile holds its family's preconditions: a halo
    tile stages all its channels at once, and its box lies within its
    shared memory and within TMA's limits
    (boxes of at most 256 per dimension, 16-byte rows and strides) where
    it loads by TMA, which it does only where the staged channel count is
    a multiple of 4; a split tile has no more ranks than K chunks, at most
    128 rows and K >= 576; the grid's z extent (the lanes) and y extent
    within range."""
    shapes = grid_shapes[case]
    assert shapes
    for shape in shapes:
        for dx, elu in ((False, True), (True, True), (True, False)):
            for lanes in (1, 20):
                t = tconv.launch_tile(shape, dx, elu, lanes)
                tile = tconv.TILES[t]
                fam, bm, bn = tile[:3]
                n, h, w, c, o = shape
                ks = (n, h, w, o, c) if dx else shape
                cst, cout = ks[3], ks[4]
                assert tconv.applicable(tile, ks, 2 if dx and elu else 1)
                assert lanes <= tconv.MAX_LANES and -(-cout // bn) <= 65535
                if fam in (tconv.HALO, tconv.HALO_MMA):
                    cs, bw, bh, tma = tconv.halo_box(tile, ks)
                    assert 8 <= w <= bm and bh - 2 == min(bm // w, h)
                    assert cst <= tconv.halo_ck(bn)
                    assert tconv.halo_smem(tile, ks, dx and elu) \
                        <= tconv.HALO_SMEM
                    assert tma == (cst % 4 == 0)
                    if tma:
                        assert max(cs, bw, bh) <= 256 and cs * 4 % 16 == 0
                        assert cst * 4 % 16 == 0
                    else:
                        assert cs % 2 == 1
                elif fam == tconv.SPLIT:
                    assert n * h * w <= 128 and 9 * cst >= 576
                    assert tile[5] <= -(-9 * cst // tconv._BK)


def test_tile_cost_counts_staged_pixels_and_split_chunks():
    """tile_cost charges a halo tile's A bytes once per staged pixel of
    its (R+2) x (W+2) box and n tile (a gather tile's once per tap), and
    walks a split tile's K chunks divided by S, plus S ranks of the
    reduction."""
    halo = next(t for t in tconv.TILES if t[0] == tconv.HALO)
    n, h, w, c, o = shape = (16, 32, 32, 16, 8)
    r = tconv.halo_rows(halo, h, w)
    nt = -(-o // halo[2])
    for a in (1, 2):
        got = tconv.tile_cost(halo, shape, a, cost=(0, 0, 0, 1, 0))
        staged = nt * n * -(-h // r) * (r + 2) * (w + 2) * c * a
        assert got == pytest.approx((staged + n * h * w * o) * 4 / 1e6)
        gather = tconv.TILES[0]
        got = tconv.tile_cost(gather, shape, a, cost=(0, 0, 0, 1))
        taps = -(-o // gather[2]) * n * h * w * 9 * c * a
        assert got == pytest.approx((taps + n * h * w * o) * 4 / 1e6)
    split = [t for t in tconv.TILES if t[0] == tconv.SPLIT]
    assert split
    shape = (16, 1, 1, 384, 384)
    chunks = -(-9 * 384 // tconv._BK)
    for t in split:
        s = t[5]
        blocks = -(-16 // t[1]) * -(-384 // t[2]) * s
        waves = max(1.0, blocks / 132)
        got = tconv.tile_cost(t, shape, cost=(0, 1, 0, 0, 0))
        assert got == pytest.approx(waves * -(-chunks // s))
        assert tconv.tile_cost(t, shape, cost=(0, 0, 0, 0, 1)) == s


def test_bound_at_the_3xtf32_rate():
    """The bound of the kernel's own route takes FLOP at a third of the
    TF32 peak; bytes are the same, so it is never above the f32 bound."""
    from s2s_ismr_tpu_torch.kernels import conv_bench as cb
    rate = cb.PEAK_TF32_FLOPS / 3
    for shape in ((16, 4, 4, 96, 96), (16, 32, 32, 1, 8)):
        for dx in (False, True):
            f32, _ = cb.bound(shape, dx)
            tc, _ = cb.bound(shape, dx, flops=rate)
            ops, nbytes = cb.bound_parts(shape, dx, flops=rate)
            assert tc == max(ops, nbytes) <= f32
            n, h, w, c, o = shape
            assert ops == pytest.approx(2 * n * h * w * 9 * c * o / rate
                                        * 1e3)


def test_chip_smoke_names_exist():
    """Every conv.* and bench.* name chip_smoke.py calls exists, so the
    card run cannot fail on a renamed helper."""
    import pathlib
    import re

    from s2s_ismr_tpu_torch.kernels import conv_bench
    src = (pathlib.Path(__file__).resolve().parent.parent
           / "chip_smoke.py").read_text()
    for mod, obj in (("conv", tconv), ("bench", conv_bench)):
        names = set(re.findall(rf"(?<![\w/]){mod}\.(\w+)", src))
        assert names, mod
        missing = [n for n in sorted(names) if not hasattr(obj, n)]
        assert not missing, (mod, missing)


@pytest.mark.parametrize("sizes", [(1, 4, 4, 0, 8), (1, 4, 4, 8, 385),
                                   (1, 16385, 1, 8, 8),
                                   (2000, 32, 32, 1, 8)])
def test_kernel_limits_raise(sizes):
    """The wrapper raises outside the kernel's limits (channels 1..384,
    sides up to 16384, N*H*W up to 2,000,000); there is no fallback."""
    with pytest.raises(ValueError, match="conv3x3 kernel takes"):
        tconv._check_sizes(*sizes)

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
    """_pick_tile returns a valid tile for every slice shape, forward and
    dx, and the channel tile never pads O = 8/12/16 by more than one
    n8 fragment."""
    shapes = [(16, 32, 32, 1, 8), (16, 32, 32, 12, 12), (16, 16, 16, 8, 16),
              (16, 4, 4, 96, 96), (16, 8, 8, 96, 48), (349, 32, 32, 1, 8),
              (349, 4, 4, 96, 96), (2, 1, 1, 3, 5), (2, 4, 4, 384, 384)]
    for n, h, w, c, o in shapes:
        for mm, nn, kk in ((n * h * w, o, 9 * c), (n * h * w, c, 9 * o)):
            t = tconv._pick_tile(mm, nn, kk)
            assert 0 <= t < len(tconv.TILES)
            bn = tconv.TILES[t][1]
            if nn <= 16:
                assert -(-nn // bn) * bn - nn < 8, (nn, bn)


def test_tile_choice_is_the_cost_models_and_cached():
    """The wrapper's tile is the least tile_cost (first on ties), and a
    repeated shape is answered from the cache."""
    for gemm in ((16384, 8, 9), (256, 96, 864), (4096, 24, 216, 2)):
        costs = [tconv.tile_cost(t, *gemm) for t in tconv.TILES]
        assert tconv._pick_tile(*gemm) == costs.index(min(costs))
        hits = tconv._pick_tile.cache_info().hits
        tconv._pick_tile(*gemm)
        assert tconv._pick_tile.cache_info().hits == hits + 1


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

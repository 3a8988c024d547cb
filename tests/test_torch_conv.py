"""Port vs JAX: the fused conv3x3 + bias + act and its custom backward.

Mirrors tests/test_pallas_conv.py. On the CPU the port's
`conv3x3_bias_act` runs its plain inner call through the same
`Conv3x3BiasAct` autograd Function (and the same dx-by-adjoint-conv
backward) that wraps the CUDA kernel on the GPU; the JAX side runs its
Pallas kernel in interpret mode. The CUDA kernel itself is checked against
the plain version on the card by chip_smoke.py.
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

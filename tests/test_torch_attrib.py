"""Port vs JAX: GradCAM and saliency (s2s_ismr_tpu_torch/attrib.py).

Mirrors tests/test_attrib_checkpoint_realtime.py (test_gradcam_shapes_and_range,
test_gradcam_region_mask, test_saliency, test_sweep_winner_save_load): the
same numpy inputs through the JAX function and the port's, flax weights
converted by models/convert.py. GradCAM within atol 1e-5 (with and without
a region mask, and at the bottleneck's resolution); saliency for the U-Net,
cnn and mlp within rtol 1e-4 / atol 1e-6. The port's own contract: the
winner's parameters get no `.grad` and keep their `requires_grad`, the
method is picked by architecture without catching exceptions, and row
chunks change nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2s_ismr_tpu import attrib as jattrib
from s2s_ismr_tpu.models import CNN as JaxCNN
from s2s_ismr_tpu.models import MLP as JaxMLP
from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu_torch import attrib
from s2s_ismr_tpu_torch.models import CNN, MLP, UNet, UNetConfig
from s2s_ismr_tpu_torch.models.convert import from_flax, load_flax
from s2s_ismr_tpu_torch.train import engine

N, H = 3, 16


def _x(seed=0):
    return np.random.default_rng(seed).normal(
        size=(N, H, H, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    """{arch: (flax module, flax variables, port model)} of a small U-Net
    (filters 1, n_blocks 2), the cnn (num_filters 4) and the mlp."""
    x = jnp.asarray(_x())
    out = {}
    for arch, jm, factory in (
            ("unet", JaxUNet(JaxUNetConfig(filters=1, n_blocks=2)),
             lambda: UNet(UNetConfig(filters=1, n_blocks=2), 1)),
            ("cnn", JaxCNN(num_filters=4), lambda: CNN(num_filters=4)),
            ("mlp", JaxMLP(spatial_shape=(H, H)), lambda: MLP((H, H)))):
        v = jax.jit(lambda k, xx, jm=jm: jm.init(k, xx, train=False))(
            jax.random.key(0), x[:1])
        out[arch] = jm, v, load_flax(factory(), v)
    return out


def _jax_gradcam(jm, v, x, **kw):
    return np.asarray(jax.jit(lambda vv, xx: jattrib.gradcam(
        jm, vv, xx, **kw))(v, jnp.asarray(x)))


REGION = np.zeros((H, H), bool)
REGION[:8, :8] = True


@pytest.mark.parametrize("kw", [{}, {"region_mask": REGION},
                                {"upsample": False}, {"category": 0}],
                         ids=["domain", "region", "bottleneck", "below"])
def test_gradcam_matches_jax(nets, kw):
    jm, v, model = nets["unet"]
    x = _x()
    want = _jax_gradcam(jm, v, x, **kw)
    got = attrib.gradcam(model, model.state_dict(), torch.tensor(x),
                         **kw).numpy()
    side = H if kw.get("upsample", True) else H // 4
    assert got.shape == want.shape == (N, side, side)
    assert np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 1.0 + 1e-6
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("arch", ["unet", "cnn", "mlp"])
def test_saliency_matches_jax(nets, arch):
    jm, v, model = nets[arch]
    x = _x(1)
    want = np.asarray(jax.jit(lambda vv, xx: jattrib.saliency(jm, vv, xx))(
        v, jnp.asarray(x)))
    got = attrib.saliency(model, model.state_dict(), torch.tensor(x)).numpy()
    assert got.shape == (N, H, H) and (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("arch", ["unet", "cnn", "mlp"])
def test_attribution_leaves_parameters_untouched(nets, arch):
    """No parameter gets a .grad and requires_grad stays as it was, both
    for a model whose parameters require grad and for a frozen one."""
    _, _, model = nets[arch]
    x = torch.tensor(_x())
    params = list(model.parameters())
    for flag in (True, False):
        for p in params:
            p.requires_grad_(flag)
        before = [p.detach().clone() for p in params]
        attrib.attribution(model, None, x)
        assert all(p.grad is None for p in params)
        assert all(p.requires_grad is flag for p in params)
        assert all(torch.equal(a, p) for a, p in zip(before, params))
    for p in params:
        p.requires_grad_(True)


def test_attribution_routes_by_architecture(nets, monkeypatch):
    """A U-Net goes to gradcam, the cnn and mlp to saliency; the choice is
    by type, so an error inside the chosen method propagates (JAX's
    `except (KeyError, TypeError)` fallback would have swallowed it)."""
    x = torch.tensor(_x())
    for arch, fn in (("unet", attrib.gradcam), ("cnn", attrib.saliency),
                     ("mlp", attrib.saliency)):
        model = nets[arch][2]
        np.testing.assert_array_equal(
            attrib.attribution(model, None, x).numpy(),
            fn(model, None, x).numpy())

    def broken(*a, **k):
        raise KeyError("kernel failure")
    monkeypatch.setattr(attrib, "gradcam", broken)
    with pytest.raises(KeyError, match="kernel failure"):
        attrib.attribution(nets["unet"][2], None, x)
    with pytest.raises(TypeError, match="no attribution"):
        attrib.attribution(torch.nn.Linear(2, 2), None, x)


@pytest.mark.parametrize("arch", ["unet", "cnn"])
def test_row_chunks_change_nothing(nets, arch, monkeypatch):
    """In chunks of 2 rows (engine.row_chunk) the maps equal one pass."""
    model = nets[arch][2]
    x = torch.tensor(_x(2))
    whole = attrib.attribution(model, None, x)
    monkeypatch.setattr(engine, "MAX_PIXELS", 2 * H * H)
    assert engine.row_chunk(x) == 2
    np.testing.assert_allclose(attrib.attribution(model, None, x).numpy(),
                               whole.numpy(), rtol=1e-6, atol=1e-9)


def test_state_dict_of_a_saved_winner(nets):
    """gradcam on (model, variables) as load_winner returns them: the
    variables, not the model's own tensors, are what runs."""
    jm, v, _ = nets["unet"]
    x = _x()
    other = UNet(UNetConfig(filters=1, n_blocks=2), 1,
                 generator=torch.Generator().manual_seed(5))
    got = attrib.gradcam(other, from_flax(v), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, _jax_gradcam(jm, v, x), atol=1e-5)

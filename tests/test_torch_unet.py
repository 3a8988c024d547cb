"""Port vs JAX: the U-Net, with flax-initialised weights.

Mirrors tests/test_models_keras_parity.py (layer conventions, weighted
BatchNorm, transposed-conv placement for ct_kernel 2/3/5) and
test_pallas_conv.py::test_unet_backend_parity. The flax model runs with
conv_backend='pallas' (interpret mode on the CPU); its variables are
converted by s2s_ismr_tpu_torch.models.convert.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.train.losses import categorical_crossentropy as jax_ce
from s2s_ismr_tpu_torch.models import UNet, UNetConfig
from s2s_ismr_tpu_torch.models.convert import from_flax, load_flax, to_flax
from s2s_ismr_tpu_torch.train.losses import categorical_crossentropy

CT_KERNELS = [(2, 2), (3, 3), (5, 5)]
N, H = 4, 16
WEIGHTS = np.array([1.0, 0.0, 1.0, 0.0], np.float32)


def _data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, H, H, 1)).astype(np.float32)
    oh = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (N, H, H))]
    return x, oh


@pytest.fixture(scope="module", params=CT_KERNELS, ids=str)
def pair(request):
    """(flax model, flax variables, port model loaded with them)."""
    ck = request.param
    x, _ = _data()
    jm = JaxUNet(JaxUNetConfig(filters=1, n_blocks=2, ct_kernel=ck,
                               conv_backend="pallas"))
    # same variable tree as the pallas model, without tracing the kernel
    init_model = JaxUNet(JaxUNetConfig(filters=1, n_blocks=2, ct_kernel=ck))
    variables = jax.jit(lambda k, x: init_model.init(k, x, train=False))(
        jax.random.key(3), jnp.asarray(x))
    # move the running BN statistics off their init so eval mode uses them
    variables = dict(variables)
    rng = np.random.default_rng(5)
    variables["batch_stats"] = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
        .astype(np.float32), variables["batch_stats"])
    model = load_flax(UNet(UNetConfig(filters=1, n_blocks=2, ct_kernel=ck)),
                      variables)
    return jm, variables, model


def test_eval_forward(pair):
    jm, variables, model = pair
    x, _ = _data()
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    got = model(torch.tensor(x), train=False).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_train_forward_weighted_batch_stats(pair):
    jm, variables, model = pair
    x, _ = _data()
    want, mutated = jax.jit(lambda v, x, w: jm.apply(
        v, x, train=True, sample_weight=w, mutable=["batch_stats"]))(
            variables, jnp.asarray(x), jnp.asarray(WEIGHTS))
    m = load_flax(UNet(model.config), variables)
    got = m(torch.tensor(x), train=True, sample_weight=torch.tensor(WEIGHTS))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    new_stats = to_flax(m)["batch_stats"]
    leaves = jax.tree_util.tree_leaves_with_path(mutated["batch_stats"])
    assert len(leaves) == len(jax.tree.leaves(new_stats))
    for path, a in leaves:
        node = new_stats
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(a), atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_loss_gradients(pair):
    jm, variables, model = pair
    x, oh = _data()

    def loss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          jnp.asarray(x), train=True,
                          sample_weight=jnp.asarray(WEIGHTS),
                          mutable=["batch_stats"])
        return jax_ce(out, jnp.asarray(oh), jnp.asarray(WEIGHTS))

    want = from_flax({"params": jax.jit(jax.grad(loss))(variables["params"])})
    m = load_flax(UNet(model.config), variables)
    out = m(torch.tensor(x), train=True, sample_weight=torch.tensor(WEIGHTS))
    categorical_crossentropy(out, torch.tensor(oh),
                             torch.tensor(WEIGHTS)).backward()
    got = dict(m.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_converter_round_trip_exact(pair):
    _, variables, model = pair
    back = to_flax(model)
    want = jax.tree_util.tree_leaves_with_path(variables)
    assert len(want) == len(jax.tree.leaves(back))
    for path, a in want:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(a),
                                      err_msg=jax.tree_util.keystr(path))


def test_backend_parity_same_params():
    """'kernel' and 'torch' backends share one parameter tree and give the
    same output (checkpoints interchange)."""
    x, _ = _data()
    gen = torch.Generator().manual_seed(0)
    mk = UNet(UNetConfig(filters=1, n_blocks=2, conv_backend="kernel"),
              generator=gen)
    mt = UNet(UNetConfig(filters=1, n_blocks=2, conv_backend="torch"))
    assert mk.state_dict().keys() == mt.state_dict().keys()
    mt.load_state_dict(mk.state_dict())
    xt = torch.tensor(x)
    np.testing.assert_allclose(mk(xt).detach().numpy(),
                               mt(xt).detach().numpy(), rtol=1e-5, atol=1e-6)


def test_bottleneck_tap_and_intermediate():
    x, _ = _data()
    m = UNet(UNetConfig(filters=1, n_blocks=2),
             generator=torch.Generator().manual_seed(1))
    inter = {}
    xt = torch.tensor(x)
    base = m(xt, intermediates=inter)
    h = inter["bottleneck"]
    assert h.shape == (N, H // 4, H // 4, 16)
    delta = torch.zeros_like(h, requires_grad=True)
    out = m(xt, bottleneck_delta=delta)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  base.detach().numpy())
    out[..., 0].sum().backward()
    assert delta.grad is not None and torch.isfinite(delta.grad).all()

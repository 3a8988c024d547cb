"""Port vs JAX: the CNN and MLP models, Dense, he_normal and dropout.

Mirrors tests/test_models_keras_parity.py::test_cnn_and_mlp_shapes with
flax-initialised weights converted by models/convert.py: forward values
(eval, and train mode with weighted BatchNorm at dropout 0) within atol
1e-5 and the CNN's gradients within rtol 1e-4 / atol 1e-5 (float32 sum
order). Dropout cannot match flax's masks (another generator), so it is
held to its own properties; he_normal to its distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2s_ismr_tpu.models import CNN as JaxCNN
from s2s_ismr_tpu.models import MLP as JaxMLP
from s2s_ismr_tpu.train.losses import categorical_crossentropy as jax_ce
from s2s_ismr_tpu_torch.models import CNN, MLP, UNet, UNetConfig
from s2s_ismr_tpu_torch.models.convert import from_flax, load_flax, to_flax
from s2s_ismr_tpu_torch.models.layers import Dense, Dropout, he_normal_
from s2s_ismr_tpu_torch.train.losses import categorical_crossentropy

WEIGHTS = np.array([1.0, 0.0, 1.0, 1.0, 0.0], np.float32)
# the slice's batch: 16 rows, the last three padding (weight 0). Batch
# statistics over fewer rows are ill-conditioned in float32: at 3 real rows
# JAX and the port are each ~1e-4 from a float64 forward.
BATCH_WEIGHTS = (np.arange(16) < 13).astype(np.float32)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _onehot(shape, seed=1):
    rng = np.random.default_rng(seed)
    return np.eye(3, dtype=np.float32)[rng.integers(0, 3, shape)]


# ------------------------------------------------------------------- CNN
@pytest.fixture(scope="module")
def cnn_pair():
    x = _x((5, 16, 16, 2))
    jm = JaxCNN(num_filters=4)
    variables = jax.jit(lambda k, v: jm.init(k, v))(jax.random.key(2),
                                                    jnp.asarray(x))
    return x, jm, variables


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_cnn_forward_matches_jax(cnn_pair, backend):
    """f = 4 on 16x16: the kernel route (conv3x3_bias_act act='none' +
    ReLU, its plain version on the CPU) and Conv2D give JAX's output."""
    x, jm, variables = cnn_pair
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx))(
        variables, jnp.asarray(x)))
    model = load_flax(CNN(num_filters=4, in_channels=2,
                          conv_backend=backend), variables)
    got = model(torch.tensor(x)).detach().numpy()
    assert got.shape == (5, 16, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cnn_gradients_match_jax(cnn_pair):
    """The kernel route's backward (dx mode act='none', dw, db) against
    jax.grad of the flax CNN under the weighted crossentropy."""
    x, jm, variables = cnn_pair
    oh = _onehot((5, 16, 16))

    def loss(params):
        return jax_ce(jm.apply({"params": params}, jnp.asarray(x)),
                      jnp.asarray(oh), jnp.asarray(WEIGHTS))

    want = from_flax({"params": jax.jit(jax.grad(loss))(
        variables["params"])})
    model = load_flax(CNN(num_filters=4, in_channels=2), variables)
    categorical_crossentropy(model(torch.tensor(x), train=True),
                             torch.tensor(oh),
                             torch.tensor(WEIGHTS)).backward()
    got = dict(model.named_parameters())
    assert set(got) == set(want) == {
        f"{m}.conv.{p}" for m in ("conv1", "conv2", "conv3", "head")
        for p in ("kernel", "bias")}
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_cnn_backends_share_parameters():
    gen = torch.Generator().manual_seed(0)
    mk = CNN(num_filters=4, conv_backend="kernel", generator=gen)
    mt = CNN(num_filters=4, conv_backend="torch")
    assert mk.state_dict().keys() == mt.state_dict().keys()
    mt.load_state_dict(mk.state_dict())
    x = torch.tensor(_x((2, 8, 8, 1)))
    np.testing.assert_allclose(mk(x).detach().numpy(),
                               mt(x).detach().numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="conv_backend"):
        CNN(conv_backend="xla")


# ------------------------------------------------------------------- MLP
@pytest.fixture(scope="module", params=[(16, 16, 1), (8, 12, 3)], ids=str)
def mlp_pair(request):
    """(x, flax MLP at dropout 0, its variables with moved BN statistics,
    the port's MLP loaded with them); one square and one non-square grid,
    the second with three channels."""
    h, w, c = request.param
    x = _x((16, h, w, c))
    jm = JaxMLP(spatial_shape=(h, w), dropout_rate=0.0)
    variables = dict(jax.jit(lambda k, v: jm.init(k, v, train=False))(
        jax.random.key(4), jnp.asarray(x)))
    rng = np.random.default_rng(5)
    variables["batch_stats"] = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
        .astype(np.float32), variables["batch_stats"])
    model = load_flax(MLP((h, w), in_channels=c, dropout_rate=0.0),
                      variables)
    return x, jm, variables, model


def test_mlp_eval_forward_matches_jax(mlp_pair):
    """NHWC flatten, fc1/fc2 ReLU + BN (running statistics), fc_out
    reshaped to the grid, softmax."""
    x, jm, variables, model = mlp_pair
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x)))
    got = model(torch.tensor(x), train=False).detach().numpy()
    assert got.shape == x.shape[:3] + (3,)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_mlp_train_forward_matches_jax(mlp_pair):
    """Train mode at dropout 0: weighted BatchNorm batch statistics on the
    2-D activations and the running update."""
    x, jm, variables, model = mlp_pair
    want, mutated = jax.jit(lambda v, xx, w: jm.apply(
        v, xx, train=True, sample_weight=w, mutable=["batch_stats"]))(
            variables, jnp.asarray(x), jnp.asarray(BATCH_WEIGHTS))
    m = load_flax(MLP(model.spatial_shape, in_channels=x.shape[-1],
                      dropout_rate=0.0), variables)
    got = m(torch.tensor(x), train=True,
            sample_weight=torch.tensor(BATCH_WEIGHTS))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    new_stats = to_flax(m)["batch_stats"]
    for bn in ("bn1", "bn2"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                new_stats[bn][k], np.asarray(mutated["batch_stats"][bn][k]),
                atol=1e-6, err_msg=f"{bn}.{k}")


def test_mlp_parameter_names_are_flax_paths(mlp_pair):
    """fc*.dense.kernel (in, out) / bias: flax weights convert by renaming,
    and back."""
    _, _, variables, model = mlp_pair
    back = to_flax(model)
    for path, a in jax.tree_util.tree_leaves_with_path(variables):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(a))
    h, w = model.spatial_shape
    assert model.fc_out.dense.kernel.shape == (512, h * w * 3)


def test_mlp_64x64_output_layer():
    """IITM_full's 64x64 grid: fc_out is 512 x 12,288; one forward."""
    m = MLP((64, 64), generator=torch.Generator().manual_seed(0))
    assert m.fc_out.dense.kernel.shape == (512, 12288)
    y = m(torch.tensor(_x((2, 64, 64, 1))), train=False)
    assert y.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(y.sum(-1).detach().numpy(), 1.0, atol=1e-5)


# ------------------------------------------------------- he_normal, Dense
def test_he_normal_is_flax_truncated_normal():
    """flax he_normal: cut at 2 sigma0 / 0.8796 with sigma0 = sqrt(2 /
    fan_in); the empirical std is sqrt(2 / fan_in) within 2%."""
    fan_in, fan_out = 512, 1024
    t = he_normal_(torch.empty(fan_in, fan_out),
                   torch.Generator().manual_seed(0))
    s0 = np.sqrt(2.0 / fan_in)
    assert float(t.abs().max()) <= 2 * s0 / 0.87962566103423978 + 1e-7
    assert abs(float(t.std()) / s0 - 1.0) < 0.02
    assert abs(float(t.mean())) < 0.01 * s0
    # flax's own draw has the same cut and scale
    j = np.asarray(jax.nn.initializers.he_normal()(
        jax.random.key(0), (fan_in, fan_out)))
    assert np.abs(j).max() <= 2 * s0 / 0.87962566103423978 + 1e-7
    assert abs(j.std() / float(t.std()) - 1.0) < 0.02


def test_dense_is_flax_dense():
    x = _x((4, 6))
    w = _x((6, 3), seed=3)
    b = _x((3,), seed=4)
    d = Dense(6, 3)
    d.load_state_dict({"dense.kernel": torch.tensor(w),
                       "dense.bias": torch.tensor(b)})
    np.testing.assert_allclose(d(torch.tensor(x)).detach().numpy(),
                               x @ w + b, rtol=1e-6, atol=1e-6)
    g = Dense(30, 50, generator=torch.Generator().manual_seed(1))
    limit = np.sqrt(6.0 / 80)
    assert float(g.dense.kernel.detach().abs().max()) <= limit
    assert not g.dense.bias.any()


# ---------------------------------------------------------------- Dropout
P = 0.3


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_dropout_same_seed_same_mask():
    x = torch.ones(1000)
    d = Dropout(P)
    a = d(x, True, _gen(7))
    assert torch.equal(a, d(x, True, _gen(7)))
    assert not torch.equal(a, d(x, True, _gen(8)))


def test_dropout_eval_and_rate0_are_identity():
    x = torch.randn(64, generator=_gen(0))
    g = _gen(1)
    state = g.get_state()
    assert Dropout(P)(x, False, g) is x
    assert Dropout(0.0)(x, True, g) is x
    assert torch.equal(g.get_state(), state)      # nothing drawn


def test_dropout_keep_share_and_scale():
    """Kept share within 3 sigma of 1 - p on 1e5 elements; kept values
    scaled by 1 / (1 - p), dropped ones 0."""
    n = 100_000
    x = torch.rand(n, generator=_gen(2)) + 0.5
    y = Dropout(P)(x, True, _gen(3))
    kept = y != 0
    share = float(kept.float().mean())
    sigma = np.sqrt(P * (1 - P) / n)
    assert abs(share - (1 - P)) < 3 * sigma
    torch.testing.assert_close(y[kept], x[kept] / (1 - P), rtol=1e-6,
                               atol=0)


def test_dropout_draws_nothing_from_the_global_rng():
    torch.manual_seed(11)
    before = torch.get_rng_state()
    Dropout(P)(torch.ones(500), True, _gen(4))
    m = MLP((4, 4), generator=_gen(5))
    m(torch.ones(3, 4, 4, 1), train=True, dropout_generator=_gen(6))
    assert torch.equal(torch.get_rng_state(), before)


def test_dropout_refuses_no_generator_and_bad_rate():
    with pytest.raises(ValueError, match="Generator"):
        Dropout(P)(torch.ones(3), True, None)
    with pytest.raises(ValueError, match="rate"):
        Dropout(1.0)


def test_unet_dropout_after_each_conv1():
    """UNetConfig(dropout_rate>0) (unet.py:97,121): training draws one mask
    per encoder and decoder block from the given generator, eval draws
    nothing; at rate 0 training draws nothing either."""
    x = torch.tensor(_x((2, 8, 8, 1)))
    m = UNet(UNetConfig(filters=1, n_blocks=2, dropout_rate=0.5),
             generator=_gen(0))
    g = _gen(1)
    a = m(x, train=True, dropout_generator=g)
    b = m(x, train=True, dropout_generator=_gen(1))
    assert torch.equal(a, b)
    assert not torch.equal(a, m(x, train=True, dropout_generator=_gen(2)))
    state = g.get_state()
    m(x, train=False, dropout_generator=g)
    assert torch.equal(g.get_state(), state)
    m0 = UNet(UNetConfig(filters=1, n_blocks=2), generator=_gen(0))
    m0(x, train=True, dropout_generator=g)
    assert torch.equal(g.get_state(), state)
    # the dropout has no parameters: the tree is the rate-0 U-Net's
    assert m.state_dict().keys() == m0.state_dict().keys()

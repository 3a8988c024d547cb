"""The train-mode BatchNorm kernels (s2s_ismr_tpu_torch/kernels/batchnorm.py,
csrc/batchnorm.cu) and the layer's dispatch.

On the CPU: the layer's train and eval forwards, running update and
gradients bit-equal to the formula the layer computed before the kernels
(`_layer_formula`, kept verbatim), padded rows and an all-zero batch
included; the plain path on a CPU tensor, inside `functional_batchnorm`
and in eval mode; the kernel's closed-form backward (`_grad_closed_form`,
its arithmetic in float64 tensor ops) against autograd; the launch
counter's tallies; the shapes phase 16 of chip_smoke.py checks against
the U-Nets' and the MLP's, and its grid against the eight configs'.

On the card (marker `cuda`, skipped without one): the kernel's error
against the float64 plain version at most twice the float32 plain
version's at every BatchNorm shape of ecmwf_com_32, iitm_full_64, the
eight configs' grids and the MLP, repeats bit-equal, and a U-Net training
step captured in a CUDA graph: two launches per BatchNorm counted at
capture, the replay bit-equal to the eager step. Run them there with
`python -m pytest --noconftest -m cuda tests/test_torch_batchnorm.py`
(the conftest hides the card).
"""

import types

import pytest
import torch

import chip_smoke
from s2s_ismr_tpu_torch.kernels import batchnorm as bn
from s2s_ismr_tpu_torch.models import MLP, UNet, UNetConfig
from s2s_ismr_tpu_torch.models.layers import BatchNorm, functional_batchnorm

# (shape, weights): a U-Net map with its padded rows, an all-padding batch,
# an MLP batch whose fractional weights sum below 1 (tot clamped to 1),
# and no weights at all
CASES = {
    "map_padded": ((6, 8, 8, 8), [1.0, 1.0, 1.0, 1.0, 0.0, 0.0]),
    "map_zero": ((4, 4, 4, 16), [0.0] * 4),
    "mlp_fraction": ((5, 32), [0.1, 0.05, 0.0, 0.2, 0.1]),
    "mlp_none": ((7, 24), None),
}


def _layer_formula(layer, x, train, sample_weight=None):
    """BatchNorm.forward as the layer computed it before the kernels, with
    its in-place running update (outside functional_batchnorm)."""
    if train:
        if sample_weight is None:
            sample_weight = x.new_ones(x.shape[0])
        axes = tuple(range(x.ndim - 1))
        w = sample_weight.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
        per_sample = x.numel() // x.shape[0] // x.shape[-1]
        tot = torch.clamp(w.sum() * per_sample, min=1.0)
        mean = (x * w).sum(axes) / tot
        var = (w * (x - mean) ** 2).sum(axes) / tot
        with torch.no_grad():
            m, has_data = 0.99, w.sum() > 0
            new_mean = torch.where(
                has_data, m * layer.mean + (1 - m) * mean, layer.mean)
            new_var = torch.where(
                has_data, m * layer.var + (1 - m) * var, layer.var)
            layer.mean.copy_(new_mean)
            layer.var.copy_(new_var)
    else:
        mean, var = layer.mean, layer.var
    inv = torch.rsqrt(var + 1e-3)
    return (x - mean) * inv * layer.scale + layer.bias


def _case(name, dtype=torch.float32, seed=0):
    shape, w = CASES[name]
    gen = torch.Generator().manual_seed(seed)
    x = (2.0 * torch.randn(shape, generator=gen) + 0.5).to(dtype)
    g = torch.randn(shape, generator=gen).to(dtype)
    w = None if w is None else torch.tensor(w, dtype=dtype)
    return x, g, w


def _layer(c, seed=1):
    gen = torch.Generator().manual_seed(seed)
    layer = BatchNorm(c)
    with torch.no_grad():
        layer.scale.copy_(0.5 + torch.rand(c, generator=gen))
        layer.bias.copy_(0.1 * torch.randn(c, generator=gen))
        layer.mean.copy_(0.1 * torch.randn(c, generator=gen))
        layer.var.copy_(0.5 + torch.rand(c, generator=gen))
    return layer


def _train(fn, layer, x, g, w):
    """(y, running mean, running var, dx, dscale, dbias) of fn(layer, x)."""
    xs = x.clone().requires_grad_()
    y = fn(layer, xs, True, w)
    dx, ds, db = torch.autograd.grad(y, (xs, layer.scale, layer.bias), g)
    return y.detach(), layer.mean.clone(), layer.var.clone(), dx, ds, db


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_train_bit_equal_to_formula(name):
    x, g, w = _case(name)
    want = _train(_layer_formula, _layer(x.shape[-1]), x, g, w)
    got = _train(lambda m, v, t, sw: m(v, train=t, sample_weight=sw),
                 _layer(x.shape[-1]), x, g, w)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_eval_bit_equal_to_formula(name):
    x, _, _ = _case(name)
    layer = _layer(x.shape[-1])
    assert torch.equal(layer(x, train=False), _layer_formula(layer, x, False))


def test_functional_batchnorm_records_the_update():
    x, g, w = _case("map_padded")
    want = _train(_layer_formula, _layer(x.shape[-1]), x, g, w)
    model = torch.nn.Sequential()
    model.add_module("bn", _layer(x.shape[-1]))
    before = (model.bn.mean.clone(), model.bn.var.clone())
    with functional_batchnorm(model) as updates:
        y = model.bn(x, train=True, sample_weight=w)
    assert torch.equal(y, want[0])
    assert torch.equal(updates["bn.mean"], want[1])
    assert torch.equal(updates["bn.var"], want[2])
    assert torch.equal(model.bn.mean, before[0])
    assert torch.equal(model.bn.var, before[1])


def test_plain_paths_launch_no_kernel(monkeypatch):
    """A CPU tensor, functional_batchnorm and eval mode never reach the
    kernels' Function."""
    def refuse(*args):
        raise AssertionError("the kernel path was taken")

    monkeypatch.setattr(bn.BatchNormTrain, "apply", refuse)
    launches = bn.LAUNCHES
    x, _, w = _case("map_padded")
    model = torch.nn.Sequential()
    model.add_module("bn", _layer(x.shape[-1]))
    model.bn(x, train=True, sample_weight=w)
    with functional_batchnorm(model):
        model.bn(x, train=True, sample_weight=w)
    model.bn(x, train=False)
    assert bn.LAUNCHES == launches


def test_kernel_applies_on_cuda_outside_transforms():
    assert bn.kernel_applies(torch.device("cuda"))
    assert bn.kernel_applies("cuda:0")
    assert not bn.kernel_applies(torch.device("cpu"))


def test_launches_tally_and_replay_as_conv_does():
    """A launch on a stream with an open tally goes into the tally, not
    LAUNCHES; elsewhere into LAUNCHES; a replay adds what was captured, a
    warm-up into WARMUP_LAUNCHES."""
    capture = types.SimpleNamespace(cuda_stream=7001)
    launches, warm = bn.LAUNCHES, bn.WARMUP_LAUNCHES
    with bn.tally(capture) as cap:
        bn._count(7001)
        bn._count(7001)
        bn._count(7002)
    assert cap == [1, 1] and bn.LAUNCHES == launches + 1
    bn._count(7001)
    assert bn.LAUNCHES == launches + 2
    bn.replayed(len(cap))
    bn.add_warmup(3)
    assert bn.LAUNCHES == launches + 4 and bn.WARMUP_LAUNCHES == warm + 3


def _grad_closed_form(g, x, w, mean, inv, scale):
    """(dx, dscale, dbias) of the train-mode forward in closed form, the
    backward kernel's arithmetic as tensor ops: x, g (rows, C), w (N,),
    the forward's mean and inv = rsqrt(var + eps), scale (C,). With
    A = sum(g), B = sum(g xhat), k1 = inv * scale and W = sum(w) *
    per_sample: dx = k1 g - (w / tot) (k1 B xhat + k1 A - K3), K3 =
    inv^2 scale B mean (tot - W) / tot (the mean's path through the
    variance, 0 unless the clamp holds tot above W)."""
    c = x.shape[-1]
    x, g = x.reshape(-1, c), g.reshape(-1, c)
    per_sample = x.shape[0] // w.shape[0]
    wr = w.to(x.dtype).repeat_interleave(per_sample)[:, None]
    wtot = w.to(x.dtype).sum() * per_sample
    tot = torch.clamp(wtot, min=1.0)
    xhat = (x - mean) * inv
    a = g.sum(0)
    b = inv * ((g * x).sum(0) - mean * a)       # = sum(g xhat)
    k1 = inv * scale
    k3 = inv * inv * scale * b * mean * (tot - wtot) / tot
    dx = k1 * g - wr * ((k1 * b / tot) * xhat + (k1 * a - k3) / tot)
    return dx, b, a


@pytest.mark.parametrize("name", sorted(CASES))
def test_closed_form_backward_matches_autograd_float64(name):
    """_grad_closed_form, the backward kernel's arithmetic, against
    autograd through the plain forward, in float64."""
    x, g, w = _case(name, torch.float64)
    if w is None:
        w = torch.ones(x.shape[0], dtype=torch.float64)
    c = x.shape[-1]
    scale = (0.5 + torch.rand(c, dtype=torch.float64)).requires_grad_()
    bias = torch.randn(c, dtype=torch.float64).requires_grad_()
    xs = x.clone().requires_grad_()
    y = bn.batchnorm_train_plain(xs, w, scale, bias,
                                 torch.zeros(c, dtype=torch.float64),
                                 torch.ones(c, dtype=torch.float64))
    want = torch.autograd.grad(y, (xs, scale, bias), g)
    axes = tuple(range(x.ndim - 1))
    wb = w.reshape((-1,) + (1,) * (x.ndim - 1))
    tot = torch.clamp(w.sum() * (x.numel() // x.shape[0] // c), min=1.0)
    mean = (x * wb).sum(axes) / tot
    inv = torch.rsqrt((wb * (x - mean) ** 2).sum(axes) / tot + 1e-3)
    dx, ds, db = _grad_closed_form(g, x, w, mean, inv, scale.detach())
    torch.testing.assert_close(dx.reshape(x.shape), want[0], rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(ds, want[1], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, want[2], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kw, error", [
    (dict(c=bn.MAX_CHANNELS + 1), ValueError),
    (dict(n_w=3), ValueError),
    (dict(save_dtype=torch.float32), TypeError),
    (dict(x_dtype=torch.float64), TypeError)])
def test_launch_refuses_what_the_kernel_does_not_take(kw, error):
    c, n = kw.get("c", 8), 4
    x = torch.zeros((n, 2, 2, c), dtype=kw.get("x_dtype", torch.float32))
    p = torch.zeros(c)
    w = torch.ones(kw.get("n_w", n))
    save = torch.zeros(c, dtype=kw.get("save_dtype", torch.float64))
    with pytest.raises(error):
        bn._run(False, x, None, w, p, p, torch.empty_like(x), p, p, save,
                save, None, None)


def _hooked_shapes(model, x, **kw):
    shapes = []
    hooks = [m.register_forward_hook(
        lambda m, args, out: shapes.append(tuple(args[0].shape)))
        for m in model.modules() if isinstance(m, BatchNorm)]
    model(x, train=True, **kw)
    for h in hooks:
        h.remove()
    return shapes


@pytest.mark.parametrize("name, n_blocks, filters, side",
                         chip_smoke.BN_UNETS)
def test_bn_shapes_are_the_unets(name, n_blocks, filters, side):
    cfg = UNetConfig(filters=filters, n_blocks=n_blocks,
                     conv_backend="torch")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, side, side, 1)
    assert (_hooked_shapes(model, x, sample_weight=torch.ones(2))
            == chip_smoke.bn_shapes(n_blocks, filters, side, batch=2))
    assert len(chip_smoke.bn_main_shapes()[name]) == 2 * n_blocks


@pytest.mark.parametrize("n_blocks, filters, side", sorted(
    {t[:3] for t in chip_smoke.bn_grid()}))
def test_bn_grid_shapes_are_the_unets(n_blocks, filters, side):
    cfg = UNetConfig(filters=filters, n_blocks=n_blocks,
                     conv_backend="torch")
    model = UNet(cfg, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, side, side, 1)
    assert (_hooked_shapes(model, x, sample_weight=torch.ones(2))
            == chip_smoke.bn_shapes(n_blocks, filters, side, batch=2))


def test_bn_grid_is_the_configs_grids():
    """chip_smoke.bn_grid() against each config's trials and its synthetic
    grid's side (the padded one); every shape of it among those phase 16
    checks."""
    from s2s_ismr_tpu_torch.pipelines import CONFIGS
    from s2s_ismr_tpu_torch.pipelines.tune import (_apply_pad, load_bundles,
                                                   resolve_batch_sizes)
    from s2s_ismr_tpu_torch.train.sweep import enumerate_trials
    want = set()
    for cfg in CONFIGS.values():
        b = _apply_pad(cfg, load_bundles(cfg)[cfg.models[0]])
        n, h, w, _ = b.predictor_images(cfg.predictor, shape_only=True)
        assert h == w
        want |= {(t.n_blocks, t.filters, h, t.batch_size) for t in
                 enumerate_trials(resolve_batch_sizes(cfg.tuning, n))}
    grid = chip_smoke.bn_grid()
    assert len(grid) == len(set(grid)) and set(grid) == want
    checked = set(chip_smoke.bn_check_shapes())
    assert all(set(chip_smoke.bn_shapes(*t)) <= checked for t in grid)
    assert {(32, 3, 3, 96), (32, 32, 32, 12), (16, 2, 2, 192)} <= checked


def test_bn_shapes_are_the_mlps():
    model = MLP((8, 8), dropout_rate=0.0,
                generator=torch.Generator().manual_seed(0))
    assert (_hooked_shapes(model, torch.randn(3, 8, 8, 1))
            == [(3, w) for w in chip_smoke.MLP_WIDTHS])


# ---- on the card

@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with --noconftest on the card)")
    for flag, value in (("allow_tf32", False), ("deterministic", True)):
        monkeypatch.setattr(torch.backends.cudnn, flag, value)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", chip_smoke.bn_check_shapes())
@pytest.mark.parametrize("case", ["padded", "zero"])
def test_kernel_within_twice_the_plain_error(cuda, shape, case):
    errs, got, again = chip_smoke.bn_errors(torch, shape, case)
    for name, (k, p) in errs.items():
        assert k <= 2 * p, (name, k, p)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["unet", "mlp"])
def test_step_in_a_cuda_graph(cuda, arch):
    """One training step (forward, loss, gradients) captured in a CUDA
    graph: two kernel launches per BatchNorm counted at capture and none at
    replay; the replay's loss, gradients and running statistics bit-equal
    to the eager step's from the same state."""
    gen = torch.Generator().manual_seed(0)
    model = (UNet(UNetConfig(), generator=gen) if arch == "unet"
             else MLP((32, 32), dropout_rate=0.0, generator=gen)).to(cuda)
    x = torch.randn(16, 32, 32, 1, generator=gen).to(cuda)
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    w = (torch.arange(16, device=cuda) < 13).float()
    params = list(model.parameters())
    buffers = list(model.buffers())
    start = [b.clone() for b in buffers]

    def step():
        loss = (model(x, train=True, sample_weight=w) ** 2).mean()
        return (loss.detach(), *torch.autograd.grad(loss, params))

    def reset():
        with torch.no_grad():
            for b, s in zip(buffers, start):
                b.copy_(s)

    eager = [t.clone() for t in step()] + [b.clone() for b in buffers]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = bn.LAUNCHES
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = step()
    assert bn.LAUNCHES - launches == 2 * n_bn
    reset()
    graph.replay()
    torch.cuda.synchronize()
    assert bn.LAUNCHES - launches == 2 * n_bn
    for a, b in zip(list(out) + buffers, eager):
        assert torch.equal(a, b)

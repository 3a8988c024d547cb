"""Port vs JAX: compute_dtype='bfloat16' (JAX's mixed precision).

Mirrors tests/test_models_keras_parity.py::test_bf16_compute_close_to_f32
and the dtype rules of s2s_ismr_tpu/models/layers.py:36-77 and
unet.py:76-89: under the 'torch' backend (JAX's XLA convs) every 3x3 conv
and transposed conv computes in bf16 and returns float32; under 'kernel'
(JAX's 'pallas') the fused convs stay float32 and only the transposed
convs compute in bf16; parameters, BatchNorm and the head stay float32.

Tolerances: the port's bf16 forward against JAX's bf16 forward with the
same converted weights within 5e-4 (both round the same operands to bf16;
they differ in where the conv sums round, measured 1.3e-4 on the CPU);
against the port's float32 forward within 0.03, the JAX test's tolerance.
A bf16 sweep's first-epoch val loss within 2e-2 of the float32 sweep's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu_torch import timeutils
from s2s_ismr_tpu_torch.data import synthetic
from s2s_ismr_tpu_torch.models import UNet, UNetConfig
from s2s_ismr_tpu_torch.models.convert import load_flax
from s2s_ismr_tpu_torch.models.layers import (Conv2D, Conv2DTranspose,
                                              FusedConv3x3)
from s2s_ismr_tpu_torch.ops import terciles
from s2s_ismr_tpu_torch.train import splits
from s2s_ismr_tpu_torch.train.sweep import TuningGrid, run_unet_sweep

JAX_BACKEND = {"torch": "xla", "kernel": "pallas"}


def _x():
    # 32x32: with n_blocks 2 every map is at least 8 wide, so JAX's Pallas
    # path runs all 3x3 convs in its kernel (its shape gate sends narrower
    # maps to XLA's conv, in bf16; the port has no gate)
    return np.random.default_rng(0).normal(size=(2, 32, 32, 1)).astype(
        np.float32)


@pytest.fixture(scope="module")
def flax_variables():
    """flax variables of the f32 U-Net (filters 2, n_blocks 2, ct 3x3),
    with running BN statistics off their init."""
    jm = JaxUNet(JaxUNetConfig(filters=2, n_blocks=2))
    v = dict(jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.key(0), jnp.asarray(_x())))
    rng = np.random.default_rng(5)
    v["batch_stats"] = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
        .astype(np.float32), v["batch_stats"])
    return v


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_bf16_forward_matches_jax(flax_variables, backend):
    """Eval forward of the bf16 U-Net, the same converted weights on both
    sides, under the matching backends (JAX's Pallas path in interpret
    mode on the CPU)."""
    jm = JaxUNet(JaxUNetConfig(filters=2, n_blocks=2,
                               compute_dtype="bfloat16",
                               conv_backend=JAX_BACKEND[backend]))
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        flax_variables, jnp.asarray(_x())))
    model = load_flax(UNet(UNetConfig(filters=2, n_blocks=2,
                                      compute_dtype="bfloat16",
                                      conv_backend=backend)),
                      flax_variables)
    with torch.no_grad():
        got = model(torch.tensor(_x()))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_bf16_compute_close_to_f32(flax_variables, backend):
    """compute_dtype='bfloat16' keeps float32 parameters and outputs and
    stays close to the float32 forward; 'auto' is float32, as JAX's off a
    TPU."""
    x = torch.tensor(_x())
    outs = {}
    for dt in ("float32", "bfloat16", "auto"):
        m = load_flax(UNet(UNetConfig(filters=2, n_blocks=2, compute_dtype=dt,
                                      conv_backend=backend)), flax_variables)
        assert all(p.dtype == torch.float32 for p in m.parameters())
        with torch.no_grad():
            outs[dt] = m(x)
    assert torch.equal(outs["auto"], outs["float32"])
    assert outs["bfloat16"].dtype == torch.float32
    assert not torch.equal(outs["bfloat16"], outs["float32"])
    np.testing.assert_allclose(outs["bfloat16"].numpy(),
                               outs["float32"].numpy(), atol=0.03)
    np.testing.assert_allclose(outs["bfloat16"].sum(-1).numpy(), 1.0,
                               atol=1e-3)


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_bf16_dtype_rules(backend):
    """Which layers compute in bf16: every transposed conv; the 3x3 convs
    only under 'torch'; never the fused kernel convs or the head."""
    m = UNet(UNetConfig(filters=1, n_blocks=2, compute_dtype="bfloat16",
                        conv_backend=backend),
             generator=torch.Generator().manual_seed(0))
    convs = [mod for name, mod in m.named_modules()
             if isinstance(mod, Conv2D) and name != "head"]
    assert all(mod.dtype == torch.bfloat16 for mod in convs)
    assert len(convs) == (10 if backend == "torch" else 0)
    assert all(isinstance(getattr(m, f"down{k}_conv1"),
                          FusedConv3x3 if backend == "kernel" else Conv2D)
               for k in (1, 2))
    ct = [mod for mod in m.modules() if isinstance(mod, Conv2DTranspose)]
    assert len(ct) == 2 and all(c.dtype == torch.bfloat16 for c in ct)
    assert m.head.dtype is None


def test_compute_dtype_refuses_unknown_values():
    with pytest.raises(ValueError, match="compute_dtype"):
        UNet(UNetConfig(compute_dtype="float16"))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_bf16_sweep_trains(backend):
    """A one-epoch sweep in bf16 trains to finite val losses within 2e-2
    of the float32 sweep's (the same lanes, the same batch orders)."""
    b = synthetic.synthetic_hindcast(years=(2003, 2012), seed=2, signal=0.8,
                                     grid_shape=(16, 16)).fillna(0.0)
    fm = splits.bootstrap_masks(b.years, n_bootstraps=2)
    wm = timeutils.week_window_matrix(1)
    y = torch.stack([torch.nan_to_num(terciles.one_hot_labels(
        terciles.fit_and_label(torch.as_tensor(b.y), b.weeks, fm.train[f],
                               wm, None)[0]), nan=0.0) for f in range(2)])
    grid = TuningGrid(n_blocks=[2], n_filters=[1], ct_kernels=[(2, 2)],
                      batch_sizes=[16], learning_rates=[1e-3], patience=2)
    tables = {dt: run_unet_sweep(
        b.ensemble_mean()[..., None], y, fm.train, fm.val, grid, epochs=1,
        device="cpu", conv_backend=backend,
        compute_dtype=dt).val_loss_table for dt in ("float32", "bfloat16")}
    assert np.isfinite(tables["bfloat16"]).all()
    np.testing.assert_allclose(tables["bfloat16"], tables["float32"],
                               atol=2e-2)

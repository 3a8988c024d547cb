"""Port vs JAX: batched lanes (the sweep's lane_dispatch='vmap').

Mirrors tests/test_pallas_conv.py::test_vmap_lane_axis (the kernel batched
over lanes, each lane with its own weights), tests/test_sweep_serial.py::
test_serial_matches_vmap (the vmapped sweep against JAX's, here with JAX's
init and batch orders injected through `lane_overrides`, and against the
port's serial sweep) and test_sweep_serial.py::test_serial_rejects_mesh.

Tolerances: the lane Functions under vmap(grad) run the same plain float32
ops per lane as the per-lane loop, within 1e-6. train_lanes against L
train_fold runs: within 2e-4 (the JAX test's own serial-vs-vmap tolerance;
measured here to ~1e-6, batched products sum in another order). The port's
vmap sweep against JAX's vmap sweep: val tables within 2e-4, the same
winners, winner predictions within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.ops import terciles as jterciles
from s2s_ismr_tpu.train import sweep as jsweep
from s2s_ismr_tpu_torch import timeutils
from s2s_ismr_tpu_torch.data import synthetic
from s2s_ismr_tpu_torch.kernels import conv
from s2s_ismr_tpu_torch.models import UNet, UNetConfig
from s2s_ismr_tpu_torch.models.convert import from_flax
from s2s_ismr_tpu_torch.parallel import mesh as pmesh
from s2s_ismr_tpu_torch.train import engine, splits
from s2s_ismr_tpu_torch.train import sweep as tsweep

SEED, EPOCHS = 42, 3


@pytest.fixture(scope="module")
def data():
    """x (T, 8, 8, 1), per-fold one-hot labels and two folds of a ten-year
    synthetic bundle on an 8x8 grid."""
    b = synthetic.synthetic_hindcast(years=(2003, 2012), seed=13, signal=0.8,
                                     grid_shape=(8, 8)).fillna(0.0)
    fm = splits.bootstrap_masks(b.years, n_bootstraps=2)
    wm = timeutils.week_window_matrix(1)
    y_oh = np.stack([np.nan_to_num(np.asarray(jterciles.one_hot_labels(
        jterciles.fit_and_label(b.y, b.weeks, fm.train[f], wm, None)[0])),
        nan=0.0) for f in range(fm.n_folds)]).astype(np.float32)
    x = b.ensemble_mean()[..., None].astype(np.float32)
    return x, y_oh, fm


def jax_epoch_perms(key, epochs, T):
    """engine.py:108, 164-168, 193: the per-epoch permutations."""
    key, _ = jax.random.split(key)
    perms = []
    for ekey in jax.random.split(key, epochs):
        ekey, _ = jax.random.split(ekey)
        perms.append(np.asarray(jax.random.permutation(ekey, T)))
    return np.stack(perms).astype(np.int64)


def jax_lanes(jmodel, x):
    """lane_overrides(fold, trial) -> (the flax init JAX's lane draws,
    converted; its batch orders) from _lane_keys(SEED, fold, trial)."""
    init = jax.jit(lambda k, v: jmodel.init(k, v, train=False))

    def overrides(f, ti):
        key = jsweep._lane_keys(SEED, f, ti)
        _, init_key = jax.random.split(key)
        return (from_flax(init(init_key, jnp.asarray(x[:1]))),
                jax_epoch_perms(key, EPOCHS, x.shape[0]))
    return overrides


def _counting(monkeypatch):
    calls = {"fwd": 0, "dx": 0}
    for cls, key in ((conv.Conv3x3BiasAct, "fwd"), (conv.Conv3x3Dx, "dx")):
        rule = cls.vmap

        def counted(*a, rule=rule, key=key):
            calls[key] += 1
            return rule(*a)
        monkeypatch.setattr(cls, "vmap", staticmethod(counted))
    return calls


@pytest.mark.parametrize("shared_x", [False, True], ids=["lane_x", "shared_x"])
@pytest.mark.parametrize("act", ["elu", "none"])
def test_lane_functions_under_vmap_grad_match_lane_loop(monkeypatch, act,
                                                        shared_x):
    """vmap(grad) through two convs: every lane's loss and gradients equal
    the existing Function's, lane by lane, and each vmap rule runs once per
    conv for all lanes, not once per lane."""
    rng = np.random.default_rng(3)
    L, N, H, C, O = 3, 2, 8, 3, 5
    t = lambda *s, sc=1.0: torch.tensor(
        (sc * rng.normal(size=s)).astype(np.float32))
    x = t(N, H, H, C) if shared_x else t(L, N, H, H, C)
    params = (t(L, 3, 3, C, O, sc=0.3), t(L, O, sc=0.1),
              t(L, 3, 3, O, O, sc=0.3), t(L, O, sc=0.1))

    def loss(p, xv):
        h = conv.conv3x3_bias_act(xv, p[0], p[1], act)
        h = conv.conv3x3_bias_act(h, p[2], p[3], act)
        return (h ** 2).mean()

    calls = _counting(monkeypatch)
    grads, vals = torch.func.vmap(torch.func.grad_and_value(loss), in_dims=(
        0, None if shared_x else 0))(params, x)
    assert calls == {"fwd": 2, "dx": 1}
    for i in range(L):
        p = [q[i].clone().requires_grad_() for q in params]
        want = loss(p, x if shared_x else x[i])
        gw = torch.autograd.grad(want, p)
        np.testing.assert_allclose(vals[i].item(), want.item(), atol=1e-6)
        for got, w in zip(grads, gw):
            np.testing.assert_allclose(got[i].numpy(), w.numpy(), atol=1e-6)


def test_lane_plain_versions_are_lane_loops():
    """conv3x3_bias_act_lanes_plain / conv3x3_dx_lanes_plain equal the
    one-lane plain versions lane by lane, shared operands broadcast."""
    rng = np.random.default_rng(4)
    L, N, H, C, O = 4, 2, 4, 3, 2
    x = torch.tensor(rng.normal(size=(N, H, H, C)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(L, 3, 3, C, O)).astype(np.float32))
    b = torch.tensor(rng.normal(size=(O,)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(L, N, H, H, O)).astype(np.float32))
    out = conv.conv3x3_bias_act_lanes_plain(x, w, b, "elu")
    dx, gp = conv.conv3x3_dx_lanes_plain(g, out, w, "elu")
    assert out.shape == (L, N, H, H, O) and dx.shape == (L, N, H, H, C)
    for i in range(L):
        o = conv.conv3x3_bias_act_plain(x, w[i], b, "elu")
        torch.testing.assert_close(out[i], o, rtol=0, atol=0)
        d, p = conv.conv3x3_dx_plain(g[i], o, w[i], "elu")
        torch.testing.assert_close(dx[i], d, rtol=0, atol=0)
        torch.testing.assert_close(gp[i], p, rtol=0, atol=0)


def test_lane_launcher_checks_its_operands():
    """The lane-mode wrapper refuses what the kernel does not take: CPU
    tensors, and operands whose lane counts disagree."""
    x = torch.zeros(2, 1, 4, 4, 3)
    w = torch.zeros(3, 3, 3, 3, 5)
    with pytest.raises(ValueError, match="lane counts"):
        conv._launch_lanes(x, w, None, "elu")
    with pytest.raises(ValueError, match="must be on"):
        conv._launch_lanes(x, w[:2], None, "elu")
    with pytest.raises(ValueError, match="lane counts"):
        conv._launch_dx_lanes(torch.zeros(2, 1, 4, 4, 5), None, w, "none")


def test_tile_cost_of_a_lane_launch():
    """One lane is the model as fitted; L lanes have L times the blocks
    and the bytes, so the modelled time never falls with L."""
    for tile in conv.TILES:
        assert conv.tile_cost(tile, 16384, 8, 9, lanes=1) == \
            conv.tile_cost(tile, 16384, 8, 9)
        assert conv.tile_cost(tile, 256, 96, 864, lanes=20) >= \
            conv.tile_cost(tile, 256, 96, 864)
    assert conv._pick_tile(256, 96, 864, 1, 1) == conv._pick_tile(256, 96,
                                                                  864)


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_train_lanes_matches_train_fold(data, rate):
    """train_lanes of 2 folds x 2 learning rates against four train_fold
    runs with the same lane_overrides-style init and batch orders, and
    with dropout > 0 the same dropout generators: per-lane val losses,
    histories (NaN past each lane's own stop) and best states."""
    x, y_oh, fm = data
    cfg = UNetConfig(filters=1, n_blocks=2, dropout_rate=rate)
    st = engine.TrainSettings(epochs=4, batch_size=16, patience=1,
                              val_rows=int(fm.val.sum(1).max()),
                              early_exit=True)
    lanes = [(f, lr) for f in range(2) for lr in (1e-2, 1e-3)]
    xt, yt = torch.tensor(x), torch.tensor(y_oh)

    def gens(i, f):
        return (tsweep.lane_generator(SEED, f, i),
                tsweep.lane_generator(SEED, f, i, "cpu", stream=1))

    serial = []
    for i, (f, lr) in enumerate(lanes):
        g, d = gens(i, f)
        serial.append(engine.train_fold(
            UNet(cfg, 1, generator=g), xt, yt[f], fm.train[f], fm.val[f],
            lr, g, st, dropout_generator=d))
    pairs = [gens(i, f) for i, (f, _) in enumerate(lanes)]
    fs = [f for f, _ in lanes]
    res = engine.train_lanes(
        [UNet(cfg, 1, generator=g) for g, _ in pairs], xt, yt[fs],
        fm.train[fs], fm.val[fs], [lr for _, lr in lanes],
        [g for g, _ in pairs], st, dropout_generators=[d for _, d in pairs])
    assert res.batched_epochs == max(
        int(torch.isfinite(h).sum()) for _, _, h in serial)
    for i, (best, vloss, hist) in enumerate(serial):
        np.testing.assert_allclose(res.best_vloss[i].item(), vloss.item(),
                                   atol=2e-4)
        np.testing.assert_allclose(res.hist[i].numpy(), hist.numpy(),
                                   atol=2e-4)
        assert list(res.best[i]) == list(best)
        for k in best:
            np.testing.assert_allclose(res.best[i][k].numpy(),
                                       best[k].numpy(), atol=2e-4)


@pytest.fixture(scope="module")
def vmap_sweeps(data):
    """JAX's vmap sweep and the port's vmap and serial sweeps, at 8x8,
    2 folds x 2 learning rates (one bucket of 4 lanes), 3 epochs."""
    x, y_oh, fm = data
    kw = dict(n_blocks=[2], n_filters=[1], ct_kernels=[(2, 2)],
              batch_sizes=[16], learning_rates=[1e-3, 1e-4], patience=2)
    jres = jsweep.run_unet_sweep(x, y_oh, fm.train, fm.val,
                                 jsweep.TuningGrid(**kw), epochs=EPOCHS,
                                 base_seed=SEED, lane_dispatch="vmap")
    overrides = jax_lanes(JaxUNet(JaxUNetConfig(filters=1, n_blocks=2,
                                                ct_kernel=(2, 2))), x)
    ports = {mode: tsweep.run_unet_sweep(
        x, y_oh, fm.train, fm.val, tsweep.TuningGrid(**kw), epochs=EPOCHS,
        base_seed=SEED, device="cpu", lane_overrides=overrides,
        lane_dispatch=mode) for mode in ("vmap", "serial")}
    return jres, ports


def test_vmap_sweep_matches_jax_vmap_sweep(vmap_sweeps):
    jres, ports = vmap_sweeps
    res = ports["vmap"]
    assert jres.timings["lane_dispatch"] == res.timings["lane_dispatch"] \
        == "vmap"
    np.testing.assert_allclose(res.val_loss_table, jres.val_loss_table,
                               rtol=2e-4, atol=2e-4)
    assert [t.index for t in res.best_trial] == \
        [t.index for t in jres.best_trial]
    np.testing.assert_allclose(res.predictions.numpy(),
                               np.asarray(jres.predictions), atol=1e-3)


def test_vmap_sweep_matches_serial_sweep(vmap_sweeps):
    """The port's two modes: val tables within 2e-4, the same winners,
    the same per-lane epochs and steps (each lane stops at its own epoch
    in both), and 4 lanes per batched step."""
    _, ports = vmap_sweeps
    rv, rs = ports["vmap"], ports["serial"]
    assert rs.timings["lane_dispatch"] == "serial"
    np.testing.assert_allclose(rv.val_loss_table, rs.val_loss_table,
                               rtol=2e-4, atol=2e-4)
    assert [t.index for t in rv.best_trial] == \
        [t.index for t in rs.best_trial]
    assert (rv.train_steps, rv.epochs_run) == (rs.train_steps, rs.epochs_run)
    assert 0 < rv.timings["batched_steps"] * 4 >= rv.train_steps
    assert rv.timings["batched_epochs"] <= rv.epochs_run
    np.testing.assert_allclose(rv.predictions.numpy(), rs.predictions.numpy(),
                               atol=1e-3)


def test_serial_rejects_mesh(data):
    x, y_oh, fm = data
    grid = tsweep.TuningGrid(n_blocks=[2], n_filters=[1], ct_kernels=[(2, 2)],
                             batch_sizes=[16], learning_rates=[1e-3],
                             patience=2)
    mesh = pmesh.sweep_mesh(devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="serial"):
        tsweep.run_unet_sweep(x, y_oh, fm.train, fm.val, grid, epochs=2,
                              device="cpu", mesh=mesh, lane_dispatch="serial")
    with pytest.raises(ValueError, match="lane_dispatch"):
        tsweep.run_unet_sweep(x, y_oh, fm.train, fm.val, grid, epochs=2,
                              device="cpu", lane_dispatch="bogus")

"""Port vs JAX: the lane mesh (s2s_ismr_tpu_torch.parallel.mesh) and its
callers.

Mirrors tests/test_parallel.py (lane placement, the collectives, the
sweep over the mesh, the pixel-sharded ELR) on JAX's 8 virtual CPU devices
against a port mesh of 8 CPU devices (`sweep_mesh(devices=['cpu'] * 8)`),
and run_pipeline(use_mesh=) of s2s_ismr_tpu/pipelines/tune.py:729-737.

A mesh sweep runs each lane exactly as the unsharded port does (its
device's thread, lane after lane through train_fold), so it is bit-equal
to it; against JAX's mesh sweep (JAX's init and batch orders injected)
the val tables agree within 2e-4, JAX's own mesh-vs-single-device
tolerance. The sharded ELR cuts the 16 pixel rows into 8 equal blocks and
is bit-equal to the unsharded port; against JAX's sharded ELR it agrees
within rtol 1e-5 / atol 1e-6, test_parallel.py's tolerance.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2s_ismr_tpu.models import UNet as JaxUNet
from s2s_ismr_tpu.models import UNetConfig as JaxUNetConfig
from s2s_ismr_tpu.ops import elr as jelr
from s2s_ismr_tpu.ops import terciles as jterciles
from s2s_ismr_tpu.parallel import mesh as jmesh
from s2s_ismr_tpu.train import sweep as jsweep
from s2s_ismr_tpu_torch import timeutils
from s2s_ismr_tpu_torch.data import synthetic
from s2s_ismr_tpu_torch.grid import Domain
from s2s_ismr_tpu_torch.kernels import conv
from s2s_ismr_tpu_torch.models.convert import from_flax
from s2s_ismr_tpu_torch.ops import elr as telr
from s2s_ismr_tpu_torch.ops import terciles
from s2s_ismr_tpu_torch.parallel import mesh as pmesh
from s2s_ismr_tpu_torch.pipelines import get_config
from s2s_ismr_tpu_torch.pipelines import tune as ttune
from s2s_ismr_tpu_torch.train import splits
from s2s_ismr_tpu_torch.train import sweep as tsweep

SEED, EPOCHS = 42, 3


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh.sweep_mesh(8), pmesh.sweep_mesh(devices=["cpu"] * 8)


def test_sweep_mesh_defaults_to_the_cards():
    """With no card visible (tests hide them) the default mesh has no
    device and says so; an explicit device list builds one."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.sweep_mesh()
    m = pmesh.sweep_mesh(3, devices=["cpu"] * 8)
    assert m.size == 3 and m.axis_names == ("lanes",)
    assert all(d == torch.device("cpu") for d in m.devices)


def test_shard_lanes_placement(meshes):
    """Device i holds the same contiguous block of lanes as JAX's shard
    on its i-th device; replicate gives every device the whole value."""
    jm, pm = meshes
    a = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    (sa,) = jmesh.shard_lanes((a,), jm)
    want = {s.device.id: np.asarray(s.data) for s in sa.addressable_shards}
    parts = pmesh.shard_lanes((a,), pm)
    assert len(parts) == 8
    for i, (blk,) in enumerate(parts):
        np.testing.assert_array_equal(blk.numpy(), want[jm.devices[i].id])
    for (rep,) in pmesh.replicate((a,), pm):
        np.testing.assert_array_equal(rep.numpy(), a)
    with pytest.raises(ValueError, match="do not divide"):
        pmesh.shard_lanes(np.zeros(12), pm)


def test_collectives(meshes):
    jm, pm = meshes
    v = np.arange(16.0, dtype=np.float32)
    assert float(pmesh.pmean_over_lanes(torch.tensor(v), pm)) == \
        pytest.approx(float(jmesh.pmean_over_lanes(
            jmesh.shard_lanes((jnp.asarray(v),), jm)[0], jm))) == 7.5
    v2 = np.roll(np.arange(16.0, dtype=np.float32), 5)
    v2[12] = v2[11]          # a tie: the first minimum wins on both sides
    want = int(jmesh.argmin_over_lanes(
        jmesh.shard_lanes((jnp.asarray(v2),), jm)[0], jm))
    assert int(pmesh.argmin_over_lanes(torch.tensor(v2), pm)) == want \
        == int(np.argmin(v2))


@pytest.mark.parametrize("local", ["scan", "vmap"])
def test_shard_map_lanes_matches_jax(meshes, local):
    """A lane function with one shared argument: the gathered lane-major
    outputs equal JAX's, in both local modes ('vmap' hands each device its
    block, here batched by torch.func.vmap)."""
    jm, pm = meshes

    def lane(s, a, b):
        return s * a + b, (a * b).sum()

    rng = np.random.default_rng(0)
    s = rng.normal(size=(3,)).astype(np.float32)
    a = rng.normal(size=(16, 3)).astype(np.float32)
    b = rng.normal(size=(16, 3)).astype(np.float32)
    want = jmesh.shard_map_lanes(lane, jm, n_shared=1, local=local)(
        jnp.asarray(s), jnp.asarray(a), jnp.asarray(b))
    fn = (lane if local == "scan"
          else torch.func.vmap(lane, in_dims=(None, 0, 0)))
    got = pmesh.shard_map_lanes(fn, pm, n_shared=1, local=local)(
        torch.tensor(s), torch.tensor(a), torch.tensor(b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    with pytest.raises(ValueError, match="local"):
        pmesh.shard_map_lanes(lane, pm, local="bogus")


@pytest.fixture(scope="module")
def sweep_data():
    b = synthetic.synthetic_hindcast(years=(2003, 2012), seed=5, signal=0.8,
                                     grid_shape=(8, 8)).fillna(0.0)
    fm = splits.bootstrap_masks(b.years, n_bootstraps=2)
    wm = timeutils.week_window_matrix(1)
    y_oh = np.stack([np.nan_to_num(np.asarray(jterciles.one_hot_labels(
        jterciles.fit_and_label(b.y, b.weeks, fm.train[f], wm, None)[0])),
        nan=0.0) for f in range(fm.n_folds)]).astype(np.float32)
    x = b.ensemble_mean()[..., None].astype(np.float32)
    return x, y_oh, fm


def _jax_overrides(x):
    """JAX's lane init and batch orders (_lane_keys(SEED, fold, trial))."""
    jm = JaxUNet(JaxUNetConfig(filters=1, n_blocks=2, ct_kernel=(3, 3)))
    init = jax.jit(lambda k, v: jm.init(k, v, train=False))

    def overrides(f, ti):
        key = jsweep._lane_keys(SEED, f, ti)
        key, init_key = jax.random.split(key)
        perms = [np.asarray(jax.random.permutation(
            jax.random.split(ek)[0], x.shape[0]))
            for ek in jax.random.split(key, EPOCHS)]
        return (from_flax(init(init_key, jnp.asarray(x[:1]))),
                np.stack(perms).astype(np.int64))
    return overrides


def test_sweep_over_mesh(meshes, sweep_data):
    """run_unet_sweep(mesh=) over 8 CPU devices: 2 folds x 2 learning
    rates, padded to 8 lanes. Bit-equal to the unsharded port, local
    'scan' ('auto') and 'vmap' alike within the batched tolerance; within
    2e-4 of JAX's mesh sweep."""
    jm, pm = meshes
    x, y_oh, fm = sweep_data
    kw = dict(n_blocks=(2,), n_filters=(1,), ct_kernels=((3, 3),),
              batch_sizes=(16,), learning_rates=(1e-3, 1e-4), patience=2)
    jres = jsweep.run_unet_sweep(x, y_oh, fm.train, fm.val,
                                 jsweep.TuningGrid(**kw), epochs=EPOCHS,
                                 base_seed=SEED, mesh=jm)
    common = dict(epochs=EPOCHS, base_seed=SEED, device="cpu",
                  lane_overrides=_jax_overrides(x))
    grid = tsweep.TuningGrid(**kw)
    threads = torch.get_num_threads()
    # one intra-op thread per mesh thread: 8 host threads share the cores
    torch.set_num_threads(1)
    try:
        one = tsweep.run_unet_sweep(x, y_oh, fm.train, fm.val, grid,
                                    **common)
        res = tsweep.run_unet_sweep(x, y_oh, fm.train, fm.val, grid,
                                    mesh=pm, **common)
        vm = tsweep.run_unet_sweep(x, y_oh, fm.train, fm.val, grid,
                                   mesh=pmesh.sweep_mesh(devices=["cpu"] * 3),
                                   lane_dispatch="vmap", **common)
    finally:
        torch.set_num_threads(threads)
    assert res.timings["lane_dispatch"] == jres.timings["lane_dispatch"] \
        == "mesh"
    np.testing.assert_array_equal(res.val_loss_table, one.val_loss_table)
    assert torch.equal(res.predictions, one.predictions)
    for got, want in zip(res.winner_variables, one.winner_variables):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert (res.train_steps, res.epochs_run) == (one.train_steps,
                                                  one.epochs_run)
    np.testing.assert_allclose(res.val_loss_table, jres.val_loss_table,
                               rtol=2e-4, atol=2e-4)
    assert [t.index for t in res.best_trial] == \
        [t.index for t in jres.best_trial]
    np.testing.assert_allclose(vm.val_loss_table, one.val_loss_table,
                               rtol=2e-4, atol=2e-4)


def test_elr_folds_over_mesh(meshes):
    """Pixel rows over the mesh: bit-equal to the unsharded port, within
    test_parallel.py's tolerance of JAX's sharded program."""
    jm, pm = meshes
    b = synthetic.synthetic_hindcast(years=(2003, 2010), seed=3,
                                     domain=Domain(67, 98, 7, 38), step=2.0)
    fm = splits.bootstrap_masks_elr(b.years, n_bootstraps=3)
    wm = timeutils.week_window_matrix(1)
    y = torch.as_tensor(b.y)
    targets = []
    for pm_f in fm.train:
        e, p = terciles.rolling_edges(y, b.weeks, pm_f, wm)
        targets.append(terciles.elr_targets(y, b.weeks, e, p))
    targets = torch.stack(targets)
    xm = b.ensemble_mean()
    assert xm.shape[1] == 16
    ref = telr.elr_folds(xm, targets, fm.train, fm.test, b.y)
    shd = telr.elr_folds(xm, targets, fm.train, fm.test, b.y, mesh=pm)
    assert torch.equal(torch.isnan(shd), torch.isnan(ref))
    assert torch.equal(torch.nan_to_num(shd), torch.nan_to_num(ref))
    want = np.asarray(jelr.elr_folds(xm, targets.numpy(), fm.train, fm.test,
                                     b.y, mesh=jm))
    np.testing.assert_allclose(shd.numpy(), want, rtol=1e-5, atol=1e-6)


def test_run_pipeline_use_mesh(tmp_path):
    """use_mesh=True on the CPU: a one-device mesh, logged as JAX logs it,
    and a run bit-equal to use_mesh=False (RPSS maps and winner states);
    'auto' sees no second card and shards nothing."""
    cfg = get_config("tune_ECMWF_com").fast_variant(epochs=2)
    logs = {}
    outs = {}
    for use in (False, True, "auto"):
        logs[use] = []
        outs[use] = ttune.run_pipeline(
            cfg, out_root=str(tmp_path / str(use)), synthetic_step=2.0,
            log=logs[use].append, device="cpu", use_mesh=use)
    assert "[mesh] sweep lanes sharded over 1 devices" in logs[True]
    assert not any("[mesh]" in s for s in logs[False] + logs["auto"])
    a, b = outs[False], outs[True]
    for part in ("rpss_train", "rpss_val", "rpss_test"):
        np.testing.assert_array_equal(getattr(a.nn, part).values,
                                      getattr(b.nn, part).values)
    np.testing.assert_array_equal(a.elr.rpss_test.values,
                                  b.elr.rpss_test.values)
    sa, sb = (o.nn.sweeps[cfg.models[0]] for o in (a, b))
    assert sb.timings["lane_dispatch"] == "mesh"
    for got, want in zip(sb.winner_variables, sa.winner_variables):
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_launch_counters_under_threads(monkeypatch):
    """The launch counters lose no update when the host threads of a mesh
    count at once (more threads than cores, a short switch interval)."""
    monkeypatch.setattr(conv, "LAUNCHES", 0)
    monkeypatch.setattr(conv, "LANE_LAUNCHES", 0)
    n_threads, n = 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda i=i: [
            conv._count(1 + i % 2) for _ in range(n)])
            for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert conv.LAUNCHES == n_threads * n
    assert conv.LANE_LAUNCHES == n_threads // 2 * n

"""Device-mesh scaling for the tuning sweep (port of
s2s_ismr_tpu/parallel/mesh.py).

The scaling axis is the sweep lane: folds x trials are independent
trainings of a ~0.1 M-parameter model, so the design is pure lane data
parallelism with no communication in the hot loop, as in JAX:

  * a 1-D mesh ('lanes') over the devices one process sees: by default
    every visible CUDA device. JAX's mesh is single-controller over
    jax.devices(), and run_pipeline(use_mesh='auto') shards whenever one
    process sees several devices, with no launcher; so the port's mesh is
    a list of devices in one process, not torch.distributed;
  * lane-major values (lanes, ...) are cut along axis 0 into contiguous
    blocks, one per device (`shard_lanes`); shared values are copied to
    every device (`replicate`). Both return a per-device list (of the
    value's tree) in place of JAX's sharded arrays;
  * `shard_map_lanes` runs each device's block of lanes in a host thread
    of its own (the kernels release the GIL while the card works), and
    gathers the lane-major outputs on the mesh's first device. Each device
    trains through programs of its own (the device is part of a program's
    key); they capture in `thread_local` mode, so the other devices'
    threads keep allocating while one captures (`programs`);
  * the cross-lane reductions (`pmean_over_lanes`, `argmin_over_lanes`)
    copy each device's part to the first device and reduce there.

Tensor and pipeline parallelism are absent on purpose: the model is far
too small to shard.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

from .. import profiling

LANES = "lanes"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices that share the lane axis, in order."""
    devices: tuple
    axis_names: tuple = (LANES,)

    @property
    def size(self):
        return len(self.devices)


def sweep_mesh(n_devices=None, devices=None) -> Mesh:
    """A mesh over `devices` (any torch device names; a test may pass
    ['cpu'] * 8) or, by default, every visible CUDA device; the first
    `n_devices` of them when given."""
    devs = (list(devices) if devices is not None else
            [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())])
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise RuntimeError("sweep_mesh: no CUDA device; pass devices= to "
                           "build a mesh of other devices")
    return Mesh(tuple(torch.device(d) for d in devs))


@dataclass(frozen=True)
class Sharding:
    """How a value lies on a mesh: lane-major and cut along axis 0 into
    one contiguous block per device, or copied whole to every device."""
    mesh: Mesh
    lanes: bool

    def place(self, a):
        """The per-device list of `a` (a tensor, or an array)."""
        a = torch.as_tensor(a)
        devs = self.mesh.devices
        if not self.lanes:
            return [a.to(d) for d in devs]
        if a.shape[0] % len(devs):
            raise ValueError(f"{a.shape[0]} lanes do not divide over "
                             f"{len(devs)} devices")
        return [blk.to(d) for blk, d in zip(a.chunk(len(devs)), devs)]


def lane_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis sharding for lane-major values."""
    return Sharding(mesh, True)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, False)


def tree_map(fn, *trees):
    """fn over the leaves of equally shaped trees of dicts, lists and
    tuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(u[k] for u in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *u) for u in zip(*trees))
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of a tree of dicts, lists and tuples, in order."""
    out = []
    tree_map(out.append, tree)
    return out


def _per_device(tree, sharding: Sharding):
    """[the tree with each leaf replaced by device i's part, for each
    device i of the mesh]."""
    parts = [sharding.place(leaf) for leaf in tree_leaves(tree)]
    out = []
    for i in range(sharding.mesh.size):
        it = iter([p[i] for p in parts])
        out.append(tree_map(lambda _: next(it), tree))
    return out


def shard_lanes(tree, mesh: Mesh):
    """The per-device list of the tree's lane blocks: device i gets lanes
    [i * L / n, (i + 1) * L / n) of every leaf (lane-major, L a multiple
    of the mesh size n)."""
    return _per_device(tree, lane_sharding(mesh))


def replicate(tree, mesh: Mesh):
    """The per-device list of the tree's copies (the shared x images every
    lane reads)."""
    return _per_device(tree, replicated(mesh))


def on_devices(fn, mesh: Mesh):
    """[fn(i, device) for each device of the mesh], each call in a host
    thread of its own with that device current and the caller's call
    record carried (its spans land there); exceptions propagate."""
    rec = profiling.current()

    def run(i):
        dev = mesh.devices[i]
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx, profiling.carried(rec):
            return fn(i, dev)
    with ThreadPoolExecutor(max_workers=mesh.size) as ex:
        return list(ex.map(run, range(mesh.size)))


def gather(parts, device):
    """Per-device lane-major outputs (trees of tensors) concatenated along
    axis 0 on `device`."""
    return tree_map(lambda *ts: torch.cat([t.to(device) for t in ts]),
                    *parts)


def shard_map_lanes(lane_fn, mesh: Mesh, n_shared: int = 1, local="scan"):
    """Run a lane function over the mesh's lane axis.

    Returns a callable taking (*shared, *lane_major): the first n_shared
    arguments are copied to every device; the rest (trees of lane-major
    tensors, lanes a multiple of the mesh size) are cut into one
    contiguous block per device. Each device runs its block in a thread of
    its own, and the lane-major outputs come back concatenated on the
    mesh's first device, as JAX's out_specs=P('lanes').

    local: how a device runs its own lanes --
      'scan' (default): one lane after another, lane_fn(*shared, *lane)
        with each lane's slice (no lane axis); outputs stacked. Each lane
        runs the plain per-lane program (the sweep: train_fold), bit for
        bit what one device runs for it;
      'vmap': lane_fn(*shared, *block) once with the device's whole block
        (a leading lane axis); lane_fn batches it itself, e.g. as
        torch.func.vmap(f, in_dims=...) of a per-lane f, or, in the
        sweep, through train_lanes.
    """
    if local not in ("scan", "vmap"):
        raise ValueError(f"local={local!r}")

    def spmd(*args):
        shared = replicate(list(args[:n_shared]), mesh)
        blocks = shard_lanes(list(args[n_shared:]), mesh)

        def run(i, _dev):
            sh, blk = shared[i], blocks[i]
            if local == "vmap":
                return lane_fn(*sh, *blk)
            n = len(tree_leaves(blk)[0])
            outs = [lane_fn(*sh, *tree_map(lambda t: t[j], blk))
                    for j in range(n)]
            return tree_map(lambda *ts: torch.stack(ts), *outs)

        return gather(on_devices(run, mesh), mesh.devices[0])

    return spmd


def pmean_over_lanes(values, mesh: Mesh):
    """Global mean across the lane axis: each device's mean of its lanes,
    then the mean of those on the first device (JAX's pmean of the local
    means)."""
    parts = shard_lanes(values, mesh)
    means = on_devices(lambda i, _d: parts[i].mean(0), mesh)
    return torch.stack([m.to(mesh.devices[0]) for m in means]).mean(0)


def argmin_over_lanes(values, mesh: Mesh):
    """Global argmin across sharded lanes (winner selection): the shards
    gathered on the first device, the first minimum taken there."""
    parts = shard_lanes(values, mesh)
    return torch.argmin(gather(parts, mesh.devices[0]))

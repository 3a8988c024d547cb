"""Lane parallelism over the cards one process sees (port of
s2s_ismr_tpu/parallel)."""

from .mesh import Mesh, lane_sharding, shard_lanes, sweep_mesh  # noqa: F401

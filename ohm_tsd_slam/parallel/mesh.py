"""Device-mesh construction for multi-chip SLAM.

The reference has no distribution at all (SURVEY §2.5 / §5.8: boost
threads + OpenMP in one process).  This design scales along two
meaningful axes:

  * "sp" — spatial parallelism: TSD grid rows (tile rows) sharded across
    chips; the push kernel partitions element-wise, XLA inserts the
    collectives for cross-shard reads (the halo-exchange analogue of
    TsdGrid::propagateBorders).
  * "dp" — data parallelism: robots (multi-SLAM, SlamNode.cpp:101-122)
    and/or beams sharded across chips; pose estimation reductions ride
    psum over ICI.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) with a*b == n."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


def make_mesh(devices: Optional[Sequence] = None,
              axes: Tuple[str, str] = ("sp", "dp")) -> Mesh:
    """2D mesh over the given (default: all) devices."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    a, b = _factor2(n)
    arr = np.asarray(devices).reshape(a, b)
    return Mesh(arr, axes)


def grid_sharding(mesh: Mesh):
    """Shard [H, W] grid arrays across tile rows ("sp")."""
    return NamedSharding(mesh, P("sp", None))


def tile_sharding(mesh: Mesh):
    return NamedSharding(mesh, P("sp", None))


def robot_sharding(mesh: Mesh):
    """Shard [R, ...] per-robot batches across "dp"."""
    return NamedSharding(mesh, P("dp"))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())

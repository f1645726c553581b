"""Multi-host runtime wiring (SURVEY §5.8).

The reference is single-process (boost threads + OpenMP); this
framework scales across hosts with `jax.distributed` — each host drives
its local devices and the Mesh spans all of them.  This module is the thin, testable wrapper:
environment-driven initialization plus host-0 scan broadcast.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialize the multi-host runtime (jax.distributed.initialize).

    Arguments default to the standard JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID environment variables; returns
    False (no-op) when neither arguments nor environment request a
    multi-process run, so single-host use never pays the coordinator
    round-trip.
    """
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else \
        int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    if not addr or nproc <= 1:
        return False
    pid = process_id if process_id is not None else \
        int(os.environ.get("JAX_PROCESS_ID", "0") or 0)
    jax.distributed.initialize(coordinator_address=addr,
                               num_processes=nproc,
                               process_id=pid)
    return True


def broadcast_scan(mesh, arrays: Sequence[np.ndarray]):
    """Host-0 scan ingest: replicate host-local numpy scan arrays to
    every device of the mesh (multihost_utils under the hood when the
    mesh spans processes; a plain device_put replication otherwise)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())
    if jax.process_count() > 1:  # pragma: no cover - needs real pod
        from jax.experimental import multihost_utils

        return [multihost_utils.host_local_array_to_global_array(
            a, mesh, P()) for a in arrays]
    return [jax.device_put(jax.numpy.asarray(a), rep) for a in arrays]

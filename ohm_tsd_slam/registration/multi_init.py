"""Multi-hypothesis ICP restart wrapper.

Redesign of IcpMultiInitIterator
(src/obvision/registration/icp/IcpMultiInitIterator.cpp): run ICP from a
vector of initial transforms plus the previous call's winner, keep the
result with the most pairs (assignBetterSolution, :26-38).

Instead of sequential `icp->reset(); icp->iterate(...)` calls, the seeds
become a batch axis: one vmapped ICP solve over [K, 3, 3] seeds, then an
argmax on pair counts.  The "last transformation" memory is functional —
the caller threads `T_last` through successive calls.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ohm_tsd_slam.registration.icp import IcpParams, IcpResult, icp


class MultiInitResult(NamedTuple):
    T: jnp.ndarray           # (3,3) best final transform
    rms: jnp.ndarray
    pairs: jnp.ndarray
    iterations: jnp.ndarray
    best_seed: jnp.ndarray   # index into the seed batch
    T_last: jnp.ndarray      # carry for the next call (== T)


def icp_multi_init(model: jnp.ndarray, model_mask: jnp.ndarray,
                   scene: jnp.ndarray, scene_mask: jnp.ndarray,
                   seeds: jnp.ndarray, params: IcpParams,
                   T_last: Optional[jnp.ndarray] = None,
                   sensor_pose: Optional[jnp.ndarray] = None
                   ) -> MultiInitResult:
    """Run ICP from every seed in `seeds` [K, 3, 3] (+ optional T_last as
    one more seed, IcpMultiInitIterator.cpp:64-71) and return the result
    with the most pairs."""
    if T_last is not None:
        seeds = jnp.concatenate([seeds, T_last[None]], axis=0)

    def solve(T0):
        r = icp(model, model_mask, scene, scene_mask, params,
                T_init=T0, sensor_pose=sensor_pose)
        return r.T, r.rms, r.pairs, r.iterations

    Ts, rms, pairs, iters = jax.vmap(solve)(seeds)
    best = jnp.argmax(pairs)
    T = Ts[best]
    return MultiInitResult(T=T, rms=rms[best], pairs=pairs[best],
                           iterations=iters[best], best_seed=best,
                           T_last=T)

"""Adaptive Monte-Carlo matching against the TSD grid.

The reference declares this matcher but never implements it:
src/obvision/registration/amcl/AdaptiveMonteCarloMatching.h:16-40 is a
header-only stub (`match(const Matrix* S, const bool* maskS)`) with no
.cpp and no build entry (CMakeLists.txt:28-67).  We provide a working
implementation with the declared surface — localize a scene
scan against the map — as a fixed-shape particle filter:

* particles = a [P, 3] batch of (x, y, theta) pose perturbations; every
  step is a dense vmap-style computation (no per-particle control flow).
* measurement model = the TSD likelihood the reference's TSD_PDFMatching
  uses to rate candidate poses (TSD_PDFMatching.cpp:233-251):
  p = 1 - (1-zrand)*|tsd| on bilinear hits, zrand on misses.
* "adaptive": KLD-sampling's variable particle count is hostile to XLA's
  static shapes, so adaptivity is expressed as effective-sample-size
  (ESS) feedback on the resampling jitter — low ESS widens the proposal,
  high ESS lets the annealed jitter shrink — with a fixed particle count.
* resampling = systematic (low-variance) resampling via cumulative
  weights + searchsorted; the whole filter is one `lax.scan`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid.interpolate import interpolate_bilinear
from ohm_tsd_slam.grid.state import INTERPOLATE_SUCCESS, TsdGrid
from ohm_tsd_slam.registration.ransac import random_valid_subset


@dataclass(frozen=True)
class AmclParams:
    """Static AMCL parameters (hashable; jit-safe)."""

    particles: int = 512
    iterations: int = 8
    sigma_trans: float = 0.25       # initial proposal std-dev (m)
    sigma_rot: float = 0.17         # initial proposal std-dev (rad)
    anneal: float = 0.6             # per-iteration jitter decay
    zrand: float = 0.25             # miss likelihood (matches zrand_tsd)
    size_control_set: int = 140     # scene subsample per likelihood eval
    ess_target: float = 0.5         # adaptive jitter kicks in below this
    ess_boost_max: float = 3.0      # jitter widening cap


def _log_likelihood(grid: TsdGrid, sensor_pose: jnp.ndarray,
                    ctrl: jnp.ndarray, ctrl_mask: jnp.ndarray,
                    particles: jnp.ndarray, zrand: float,
                    logp_sum_fn=None) -> jnp.ndarray:
    """TSD log-likelihood of each particle pose. particles: [P, 3].

    `logp_sum_fn(world [P,C,2], ctrl_mask [C]) -> [P]`, when given,
    replaces the grid taps + masked sum (parallel/shard_matchers.py)."""
    c, s = jnp.cos(particles[:, 2]), jnp.sin(particles[:, 2])
    # local scene points through the particle's perturbation transform
    x = ctrl[None, :, 0]
    y = ctrl[None, :, 1]
    px = c[:, None] * x - s[:, None] * y + particles[:, 0:1]
    py = s[:, None] * x + c[:, None] * y + particles[:, 1:2]
    local = jnp.stack([px, py], axis=-1)                 # [P, C, 2]
    if logp_sum_fn is not None:
        world = se2.transform_points(sensor_pose, local)
        return logp_sum_fn(world, ctrl_mask)
    world = se2.transform_points(sensor_pose, local.reshape(-1, 2))
    tsd, code = interpolate_bilinear(grid, world)
    hit = code == INTERPOLATE_SUCCESS
    logp = jnp.where(
        hit,
        jnp.log(jnp.maximum(1.0 - (1.0 - zrand) * jnp.abs(tsd), 1e-30)),
        math.log(zrand)).reshape(particles.shape[0], -1)
    return jnp.sum(jnp.where(ctrl_mask[None, :], logp, 0.0), axis=1)


def _systematic_resample(key: jax.Array, logw: jnp.ndarray) -> jnp.ndarray:
    """Indices of a low-variance (systematic) resampling. logw: [P]."""
    n = logw.shape[0]
    w = jax.nn.softmax(logw)
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / n)
    u = u0 + jnp.arange(n, dtype=w.dtype) / n
    return jnp.clip(jnp.searchsorted(cum, u), 0, n - 1)


def match_amcl(key: jax.Array, grid: TsdGrid, sensor_pose: jnp.ndarray,
               scene: jnp.ndarray, mask_scene: jnp.ndarray,
               params: AmclParams = AmclParams(),
               logp_sum_fn=None) -> jnp.ndarray:
    """Monte-Carlo scene-to-map matching (the working realization of
    AdaptiveMonteCarloMatching::match, AdaptiveMonteCarloMatching.h:35).

    Args:
      key: PRNG key (replaces the reference family's rand() calls).
      grid: the TSD map.
      sensor_pose: (3,3) current sensor pose estimate (map frame).
      scene: (N,2) scene points in the sensor frame.
      mask_scene: (N,) scene validity.
      params: static filter parameters.
    Returns:
      (3,3) SE(2) correction transform (sensor-frame, like the RANSAC
      matchers): apply as pose' = sensor_pose @ T.
    """
    dtype = scene.dtype
    k_ctrl, k_init, k_scan = jax.random.split(key, 3)
    idx, ctrl_mask = random_valid_subset(k_ctrl, mask_scene,
                                         params.size_control_set)
    ctrl = scene[idx]

    p0 = jnp.stack([
        params.sigma_trans * jax.random.normal(k_init, (params.particles,),
                                               dtype=dtype),
        params.sigma_trans * jax.random.normal(
            jax.random.fold_in(k_init, 1), (params.particles,), dtype=dtype),
        params.sigma_rot * jax.random.normal(
            jax.random.fold_in(k_init, 2), (params.particles,), dtype=dtype),
    ], axis=1)
    # particle 0 pinned to the prior so the filter can never do worse
    # than the incoming estimate
    p0 = p0.at[0].set(0.0)

    anneal = params.anneal ** jnp.arange(params.iterations, dtype=dtype)
    keys = jax.random.split(k_scan, params.iterations)

    def scan_body(particles, xs):
        it_key, decay = xs
        k_res, k_jit = jax.random.split(it_key)
        logw = _log_likelihood(grid, sensor_pose, ctrl, ctrl_mask,
                               particles, params.zrand, logp_sum_fn)
        w = jax.nn.softmax(logw)
        ess = 1.0 / jnp.maximum(jnp.sum(w * w), 1e-30)
        ess_ratio = ess / params.particles
        boost = jnp.clip(params.ess_target / jnp.maximum(ess_ratio, 1e-6),
                         1.0, params.ess_boost_max)
        sel = _systematic_resample(k_res, logw)
        resampled = particles[sel]
        sigma = jnp.array([params.sigma_trans, params.sigma_trans,
                           params.sigma_rot], dtype=dtype) * decay
        noise = jax.random.normal(k_jit, particles.shape, dtype=dtype)
        return resampled + noise * sigma[None, :] * boost, None

    particles, _ = jax.lax.scan(scan_body, p0, (keys, anneal))

    # final selection: highest-likelihood particle (no jitter applied)
    logw = _log_likelihood(grid, sensor_pose, ctrl, ctrl_mask,
                           particles, params.zrand, logp_sum_fn)
    best = particles[jnp.argmax(logw)]
    return se2.make(best[0], best[1], best[2], dtype=dtype)

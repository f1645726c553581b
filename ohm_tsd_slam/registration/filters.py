"""Pre/post assignment filters as pure mask transforms.

Replicates the reference's filter chain (src/obvision/registration/icp/
assign/filter/*) in masked fixed-shape form: a "pair set" here is the
triple (model_idx[S], dist2[S], pair_mask[S]) aligned to scene points,
instead of growing std::vectors.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ohm_tsd_slam.core import se2


# ---------------------------------------------------------------------------
# Pre-filters (mask scene points before NN search)
# ---------------------------------------------------------------------------

def out_of_bounds_filter_2d(scene: jnp.ndarray, mask: jnp.ndarray,
                            pose: jnp.ndarray,
                            x_min: float, x_max: float,
                            y_min: float, y_max: float) -> jnp.ndarray:
    """OutOfBoundsFilter2D (OutOfBoundsFilter2D.cpp:27-37): drop scene
    points that, transformed by the sensor pose, fall outside the grid
    AABB."""
    w = se2.transform_points(pose, scene)
    inside = ((w[:, 0] >= x_min) & (w[:, 0] <= x_max)
              & (w[:, 1] >= y_min) & (w[:, 1] <= y_max))
    return mask & inside


def robot_footprint_filter(scene: jnp.ndarray, mask: jnp.ndarray,
                           center: jnp.ndarray,
                           radius: float) -> jnp.ndarray:
    """RobotFootprintFilter (RobotFootprintFilter.cpp:41-61): mask points
    within `radius` of the robot center (self-observations)."""
    d2 = jnp.sum((scene - center) ** 2, axis=1)
    return mask & (d2 > radius * radius)


def occlusion_filter(scene3d: jnp.ndarray, mask: jnp.ndarray,
                     P: jnp.ndarray, width: int, height: int) -> jnp.ndarray:
    """OcclusionFilter (OcclusionFilter.cpp:34-95): project 3D scene
    points through the 3×4 matrix P into a width×height image and keep
    only the nearest-z point per pixel (1e-3 z tolerance).

    Vectorized z-buffer: a min-scatter over pixel indices replaces the
    sequential insert-compare loop.  Divergence (documented): where two
    points tie within 1e-3 the reference keeps whichever it encountered
    in a winning order; here every point within 1e-3 of the pixel
    minimum survives — a superset that differs only inside the
    tolerance band.
    """
    x, y, z = scene3d[:, 0], scene3d[:, 1], scene3d[:, 2]
    dw = P[2, 0] * x + P[2, 1] * y + P[2, 2] * z + P[2, 3]
    proj_ok = (jnp.abs(dw) > 1e-12) & (z > 0)
    du = (P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + P[0, 3]) / dw
    dv = (P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + P[1, 3]) / dw
    u = jnp.floor(du + 0.5).astype(jnp.int32)
    v = height - 1 - jnp.floor(dv + 0.5).astype(jnp.int32)
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    consider = mask & proj_ok & in_img

    pix = jnp.clip(v, 0, height - 1) * width + jnp.clip(u, 0, width - 1)
    zbuf = jnp.full((width * height,), 10e6, scene3d.dtype)
    zbuf = zbuf.at[pix].min(jnp.where(consider, z, 10e6))
    occluded = consider & (z - zbuf[pix] > 1e-3)
    return mask & ~occluded


# ---------------------------------------------------------------------------
# Post-filters (prune pairs after NN search)
# ---------------------------------------------------------------------------

def distance_threshold_schedule(max_dist: float, min_dist: float,
                                iterations: int, length: int = None):
    """The shrinking squared-distance gate of DistanceFilter
    (DistanceFilter.cpp:11-19,62-63).

    The reference multiplies the *squared* threshold by the *unsquared*
    ratio root each call: d²_k = maxdist² · ((min/max)^(1/(it-1)))^k,
    clamped at mindist².  (A quirk — replicated deliberately.)

    Args:
      iterations: the filter's OWN iteration count, which only sets the
        shrink rate (an unsigned int in the reference; ThreadLocalize
        passes icpIterations - 10, ThreadLocalize.cpp:213 — the caller
        is responsible for that wrap).
      length: number of ICP steps to emit thresholds for (default =
        iterations).
    Returns the [length] array of squared thresholds per ICP step.
    """
    import numpy as np

    if length is None:
        length = iterations
    it = float(iterations - 1) if iterations >= 1 else 1.0
    if iterations < 1:
        it = 1.0
    if it == 0.0:
        # iterations == 1 (reachable via the replicated unsigned wrap at
        # cfg.iterations == 11): the reference computes pow(ratio, 1/0)
        # = pow(ratio, inf) = 0 for ratio < 1, collapsing every step's
        # gate to mindist^2 (DistanceFilter.cpp:11-29).
        mult = 0.0
    else:
        mult = (min_dist / max_dist) ** (1.0 / it)
    k = np.arange(length)
    d2 = (max_dist ** 2) * mult ** k
    return jnp.asarray(np.maximum(d2, min_dist ** 2))


def distance_filter(dist2: jnp.ndarray, pair_mask: jnp.ndarray,
                    thresh2) -> jnp.ndarray:
    """DistanceFilter::filter (DistanceFilter.cpp:50-61): keep pairs with
    d² <= current threshold."""
    return pair_mask & (dist2 <= thresh2)


def reciprocal_filter(model_idx: jnp.ndarray, dist2: jnp.ndarray,
                      pair_mask: jnp.ndarray,
                      model_size: int) -> jnp.ndarray:
    """ReciprocalFilter (ReciprocalFilter.cpp:32-78): at most one pair per
    model point — the one with the smallest distance.

    Implemented as a segment-min scatter over model indices with a
    scene-index tiebreak (matching the sort-by-(model, dist) + keep-first
    semantics of the reference).
    """
    S = dist2.shape[0]
    scene_ids = jnp.arange(S, dtype=dist2.dtype)
    d2 = jnp.where(pair_mask, dist2, jnp.inf)

    best = jnp.full((model_size,), jnp.inf, dist2.dtype)
    best = best.at[model_idx].min(d2)
    is_best = pair_mask & (d2 == best[model_idx])

    # tie-break on the smallest scene index among equal distances
    sid = jnp.where(is_best, scene_ids, jnp.inf)
    first = jnp.full((model_size,), jnp.inf, dist2.dtype)
    first = first.at[model_idx].min(sid)
    return is_best & (sid == first[model_idx])


def trimmed_filter(dist2: jnp.ndarray, pair_mask: jnp.ndarray,
                   overlap_percent: float) -> jnp.ndarray:
    """TrimmedFilter (TrimmedFilter.cpp:21-77): keep the best
    `overlap_percent`% of pairs by distance."""
    d2 = jnp.where(pair_mask, dist2, jnp.inf)
    n = jnp.sum(pair_mask)
    keep = jnp.floor(n * overlap_percent / 100.0).astype(jnp.int32)
    order = jnp.argsort(d2)
    rank = jnp.zeros_like(order).at[order].set(jnp.arange(d2.shape[0]))
    return pair_mask & (rank < keep)

"""Batched nearest-neighbor assignment.

Dense replacement for the reference's kd-tree backends
(FlannPairAssignment — the default, src/obvision/registration/icp/assign/
FlannPairAssignment.cpp:94-144 — plus the Ann/Nabo alternatives).

kd-trees are pointer-chasing structures that map poorly to an
accelerator; at SLAM scan sizes (~1081 points) an exact dense distance
matrix is a single small matmul-shaped computation, so brute force is
the natural device formulation.  Invalid points are excluded with
+inf masking rather than compaction (static shapes for XLA).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def nearest_neighbors(model: jnp.ndarray, model_mask: jnp.ndarray,
                      scene: jnp.ndarray,
                      scene_mask: jnp.ndarray
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact 1-NN from every (valid) scene point into the valid model set.

    Equivalent to FlannPairAssignment::determinePairs (1-NN kd-tree
    queries, L2) but as one dense [S, M] computation:
    d²(s,m) = |s|² + |m|² − 2·s·mᵀ.

    Args:
      model: (M, 2) model points; model_mask: (M,) validity.
      scene: (S, 2) scene points; scene_mask: (S,) validity.
    Returns:
      idx:   (S,) int32 index of the nearest valid model point
             (undefined-but-in-range where scene_mask is False or no
             valid model exists).
      dist2: (S,) squared distance (+inf where invalid).
    """
    dtype = scene.dtype
    s2 = jnp.sum(scene * scene, axis=1, keepdims=True)          # [S,1]
    m2 = jnp.sum(model * model, axis=1, keepdims=True).T        # [1,M]
    cross = scene @ model.T                                     # [S,M]
    d2 = s2 + m2 - 2.0 * cross
    d2 = jnp.maximum(d2, 0.0)  # clamp fp cancellation
    d2 = jnp.where(model_mask[None, :], d2, jnp.inf)
    idx = jnp.argmin(d2, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(d2, idx[:, None].astype(jnp.int64), axis=1)[:, 0]
    best = jnp.where(scene_mask, best, jnp.inf)
    return idx, best


def assign_pairs_fused(model: jnp.ndarray, model_mask: jnp.ndarray,
                       scene: jnp.ndarray, scene_mask: jnp.ndarray,
                       payload: jnp.ndarray,
                       thresh2=None,
                       use_reciprocal: bool = True):
    """One fused ICP pair assignment: 1-NN + distance gate + reciprocal
    filter + paired-payload gather, all as dense [S, M] element-wise ops
    and reductions — no scatter, no gather.

    Motivation: the modular chain (nearest_neighbors +
    filters.distance_filter + filters.reciprocal_filter + model[idx])
    runs the reciprocal filter's two `.at[].min` scatters and the
    estimator's row gather in every ICP iteration.  Here the reciprocal rule is re-expressed column-wise on
    the SAME [S, M] distance matrix the NN search already built
    (pair (s, m) survives iff d2[s, m] is both its row's and — among
    selected cells — its column's minimum), and the payload gather
    becomes a one-hot matmul (exact: one unit coefficient per row).

    Bit-identical to the modular chain (asserted in tests/test_icp.py):
    row argmin keeps the first minimum, the column rule keeps the
    smallest-distance pair with smallest-scene-index tie-break —
    FlannPairAssignment 1-NN (FlannPairAssignment.cpp:94-144) +
    DistanceFilter (DistanceFilter.cpp:50-61) + ReciprocalFilter
    sort-by-(model, dist)-keep-first (ReciprocalFilter.cpp:33-77).

    Args:
      model: (M, 2); model_mask: (M,) validity.
      scene: (S, 2) current scene; scene_mask: (S,) validity (after any
        pre-filters).
      payload: (M, K) per-model columns to return per pair (model xy,
        normals, ...).
      thresh2: optional scalar squared-distance gate for this iteration.
      use_reciprocal: apply the reciprocal (one-pair-per-model) rule.
    Returns:
      idx (S,) int32 nearest model index, dist2 (S,) row-best squared
      distance (+inf invalid), pair_mask (S,) surviving pairs,
      paired (S, K) payload rows (zeros outside pair_mask).
    """
    dtype = scene.dtype
    S, M = scene.shape[0], model.shape[0]
    s2 = jnp.sum(scene * scene, axis=1, keepdims=True)          # [S,1]
    m2 = jnp.sum(model * model, axis=1, keepdims=True).T        # [1,M]
    cross = scene @ model.T                                     # [S,M]
    d2 = jnp.maximum(s2 + m2 - 2.0 * cross, 0.0)
    d2 = jnp.where(model_mask[None, :], d2, jnp.inf)

    best = jnp.min(d2, axis=1)                                  # [S]
    # first-minimum index without argmin-gather: min of masked iota
    iota_m = jnp.arange(M, dtype=jnp.int32)[None, :]
    idx = jnp.min(jnp.where(d2 == best[:, None], iota_m, M), axis=1)
    idx = jnp.minimum(idx, M - 1).astype(jnp.int32)

    pmask = scene_mask & jnp.isfinite(best)
    if thresh2 is not None:
        pmask = pmask & (best <= thresh2)

    # the selected cell of each surviving row
    sel = (iota_m == idx[:, None]) & pmask[:, None]             # [S,M]
    if use_reciprocal:
        dsel = jnp.where(sel, d2, jnp.inf)
        col_best = jnp.min(dsel, axis=0)                        # [M]
        is_best = sel & (dsel == col_best[None, :])
        # tie-break: smallest scene index among equal distances
        iota_s = jnp.arange(S, dtype=dtype)[:, None]
        sid = jnp.where(is_best, iota_s, jnp.inf)
        first = jnp.min(sid, axis=0)                            # [M]
        sel = is_best & (sid == first[None, :])

    pair_mask = jnp.any(sel, axis=1)
    paired = jax.lax.dot(sel.astype(dtype), payload.astype(dtype),
                         precision=jax.lax.Precision.HIGHEST)
    return idx, jnp.where(scene_mask, best, jnp.inf), pair_mask, paired


def projective_pairs_3d(model: jnp.ndarray, scene: jnp.ndarray,
                        scene_mask: jnp.ndarray, P: jnp.ndarray,
                        width: int, height: int):
    """Projective data association (ProjectivePairAssignment.cpp:28-97):
    model points rasterized into a width×height index image through the
    3×4 projection P; each scene point projects to a pixel and pairs
    with the model point stored there.

    Vectorized: the model rasterization is a max-scatter (the reference's
    sequential overwrite keeps the last-written point; `max` keeps the
    highest index — one of the writers, deterministic).  The reference
    treats an index-image value of 0 as "no model point" (so model point
    0 is unmatchable — quirk replicated).

    Returns (model_idx [S], dist2 [S], pair_mask [S]).
    """
    def project(pts):
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        dw = P[2, 0] * x + P[2, 1] * y + P[2, 2] * z + P[2, 3]
        ok = jnp.abs(dw) > 1e-9
        du = (P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + P[0, 3]) / dw
        dv = (P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + P[1, 3]) / dw
        u = jnp.floor(du + 0.5).astype(jnp.int32)
        v = jnp.floor(dv + 0.5).astype(jnp.int32)
        inb = (u >= 0) & (v >= 0) & (u < width) & (v < height)
        pix = jnp.clip(v, 0, height - 1) * width + jnp.clip(u, 0, width - 1)
        return pix, ok & inb

    m_pix, m_ok = project(model)
    img = jnp.zeros((width * height,), jnp.int32)
    img = img.at[m_pix].max(jnp.where(m_ok, jnp.arange(model.shape[0]), 0))

    s_pix, s_ok = project(scene)
    idx_m = img[s_pix]
    pair = scene_mask & s_ok & (idx_m != 0)
    d2 = jnp.sum((scene - model[idx_m]) ** 2, axis=1)
    return idx_m, jnp.where(pair, d2, jnp.inf), pair

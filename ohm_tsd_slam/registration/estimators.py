"""Rigid-transform estimators on masked pair sets.

Replicates ClosedFormEstimator2D (src/obvision/registration/icp/
ClosedFormEstimator2D.cpp) and PointToLine2DEstimator
(src/obvision/registration/icp/PointToLineEstimator2D.cpp) as pure
functions over beam-aligned arrays + pair masks.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ohm_tsd_slam.core import se2


def _masked_mean(x: jnp.ndarray, mask: jnp.ndarray, n: jnp.ndarray):
    return jnp.sum(jnp.where(mask, x, 0.0)) / n


def closed_form_2d(model: jnp.ndarray, scene: jnp.ndarray,
                   model_idx: jnp.ndarray, pair_mask: jnp.ndarray
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Closed-form 2D point-to-point rigid fit + RMS.

    Exact formulas of ClosedFormEstimator2D::setPairs (centroids + mean
    squared pair distance, :36-67) and ::estimateTransformation
    (Δθ = atan2(Σ(yF·xS − xF·yS), Σ(xF·xS + yF·yS)) on centered pairs;
    translation from rotated centroids, :74-109).

    Args:
      model: (M, 2); scene: (S, 2) current scene points.
      model_idx: (S,) nearest model index per scene point.
      pair_mask: (S,) active pairs.
    Returns:
      (T, rms): (3,3) transform mapping scene toward model, and the mean
      squared pair distance *before* the transform (the reference's
      "RMS", Icp.cpp:428).
    """
    pm = model[model_idx]                     # (S, 2) paired model points
    return closed_form_2d_paired(pm, scene, pair_mask)


def closed_form_2d_paired(pm: jnp.ndarray, scene: jnp.ndarray,
                          pair_mask: jnp.ndarray
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """closed_form_2d on pre-gathered paired model points `pm` (S, 2)
    (values outside pair_mask are ignored) — the entry point of the
    fused gather-free ICP iteration (registration/icp.py)."""
    model = pm
    n = jnp.maximum(jnp.sum(pair_mask), 1).astype(model.dtype)

    rms = _masked_mean(jnp.sum((pm - scene) ** 2, axis=1), pair_mask, n)

    cmx = _masked_mean(pm[:, 0], pair_mask, n)
    cmy = _masked_mean(pm[:, 1], pair_mask, n)
    csx = _masked_mean(scene[:, 0], pair_mask, n)
    csy = _masked_mean(scene[:, 1], pair_mask, n)

    xf = pm[:, 0] - cmx
    yf = pm[:, 1] - cmy
    xs = scene[:, 0] - csx
    ys = scene[:, 1] - csy
    nom = jnp.sum(jnp.where(pair_mask, yf * xs - xf * ys, 0.0))
    den = jnp.sum(jnp.where(pair_mask, xf * xs + yf * ys, 0.0))
    dtheta = jnp.arctan2(nom, den)

    c, s = jnp.cos(dtheta), jnp.sin(dtheta)
    dx = cmx - (c * csx - s * csy)
    dy = cmy - (c * csy + s * csx)

    row0 = jnp.stack([c, -s, dx])
    row1 = jnp.stack([s, c, dy])
    row2 = jnp.array([0.0, 0.0, 1.0], model.dtype)
    return jnp.stack([row0, row1, row2]), rms


def point_to_line_2d(model: jnp.ndarray, normals: jnp.ndarray,
                     scene: jnp.ndarray, model_idx: jnp.ndarray,
                     pair_mask: jnp.ndarray
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Point-to-line estimator (PointToLineEstimator2D.cpp:86-157):
    linearized normal equations A·[ψ tx ty]ᵀ = b with per-pair model
    normals (unknowns ordered [ψ, tx, ty] as in the reference, :129-156);
    RMS is the mean *absolute* point-to-line residual (:59-73).
    """
    pm = model[model_idx]
    nrm = normals[model_idx]
    return point_to_line_2d_paired(pm, nrm, scene, pair_mask)


def point_to_line_2d_paired(pm: jnp.ndarray, nrm: jnp.ndarray,
                            scene: jnp.ndarray, pair_mask: jnp.ndarray
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """point_to_line_2d on pre-gathered paired model points/normals."""
    model = pm
    n = jnp.maximum(jnp.sum(pair_mask), 1).astype(model.dtype)

    # point-to-line residual r = n · (s - m)
    r = jnp.sum(nrm * (scene - pm), axis=1)
    rms = _masked_mean(jnp.abs(r), pair_mask, n)

    # a_z = x_s * ny - y_s * nx (moment term, :111)
    a = scene[:, 0] * nrm[:, 1] - scene[:, 1] * nrm[:, 0]
    J = jnp.stack([a, nrm[:, 0], nrm[:, 1]], axis=1)     # (S, 3)
    w = pair_mask[:, None].astype(model.dtype)
    A = (J * w).T @ J
    b = (J * w).T @ jnp.where(pair_mask, -r, 0.0)
    sol = jnp.linalg.solve(A + 1e-12 * jnp.eye(3, dtype=model.dtype), b)
    psi, tx, ty = sol[0], sol[1], sol[2]

    c, s = jnp.cos(psi), jnp.sin(psi)
    row0 = jnp.stack([c, -s, tx])
    row1 = jnp.stack([s, c, ty])
    row2 = jnp.array([0.0, 0.0, 1.0], model.dtype)
    return jnp.stack([row0, row1, row2]), rms

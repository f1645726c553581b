"""Direct scan-to-map registration: Gauss-Newton on the TSD field.

No analogue in the reference — this is the direct registration path
SURVEY.md section 7 step 5b calls for.  Where the reference pipeline
renders a model scan (RayCastPolar2D), finds nearest-neighbor pairs
(FlannPairAssignment) and fits a rigid transform per ICP iteration
(ClosedFormEstimator2D), this matcher aligns the scene scan *directly
against the TSD field*: the truncated signed distance at a transformed
scene point IS the point-to-surface residual, and its bilinear spatial
gradient IS the residual Jacobian.  One Gauss-Newton iteration is a
handful of fused element-wise passes over the B scene points plus a 3x3
solve — no raycast, no NN search, no pair filtering.

This is the same objective family as the reference's TSD_PDFMatching
scorer (src/obvision/registration/ransacMatching/TSD_PDFMatching.cpp:
223-251, which rates candidate poses by |tsd| at control points) but
optimized with second-order steps instead of RANSAC sampling.

Conventions match the ICP engine (registration/icp.py): scene points are
in the sensor frame, `sensor_pose` maps sensor to world, and the returned
T is the sensor-frame correction, i.e. the new pose is pose @ T
(ThreadLocalize.cpp:397).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid.state import TsdGrid


class GnResult(NamedTuple):
    T: jnp.ndarray           # (3,3) scene->model correction (sensor frame)
    rms: jnp.ndarray         # weighted RMS of the final TSD residual [m]
    matches: jnp.ndarray     # number of scene points on informative field
    iterations: jnp.ndarray  # iterations executed (== params.iterations)


@dataclass(frozen=True)
class GnParams:
    """Static Gauss-Newton parameters (hashable)."""

    iterations: int = 30
    damping: float = 1e-4        # Levenberg diagonal damping (relative)
    huber_delta: float = 0.3     # Huber threshold on the residual [m]
    min_matches: int = 10        # below this, return identity


def _field_value_grad(grid: TsdGrid, x: jnp.ndarray
                      ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                                 jnp.ndarray]:
    """Bilinear TSD value and its exact spatial gradient at world points.

    Same cell convention as TsdGrid::coord2Cell (TsdGrid.h:306-340); the
    gradient is the analytic derivative of the bilinear surface (the
    reference's interpolateNormal central differences approximate this,
    TsdGrid.cpp:517-546).  NaN taps invalidate the point.
    """
    tsd = grid.tsd
    H, W = tsd.shape
    s = grid.cell_size
    u = x[..., 0] / s - 0.5
    v = x[..., 1] / s - 0.5
    ix = jnp.floor(u).astype(jnp.int32)
    iy = jnp.floor(v).astype(jnp.int32)
    wx = u - ix
    wy = v - iy
    valid = (ix >= 0) & (ix < W - 1) & (iy >= 0) & (iy < H - 1)
    ixc = jnp.clip(ix, 0, W - 2)
    iyc = jnp.clip(iy, 0, H - 2)
    v00 = tsd[iyc, ixc]
    v10 = tsd[iyc + 1, ixc]
    v01 = tsd[iyc, ixc + 1]
    v11 = tsd[iyc + 1, ixc + 1]
    finite = ~(jnp.isnan(v00) | jnp.isnan(v10) | jnp.isnan(v01)
               | jnp.isnan(v11))
    v00, v10, v01, v11 = (jnp.nan_to_num(t) for t in (v00, v10, v01, v11))
    val = (v00 * (1.0 - wy) * (1.0 - wx) + v10 * wy * (1.0 - wx)
           + v01 * (1.0 - wy) * wx + v11 * wy * wx)
    gx = ((v01 - v00) * (1.0 - wy) + (v11 - v10) * wy) / s
    gy = ((v10 - v00) * (1.0 - wx) + (v11 - v01) * wx) / s
    ok = valid & finite
    return val, gx, gy, ok


def match_gauss_newton(grid: TsdGrid, sensor_pose: jnp.ndarray,
                       scene: jnp.ndarray, scene_mask: jnp.ndarray,
                       params: GnParams,
                       T_init: jnp.ndarray = None,
                       field_fn=None, reduce_fn=None,
                       max_truncation: float = None) -> GnResult:
    """Align `scene` (sensor frame, [B,2]) to the TSD surface.

    Args:
      grid: map state (may be None when `field_fn` is given).
      sensor_pose: (3,3) current sensor pose (sensor -> world).
      scene: (B,2) scene points in the sensor frame.
      scene_mask: (B,) validity.
      params: static parameters.
      T_init: optional (3,3) sensor-frame seed (e.g. a RANSAC pre-match).
      field_fn: optional `x [B,2] -> (val, gx, gy, ok)` replacing the
        grid taps — the row-sharded path plugs a shard-local evaluation
        in here (parallel/shard_matchers.py); `ok` must then be False
        for points the shard does not own.
      reduce_fn: optional reduction applied to the per-iteration normal
        equations (H, b, n, wsum, wee) — a psum over the mesh axis in
        the sharded path; identity otherwise.

    Returns:
      GnResult with the sensor-frame correction T (new pose = pose @ T).
    """
    dtype = scene.dtype if grid is None else grid.tsd.dtype
    scene = scene.astype(dtype)
    pose = sensor_pose.astype(dtype)
    if field_fn is None:
        field_fn = lambda x: _field_value_grad(grid, x)  # noqa: E731
    if reduce_fn is None:
        reduce_fn = lambda stats: stats                  # noqa: E731
    trunc = jnp.asarray(grid.max_truncation if max_truncation is None
                        else max_truncation, dtype)
    if T_init is None:
        T_init = jnp.eye(3, dtype=dtype)
    M0 = pose @ T_init.astype(dtype)

    lam = jnp.asarray(params.damping, dtype)
    delta = jnp.asarray(params.huber_delta, dtype)
    w_scene = scene_mask.astype(dtype)

    def body(M, _):
        x = se2.transform_points(M, scene)               # [B,2] world
        val, gx, gy, ok = field_fn(x)
        e = val * trunc                                  # residual [m]
        g = jnp.stack([gx, gy], axis=-1) * trunc         # d e / d x

        # informative points: on a field slope (saturated +-1 plateaus
        # far from any surface have zero gradient and contribute nothing)
        gnorm2 = jnp.sum(g * g, axis=-1)
        w = w_scene * ok.astype(dtype) * (gnorm2 > 1e-12)

        # Huber reweighting
        abs_e = jnp.abs(e)
        w = w * jnp.where(abs_e <= delta, 1.0,
                          delta / jnp.maximum(abs_e, 1e-12))

        # rotate about the current sensor position (world)
        c = M[:2, 2]
        px = x[:, 0] - c[0]
        py = x[:, 1] - c[1]
        J = jnp.stack([g[:, 0], g[:, 1],
                       -g[:, 0] * py + g[:, 1] * px], axis=-1)  # [B,3]

        Jw = J * w[:, None]
        Hm = J.T @ Jw                                    # 3x3
        b = Jw.T @ e                                     # 3
        n = jnp.sum(w > 0)
        wsum_l = jnp.sum(w)
        wee_l = jnp.sum(w * e * e)
        Hm, b, n, wsum_l, wee_l = reduce_fn((Hm, b, n, wsum_l, wee_l))
        Hd = Hm + lam * jnp.diag(jnp.maximum(jnp.diag(Hm), 1e-12)) \
            + 1e-12 * jnp.eye(3, dtype=dtype)
        step = jnp.linalg.solve(Hd, -b)
        enough = n >= params.min_matches
        step = jnp.where(enough, step, jnp.zeros(3, dtype))

        dtheta = step[2]
        cth, sth = jnp.cos(dtheta), jnp.sin(dtheta)
        R = jnp.array([[cth, -sth], [sth, cth]])
        t = c - R @ c + step[:2]
        Tw = jnp.eye(3, dtype=dtype).at[:2, :2].set(R).at[:2, 2].set(t)
        M_new = Tw @ M

        wsum = jnp.maximum(wsum_l, 1e-12)
        rms = jnp.sqrt(wee_l / wsum)
        return M_new, (rms, n)

    M_final, (rms_hist, n_hist) = jax.lax.scan(
        body, M0, None, length=params.iterations)
    T = se2.invert(pose) @ M_final
    return GnResult(T=T, rms=rms_hist[-1], matches=n_hist[-1],
                    iterations=jnp.asarray(params.iterations))


match_gauss_newton_jit = jax.jit(match_gauss_newton,
                                 static_argnames=("params",))

"""ICP engine as a single jit-compiled `lax.scan`.

Redesign of the reference's Icp class
(src/obvision/registration/icp/Icp.cpp): the strategy-pattern objects
(PairAssignment + pre/post filters + IRigidEstimator) become one fused
iteration body; variable-length pair vectors become fixed-shape masks;
the while-loop with early exit (Icp.cpp:493-508) becomes a scan whose
carry freezes once converged (identical trajectory, XLA-friendly).

Semantics replicated:
  * iterate: optional Tinit pre-transform, rms<=maxRMS / rms-plateau
    (|Δrms| < 10e-10 for conv_cnt iterations) / max-iteration exits
    (Icp.cpp:480-511)
  * step: assign → (filters) → estimator RMS → estimate → apply →
    Tfinal = Tlast·Tfinal (Icp.cpp:410-462), NOTMATCHABLE when <3 pairs
  * the shrinking distance gate restarts each registration
    (Icp::reset → PairAssignment::reset, Icp.cpp:333-339)
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ohm_tsd_slam.config import IcpConfig
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.registration import filters as flt
from ohm_tsd_slam.registration.estimators import (
    closed_form_2d,
    closed_form_2d_paired,
    point_to_line_2d,
    point_to_line_2d_paired,
)
from ohm_tsd_slam.registration.nn import (
    assign_pairs_fused,
    nearest_neighbors,
)


class IcpState(enum.IntEnum):
    """EnumIcpState (Icp.h:25-32)."""

    IDLE = 0
    PROCESSING = 1
    NOTMATCHABLE = 2
    MAXITERATIONS = 3
    TIMEELAPSED = 4
    SUCCESS = 5
    CONVERGED = 6
    ERROR = 7


class IcpResult(NamedTuple):
    T: jnp.ndarray            # (3,3) final scene->model transform
    rms: jnp.ndarray          # last RMS (mean squared pair distance)
    pairs: jnp.ndarray        # last pair count
    iterations: jnp.ndarray   # iterations executed
    state: jnp.ndarray        # IcpState code
    # per-iteration history (for the Trace subsystem; zeros after exit)
    rms_history: jnp.ndarray
    pair_history: jnp.ndarray
    # per-iteration pair assignments ([iters, S] model index / active
    # mask), populated when IcpParams.record_pairs (Trace's
    # addAssignment pair payload, Trace.cpp:123-142)
    pair_idx_history: jnp.ndarray = None
    pair_mask_history: jnp.ndarray = None
    # per-iteration accumulated transforms ([iters, 3, 3]; frozen copies
    # of T after exit), populated when IcpParams.record_T — used by the
    # golden per-iteration parity diff vs the compiled reference
    # (Icp.cpp:493-508 loop states)
    T_history: jnp.ndarray = None


@dataclass(frozen=True)
class IcpParams:
    """Static ICP parameters (hashable; safe as jit static arg)."""

    iterations: int = 25
    max_rms: float = 0.0
    convergence_count: int = 5
    conv_eps: float = 10e-10          # rms-plateau epsilon (Icp.cpp:498)
    dist_min: float = 0.2
    dist_max: float = 1.0
    # DistanceFilter's own iteration count controlling the shrink rate
    # (None = iterations).  ThreadLocalize constructs it with
    # icpIterations - 10 — as an UNSIGNED int (DistanceFilter.h:20), so
    # icp_iterations < 10 wraps to ~2^32 and the gate barely shrinks;
    # IcpParams.from_config replicates that quirk
    # (ThreadLocalize.cpp:213).
    dist_iterations: Optional[int] = None
    use_distance_filter: bool = True
    use_reciprocal_filter: bool = True
    # grid AABB for the out-of-bounds prefilter (ThreadLocalize.cpp:218)
    bounds: Optional[Tuple[float, float, float, float]] = None
    # rigid estimator strategy (Icp::setRigidEstimator, Icp.h:39-314):
    # "closed_form" (ClosedFormEstimator2D, the reference default) or
    # "point_to_line" (PointToLine2DEstimator; needs model normals)
    estimator: str = "closed_form"
    # record per-iteration pair assignments for the Trace subsystem
    # (costly: [iters, S] extra outputs — off by default)
    record_pairs: bool = False
    # record per-iteration accumulated transforms (golden parity diff)
    record_T: bool = False
    # fused dense iteration body (nn.assign_pairs_fused): NN + gates +
    # reciprocal rule + payload gather as pure [S, M] dense ops — no
    # scatters/gathers.  Bit-identical
    # to the modular chain (asserted in tests); keep False to run the
    # modular reference path.
    fused: bool = True

    @staticmethod
    def from_config(cfg: IcpConfig, bounds=None) -> "IcpParams":
        # ThreadLocalize's stack: DistanceFilter(max, min,
        # (unsigned)(icpIterations - 10)), convergence counter =
        # icpIterations (ThreadLocalize.cpp:213,226)
        dist_it = cfg.dist_iterations
        if dist_it is None:
            dist_it = (cfg.iterations - 10) & 0xFFFFFFFF
        conv = cfg.convergence_count
        if conv is None:
            conv = cfg.iterations
        return IcpParams(
            iterations=cfg.iterations,
            max_rms=cfg.max_rms,
            convergence_count=conv,
            dist_min=cfg.dist_filter_min,
            dist_max=cfg.dist_filter_max,
            dist_iterations=dist_it,
            use_distance_filter=cfg.use_distance_filter,
            use_reciprocal_filter=cfg.use_reciprocal_filter,
            bounds=bounds,
            estimator=cfg.estimator,
        )


def icp(model: jnp.ndarray, model_mask: jnp.ndarray,
        scene: jnp.ndarray, scene_mask: jnp.ndarray,
        params: IcpParams,
        T_init: Optional[jnp.ndarray] = None,
        sensor_pose: Optional[jnp.ndarray] = None,
        model_normals: Optional[jnp.ndarray] = None) -> IcpResult:
    """Register `scene` onto `model`.

    Args:
      model: (M, 2) model points (beam-aligned); model_mask: (M,).
      scene: (S, 2) scene points (beam-aligned);  scene_mask: (S,).
      params: static parameters.
      T_init: optional (3,3) initial transform (the RANSAC seed embedded
        at ThreadLocalize.cpp:539-565 / applied at Icp.cpp:482-487).
      sensor_pose: (3,3) pose for the out-of-bounds prefilter (the filter
        maps scene points to world coords; ThreadLocalize.cpp:571-573).
      model_normals: (M, 2) model normals, required by the
        "point_to_line" estimator (raycast normals in the reference,
        ThreadLocalize.cpp:353).
    Returns:
      IcpResult with T = accumulated transform (includes T_init).
    """
    dtype = scene.dtype
    M = model.shape[0]
    if T_init is None:
        T_init = jnp.eye(3, dtype=dtype)
    if sensor_pose is None:
        sensor_pose = jnp.eye(3, dtype=dtype)
    if params.estimator == "point_to_line":
        if model_normals is None:
            raise ValueError("point_to_line estimator requires model_normals")
        def estimate(m, sc, idx, pm):
            return point_to_line_2d(m, model_normals, sc, idx, pm)
    elif params.estimator == "closed_form":
        estimate = closed_form_2d
    else:
        raise ValueError(f"unknown estimator {params.estimator!r}")

    dist_it = (params.dist_iterations if params.dist_iterations is not None
               else params.iterations)
    thresh2 = flt.distance_threshold_schedule(
        params.dist_max, params.dist_min, dist_it,
        length=params.iterations).astype(dtype)

    if params.fused:
        # paired payload: model xy (+ normals for point_to_line)
        if params.estimator == "point_to_line":
            payload = jnp.concatenate([model, model_normals], axis=1)
        else:
            payload = model

    def body(carry, it):
        T, rms_prev, conv_cnt, done, state = carry
        scene_cur = se2.transform_points(T, scene)

        smask = scene_mask
        if params.bounds is not None:
            x0, x1, y0, y1 = params.bounds
            smask = flt.out_of_bounds_filter_2d(
                scene_cur, smask, sensor_pose, x0, x1, y0, y1)

        if params.fused:
            idx, d2, pmask, paired = assign_pairs_fused(
                model, model_mask, scene_cur, smask, payload,
                thresh2=thresh2[it] if params.use_distance_filter else None,
                use_reciprocal=params.use_reciprocal_filter)
        else:
            idx, d2 = nearest_neighbors(model, model_mask, scene_cur,
                                        smask)
            pmask = smask & jnp.isfinite(d2)
            if params.use_distance_filter:
                pmask = flt.distance_filter(d2, pmask, thresh2[it])
            if params.use_reciprocal_filter:
                pmask = flt.reciprocal_filter(idx, d2, pmask, M)

        npairs = jnp.sum(pmask)
        matchable = npairs > 2      # Icp.cpp:421

        if params.fused:
            if params.estimator == "point_to_line":
                T_last, rms = point_to_line_2d_paired(
                    paired[:, :2], paired[:, 2:], scene_cur, pmask)
            else:
                T_last, rms = closed_form_2d_paired(
                    paired, scene_cur, pmask)
        else:
            T_last, rms = estimate(model, scene_cur, idx, pmask)
        T_new = jnp.where(matchable, T_last @ T, T)
        rms = jnp.where(matchable, rms, rms_prev)

        plateau = jnp.abs(rms - rms_prev) < params.conv_eps
        conv_new = jnp.where(plateau, conv_cnt + 1, 0)
        success = matchable & ((rms <= params.max_rms)
                               | (conv_new >= params.convergence_count))
        maxed = it + 1 >= params.iterations

        new_state = jnp.where(
            ~matchable, IcpState.NOTMATCHABLE,
            jnp.where(success, IcpState.SUCCESS,
                      jnp.where(maxed, IcpState.MAXITERATIONS,
                                IcpState.PROCESSING)))

        # freeze once done (reference exits its while loop here)
        out_T = jnp.where(done, T, T_new)
        out_rms = jnp.where(done, rms_prev, rms)
        out_conv = jnp.where(done, conv_cnt, conv_new)
        out_state = jnp.where(done, state, new_state)
        new_done = done | ~matchable | success
        hist = (jnp.where(done, jnp.nan, rms),
                jnp.where(done, 0, npairs),
                jnp.where(done, 0, 1))
        if params.record_pairs:
            hist = hist + (idx.astype(jnp.int32),
                           pmask & ~done)
        if params.record_T:
            hist = hist + (out_T,)
        return (out_T, out_rms, out_conv, new_done, out_state), hist

    init = (T_init, jnp.asarray(10e12, dtype), jnp.asarray(0, jnp.int32),
            jnp.asarray(False), jnp.asarray(int(IcpState.PROCESSING),
                                            jnp.int32))
    (T, rms, _, _, state), hists = jax.lax.scan(
        body, init, jnp.arange(params.iterations))
    rms_h, pair_h, ran = hists[:3]

    iters = jnp.sum(ran)
    last = jnp.maximum(iters - 1, 0)
    k = 3
    pair_idx_h = pair_mask_h = T_h = None
    if params.record_pairs:
        pair_idx_h, pair_mask_h = hists[k], hists[k + 1]
        k += 2
    if params.record_T:
        T_h = hists[k]
    return IcpResult(
        T=T, rms=rms, pairs=pair_h[last], iterations=iters,
        state=state, rms_history=rms_h, pair_history=pair_h,
        pair_idx_history=pair_idx_h, pair_mask_history=pair_mask_h,
        T_history=T_h)


icp_jit = jax.jit(icp, static_argnames=("params",))

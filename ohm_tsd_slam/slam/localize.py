"""Per-robot localization pipeline.

Redesign of ThreadLocalize (src/ThreadLocalize.cpp).  The
reference's per-scan event loop body (raycast model → Cartesian scene →
RANSAC pre-match → ICP → error gate → pose update) becomes ONE jitted
step function `localize_step` over the functional grid state; the
surrounding thread/queue machinery lives in slam.node.

Semantics replicated (citations inline):
  * model rendering via masked raycast              (ThreadLocalize.cpp:353)
  * scene conversion + standard mask                (:328-329,361)
  * registration dispatch by mode                   (:513-591)
  * registration error gate ‖t‖ > trnsMax or
    |sin Δφ| > rotMax → NaN pose sentinel           (:381-387,593-600)
  * pose update by right-multiplication             (:397; Sensor.cpp:50-60)
  * significance gate for map updates
    (|sin Δφ| > ROT_MIN or ‖Δt‖ > TRNS_MIN)         (:402,728-736)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ohm_tsd_slam.config import (
    BeamModelConfig,
    OdomRescueConfig,
    RegistrationConfig,
    RegMode,
)
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid.raycast import raycast
from ohm_tsd_slam.grid.raycast_fast import (
    SegmentCache,
    raycast_checked,
    raycast_fast,
)
from ohm_tsd_slam.grid.state import TsdGrid
from ohm_tsd_slam.registration.amcl import AmclParams, match_amcl
from ohm_tsd_slam.registration.gauss_newton import (
    GnParams,
    match_gauss_newton,
)
from ohm_tsd_slam.registration.icp import IcpParams, icp
from ohm_tsd_slam.registration.ransac import (
    RansacParams,
    match_normal,
    match_pdf,
    match_tsd,
)
from ohm_tsd_slam.slam import odometry
from ohm_tsd_slam.sensor.polar2d import (
    SensorPolar2D,
    data_to_cartesian,
)


def calc_angle_02pi(T: jnp.ndarray) -> jnp.ndarray:
    """ThreadLocalize::calcAngle (ThreadLocalize.cpp:715-726): angle in
    [0, 2π) recovered from asin/acos of the rotation entries, returning 0
    when the sign pattern matches neither branch (e.g. θ == 0)."""
    arcsin = jnp.arcsin(jnp.clip(T[1, 0], -1.0, 1.0))
    arcsineg = jnp.arcsin(jnp.clip(T[0, 1], -1.0, 1.0))
    arccos = jnp.arccos(jnp.clip(T[0, 0], -1.0, 1.0))
    return jnp.where((arcsin > 0.0) & (arcsineg < 0.0), arccos,
                     jnp.where((arcsin < 0.0) & (arcsineg > 0.0),
                               2.0 * jnp.pi - arccos, 0.0))


def is_registration_error(T: jnp.ndarray, trns_max: float,
                          rot_max: float) -> jnp.ndarray:
    """ThreadLocalize::isRegistrationError (ThreadLocalize.cpp:593-600)."""
    trns = jnp.sqrt(T[0, 2] ** 2 + T[1, 2] ** 2)
    dphi = calc_angle_02pi(T)
    return (trns > trns_max) | (jnp.abs(jnp.sin(dphi)) > rot_max)


def is_pose_change_significant(last_pose: jnp.ndarray,
                               cur_pose: jnp.ndarray,
                               trns_min: float,
                               rot_min: float) -> jnp.ndarray:
    """ThreadLocalize::isPoseChangeSignificant (ThreadLocalize.cpp:728-736)."""
    dx = cur_pose[0, 2] - last_pose[0, 2]
    dy = cur_pose[1, 2] - last_pose[1, 2]
    dphi = calc_angle_02pi(cur_pose) - calc_angle_02pi(last_pose)
    dphi = jnp.abs(jnp.sin(dphi))
    trns = jnp.sqrt(dx * dx + dy * dy)
    return (dphi > rot_min) | (trns > trns_min)


class LocalizeResult(NamedTuple):
    pose: jnp.ndarray          # (3,3) updated sensor pose (unchanged on error)
    T: jnp.ndarray             # (3,3) estimated scene->model transform
    reg_error: jnp.ndarray     # bool — NaN-pose sentinel condition
    significant: jnp.ndarray   # bool — push pose to mapper
    model_valid: jnp.ndarray   # number of valid model points
    scene_valid: jnp.ndarray   # number of valid scene points
    rms: jnp.ndarray
    icp_iterations: jnp.ndarray
    # fast-raycast capacity-overflow count.  Nonzero means the splat
    # caster overflowed and the guarded fallback re-rendered the scan
    # with the exact march (no beams were lost); surfaced so the node
    # can log overflow pressure instead of silently ignoring it.
    rays_dropped: jnp.ndarray = None


@dataclass(frozen=True)
class LocalizeParams:
    """Static per-robot localization parameters (hashable)."""

    geom: SensorPolar2D
    icp: IcpParams
    mode: int = int(RegMode.ICP)
    trns_max: float = 0.25
    rot_max: float = 0.17
    trns_min: float = 0.05
    rot_min: float = 0.03
    # splat+refine renderer (grid/raycast_fast.py) instead of the dense
    # march — same model points on >98% of beams.
    # The production path always runs the GUARDED variant
    # (raycast_checked): if the splat caster's fixed segment capacity
    # overflows, the exact dense march re-renders the scan, so no beam
    # is silently lost (the no-silent-caps rule).
    fast_raycast: bool = True
    # RANSAC pre-registration parameters (modes EXP/PDF/TSD)
    ransac: Optional[RansacParams] = None
    beam: Optional[BeamModelConfig] = None
    # direct Gauss-Newton matcher (mode GN)
    gn: GnParams = GnParams()
    # particle-filter matcher (mode AMCL)
    amcl: AmclParams = AmclParams()
    # optional odometry rescue (OdometryAnalyzer call sites,
    # ThreadLocalize.cpp:263-265,334-336,586-588)
    odom: Optional[odometry.OdomRescueParams] = None

    @staticmethod
    def from_config(reg: RegistrationConfig, geom: SensorPolar2D,
                    bounds=None, odom_cfg: Optional[OdomRescueConfig] = None,
                    cell_size: float = 0.025) -> "LocalizeParams":
        odom_params = None
        if odom_cfg is not None and odom_cfg.use_odom_rescue:
            odom_params = odometry.OdomRescueParams(
                tf_laser=(odom_cfg.laser_x, odom_cfg.laser_y,
                          odom_cfg.laser_yaw),
                trns_vel_max=odom_cfg.trns_vel_max,
                rot_vel_max=odom_cfg.rot_vel_max,
                cell_size=cell_size,
            )
        return LocalizeParams(
            geom=geom,
            icp=IcpParams.from_config(reg.icp, bounds=bounds),
            mode=int(reg.mode),
            trns_max=reg.trns_thresh,
            rot_max=reg.rot_thresh,
            trns_min=reg.trns_min,
            rot_min=reg.rot_min,
            ransac=RansacParams.from_config(reg.ransac, geom.angular_res),
            beam=reg.beam_model,
            amcl=AmclParams(
                particles=reg.amcl.particles,
                iterations=reg.amcl.iterations,
                sigma_trans=reg.amcl.sigma_trans,
                sigma_rot=reg.amcl.sigma_rot,
            ),
            odom=odom_params,
        )


def localize_step(grid: TsdGrid, pose: jnp.ndarray, last_pose: jnp.ndarray,
                  data: jnp.ndarray, mask: jnp.ndarray,
                  params: LocalizeParams,
                  T_prereg: Optional[jnp.ndarray] = None,
                  key: Optional[jax.Array] = None,
                  odom_state: Optional[odometry.OdomState] = None,
                  segments: Optional[SegmentCache] = None
                  ) -> LocalizeResult:
    """One localization cycle (the body of ThreadLocalize::eventLoop,
    ThreadLocalize.cpp:310-409).

    Args:
      grid: current map state.
      pose: (3,3) current sensor pose estimate.
      last_pose: pose at the last map update (significance reference).
      data, mask: masked scan (after standard_mask/clamp).
      params: static parameters.
      T_prereg: optional externally computed RANSAC seed (3,3); overrides
        the built-in matcher dispatch.
      key: PRNG key for the stochastic matchers (modes EXP/PDF/TSD/AMCL;
        doRegistration dispatch, ThreadLocalize.cpp:530-568).  The caller
        must supply a fresh key per scan (SlamNode folds the per-robot
        scan counter in); the PRNGKey(0) fallback exists only for direct
        library use.
      odom_state: optional odometry-rescue state (odomRescueUpdate must
        have been applied for this scan; see slam.odometry).  Requires
        params.odom; applied between registration and the error gate at
        the reference's commented-out call site
        (ThreadLocalize.cpp:586-588).
      segments: optional extract_segments() cache for THIS grid version
        — skips the pose-independent isocontour extraction inside the
        raycast (the node rebuilds it after every mapper drain).
    """
    geom = params.geom

    def finish(T, model_ok, model_valid, scene_valid, rms, iters,
               rays_dropped=None):
        # optional odometry rescue (OdometryAnalyzer::odomRescueCheck)
        if params.odom is not None and odom_state is not None:
            T, _rescued = odometry.check(odom_state, params.odom, T)
        # failure gate + pose update
        err = is_registration_error(T, params.trns_max, params.rot_max)
        err = err | ~model_ok
        new_pose = jnp.where(err, pose, pose @ T)
        significant = (~err) & is_pose_change_significant(
            last_pose, new_pose, params.trns_min, params.rot_min)
        if rays_dropped is None:
            rays_dropped = jnp.asarray(0, jnp.int32)
        return LocalizeResult(
            pose=new_pose, T=T, reg_error=err, significant=significant,
            model_valid=model_valid, scene_valid=scene_valid,
            rms=rms, icp_iterations=iters, rays_dropped=rays_dropped)

    # scene (Sensor::dataToCartesianVectorMask)
    scene, scene_mask = data_to_cartesian(geom, data, mask)

    # Mode GN: direct scan-to-map Gauss-Newton against the TSD field —
    # needs neither the rendered model scan nor NN pairing, so the whole
    # raycast stage is skipped (extension, RegMode.GN).
    if params.mode == int(RegMode.GN) and T_prereg is None:
        gn_res = match_gauss_newton(grid, pose, scene, scene_mask,
                                    params.gn)
        reg_ok = gn_res.matches >= params.gn.min_matches
        return finish(gn_res.T, reg_ok, gn_res.matches,
                      jnp.sum(scene_mask), gn_res.rms, gn_res.iterations)

    # model rendering (reference raycast, beam-aligned masked outputs);
    # the fast path is overflow-guarded: on capacity overflow the exact
    # march re-renders, and the drop count is surfaced in the result
    if params.fast_raycast:
        model = raycast_checked(grid, geom, pose, segments=segments)
    else:
        model = raycast(grid, geom, pose)
    rays_dropped = model.n_dropped

    # registration: pre-match seed + ICP refinement
    if T_prereg is not None:
        T_init = T_prereg
    elif params.mode != int(RegMode.ICP):
        if key is None:
            key = jax.random.PRNGKey(0)
        if params.mode == int(RegMode.EXP):
            T_init = match_normal(key, model.coords, model.mask,
                                  scene, scene_mask, params.ransac)
        elif params.mode == int(RegMode.PDF):
            T_init = match_pdf(key, model.coords, model.mask,
                               scene, scene_mask, params.ransac,
                               params.beam)
        elif params.mode == int(RegMode.AMCL):
            T_init = match_amcl(key, grid, pose, scene, scene_mask,
                                params.amcl)
        else:
            T_init = match_tsd(key, grid, pose, model.coords, model.mask,
                               scene, scene_mask, params.ransac)
    else:
        T_init = jnp.eye(3, dtype=scene.dtype)
    icp_res = icp(model.coords, model.mask, scene, scene_mask,
                  params.icp, T_init=T_init, sensor_pose=pose,
                  model_normals=model.normals)
    model_ok = jnp.sum(model.mask) > 0    # raycast-degenerate guard (:354-358)
    return finish(icp_res.T, model_ok, jnp.sum(model.mask),
                  jnp.sum(scene_mask), icp_res.rms, icp_res.iterations,
                  rays_dropped=rays_dropped)


localize_step_jit = jax.jit(localize_step, static_argnames=("params",))

"""Odometry-rescue / motion-gating module.

Equivalent of OdometryAnalyzer (src/OdometryAnalyzer.{h,cpp}) — the
odometry fallback that replaces an implausible scan-match transform with
the odometry delta.  In the reference this module is compiled but
disconnected (all call sites commented out, ThreadLocalize.cpp:196,233,
263-265,334-336,586-588); here it is a working optional stage.

Functional redesign: where the reference pulls tf transforms from a
tf2 buffer, the caller supplies odometry poses (3,3 SE(2), base frame)
with timestamps; the rescue state is an explicit pytree threaded
through `update`.

Behavioral note (documented divergence): odomRescueCheck's velocity
gates are short-circuited to `if(1)` in the reference
(OdometryAnalyzer.cpp:212-216) — i.e. the checked-in code *always*
replaces T_slam when called.  This implementation applies the intended
gates (dtrans > cellSize/2 and (drot > rot_vel_max·dt or
vtrans > trns_vel_max)), which the commented-out conditions spell out;
pass `always_rescue=True` for the reference's literal behavior.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ohm_tsd_slam.core import se2

# defaults shared with ThreadLocalize (ThreadLocalize.h:56-71)
TRNS_VEL_MAX = 1.5
ROT_VEL_MAX = 6.28


class OdomState(NamedTuple):
    """Functional odometry-rescue state (_tfOdomOld/_tfRelativeOdom/
    _stampLaserOld of the reference)."""

    odom_old: jnp.ndarray       # (3,3) last odometry pose
    rel_odom: jnp.ndarray       # (3,3) odom(t-1)^-1 · odom(t)
    stamp_old: jnp.ndarray      # scalar seconds (previous scan stamp)
    dt: jnp.ndarray             # seconds between the last two scans
    valid: jnp.ndarray          # bool — _odomTfIsValid


@dataclass(frozen=True)
class OdomRescueParams:
    """Static parameters (OdometryAnalyzer.cpp:28-48)."""

    tf_laser: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # laser in base (x, y, yaw)
    trns_vel_max: float = TRNS_VEL_MAX    # "max_velocity_lin"
    rot_vel_max: float = ROT_VEL_MAX      # "max_velocity_rot"
    cell_size: float = 0.025
    always_rescue: bool = False           # reference's literal if(1) paths


def init(params: OdomRescueParams, odom_pose: jnp.ndarray,
         stamp: float) -> OdomState:
    """odomRescueInit (OdometryAnalyzer.cpp:65-111): capture the first
    odometry pose; the static laser transform lives in `params`."""
    dtype = odom_pose.dtype
    return OdomState(
        odom_old=odom_pose,
        rel_odom=jnp.eye(3, dtype=dtype),
        stamp_old=jnp.asarray(stamp, dtype),
        dt=jnp.asarray(1e-6, dtype),
        valid=jnp.asarray(False),
    )


def update(state: OdomState, odom_pose: jnp.ndarray, stamp,
           odom_ok: bool = True) -> OdomState:
    """odomRescueUpdate (OdometryAnalyzer.cpp:113-151): record the
    odometry delta since the previous scan and push the state ahead.
    `odom_ok=False` marks a failed odometry lookup (tf timeout in the
    reference) — the rescue is disabled for this cycle."""
    rel = se2.invert(state.odom_old) @ odom_pose
    stamp = jnp.asarray(stamp, state.stamp_old.dtype)
    return OdomState(
        odom_old=odom_pose,
        rel_odom=rel,
        stamp_old=stamp,
        dt=jnp.maximum(stamp - state.stamp_old, 1e-6),
        valid=jnp.asarray(odom_ok),
    )


def check(state: OdomState, params: OdomRescueParams,
          T_slam: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """odomRescueCheck (OdometryAnalyzer.cpp:153-223): transform T_slam
    into the footprint frame (T_fp = tfLaser · T · tfLaser⁻¹), derive
    velocities over the inter-scan dt recorded by `update`, and when
    implausible replace it with tfLaser⁻¹ · relOdom · tfLaser.

    Returns (T_out, rescued)."""
    dtype = T_slam.dtype
    tl = se2.make(*params.tf_laser, dtype=dtype)
    tl_inv = se2.invert(tl)

    T_fp = tl @ T_slam @ tl_inv
    dt = state.dt
    dtrans = jnp.sqrt(T_fp[0, 2] ** 2 + T_fp[1, 2] ** 2)
    # calcAngle duplicate (OdometryAnalyzer.cpp:225-245)
    drot = _calc_angle(T_fp)
    drot = jnp.minimum(drot, 2.0 * jnp.pi - drot)   # magnitude of rotation
    vtrans = dtrans / dt

    implausible = ((dtrans > params.cell_size * 0.5)
                   & ((drot > params.rot_vel_max * dt)
                      | (vtrans > params.trns_vel_max)))
    rescued = state.valid & (implausible | params.always_rescue)

    T_odom = tl_inv @ state.rel_odom @ tl
    T_out = jnp.where(rescued, T_odom, T_slam)
    return T_out, rescued


def _calc_angle(T: jnp.ndarray) -> jnp.ndarray:
    """OdometryAnalyzer::calcAngle — same formula as
    ThreadLocalize::calcAngle (ThreadLocalize.cpp:715-726)."""
    arcsin = jnp.arcsin(jnp.clip(T[1, 0], -1.0, 1.0))
    arcsineg = jnp.arcsin(jnp.clip(T[0, 1], -1.0, 1.0))
    arccos = jnp.arccos(jnp.clip(T[0, 0], -1.0, 1.0))
    return jnp.where((arcsin > 0.0) & (arcsineg < 0.0), arccos,
                     jnp.where((arcsin < 0.0) & (arcsineg > 0.0),
                               2.0 * jnp.pi - arccos, 0.0))

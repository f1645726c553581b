"""End-to-end SLAM: a simulated robot trajectory through the analytic
room, full localize→map loop, checking trajectory tracking and the
extracted occupancy grid (SURVEY.md §4 test plan, item 5)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from ohm_tsd_slam.config import (
    GridConfig,
    RegistrationConfig,
    IcpConfig,
    RobotConfig,
    SensorConfig,
    SlamConfig,
)
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.slam import LaserScan, SlamNode
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

BEAMS = 361
RES = math.radians(0.75)
PHI0 = math.radians(-135.0)
RMAX = 9.0

# 256 cells @ 0.04 m -> 10.24 m world; world frame == grid frame with the
# robot starting at the grid center.
CFG = SlamConfig(
    grid=GridConfig(map_size=8, cellsize=0.04, truncation_radius=3.0),
    robots=[RobotConfig(
        # trajectory starts at theta=0.2: anchor the SLAM frame there
        # (the reference takes the start pose from local_offset_* params,
        # ThreadLocalize.cpp:466-482)
        local_offset_yaw=0.2,
        sensor=SensorConfig(max_range=RMAX, min_range=0.01,
                            low_reflectivity_range=1.0),
        registration=RegistrationConfig(
            icp=IcpConfig(iterations=30, dist_filter_max=0.5,
                          dist_filter_min=0.05)),
    )],
)

# walls inside the interior tile region (the extractor skips the outer
# tile ring, RayCastAxisAligned2D.cpp:25-27: cells 32..223 here)
WALLS = rect_walls(1.5, 1.5, 8.5, 8.5)
CIRCLES = [((7.0, 7.2), 0.5), ((3.0, 7.5), 0.35)]


def _scan_at(pose_np: np.ndarray, stamp: float) -> LaserScan:
    r = simulate_scan(pose_np, BEAMS, RES, PHI0, RMAX,
                      segments=WALLS, circles=CIRCLES)
    return LaserScan(ranges=r, angle_min=PHI0, angle_increment=RES,
                     range_max=RMAX, stamp=stamp)


def _trajectory(n: int):
    """Slow arc through the room: per-step motion ~2 cm / 0.5 deg."""
    poses = []
    x, y, th = 5.12, 5.12, 0.2
    for k in range(n):
        poses.append((x, y, th))
        x += 0.02 * math.cos(th)
        y += 0.02 * math.sin(th)
        th += math.radians(0.5)
    return poses


def test_slam_tracks_trajectory():
    node = SlamNode(CFG, dtype=jnp.float64)
    gt = _trajectory(30)

    est_err = []
    for k, (x, y, th) in enumerate(gt):
        pose_np = np.array(se2.make(x, y, th, dtype=jnp.float64))
        msg = _scan_at(pose_np, stamp=float(k))
        out = node.process_scan(0, msg)
        if k == 0:
            assert out is None       # first scan initializes
            continue
        assert out is not None and not out.is_nan
        # published pose is grid-frame + grid offset; grid offset is
        # -size/2, world start == grid center => world == published +
        # size/2 ... compare in grid frame directly:
        est = np.asarray(node.localizers[0].pose)
        est_err.append(np.hypot(est[0, 2] - x, est[1, 2] - y))

    est_err = np.array(est_err)
    # localization stays within ~a cell of ground truth
    assert est_err.max() < 2.5 * CFG.grid.cellsize, est_err.max()
    assert est_err[-1] < 2.5 * CFG.grid.cellsize


def test_slam_occupancy_map():
    node = SlamNode(CFG, dtype=jnp.float64)
    for k, (x, y, th) in enumerate(_trajectory(12)):
        pose_np = np.array(se2.make(x, y, th, dtype=jnp.float64))
        node.process_scan(0, _scan_at(pose_np, stamp=float(k)))

    occ_msg, img = node.publish_map()
    occ = occ_msg.data
    assert occ.shape == (256, 256)
    n_occ = int((occ == 100).sum())
    n_free = int((occ == 0).sum())
    assert n_occ > 100          # walls were extracted
    assert n_free > 5000        # interior marked free
    # occupied cells near the wall lines: check a sample on the east wall
    # x = 8.5 m -> cell ~212
    east = occ[:, 208:217]
    assert (east == 100).any()
    # TSD color image present
    assert img is not None and img.data.shape == (256, 256, 3)
    # some green (positive tsd) and some red (negative) pixels exist
    g = img.data[:, :, 1]
    assert (g == 255).any()


def test_slam_registration_failure_nan_sentinel():
    """A teleport (scan from a pose 0.35 m away — within ICP's basin so
    the transform is actually recovered) yields a transform beyond
    reg_trs_max=0.25 -> NaN pose sentinel, pose unchanged
    (ThreadLocalize.cpp:381-387,593-600)."""
    node = SlamNode(CFG, dtype=jnp.float64)
    x, y, th = 5.12, 5.12, 0.2
    pose_np = np.array(se2.make(x, y, th, dtype=jnp.float64))
    node.process_scan(0, _scan_at(pose_np, 0.0))
    # one normal step so we're past init
    node.process_scan(0, _scan_at(pose_np, 1.0))
    pose_before = np.asarray(node.localizers[0].pose)

    tele = np.array(se2.make(x + 0.35, y, th, dtype=jnp.float64))
    out = node.process_scan(0, _scan_at(tele, 2.0))
    assert out is not None and out.is_nan
    np.testing.assert_array_equal(np.asarray(node.localizers[0].pose),
                                  pose_before)


def test_slam_unmatchable_scan_keeps_pose():
    """A degenerate scan (tiny ring) produces <3 pairs -> NOTMATCHABLE ->
    identity transform: the pose is republished unchanged and no NaN is
    emitted (Icp.cpp:421,458; the reference's error gate passes an
    identity transform)."""
    node = SlamNode(CFG, dtype=jnp.float64)
    pose_np = np.array(se2.make(5.12, 5.12, 0.2, dtype=jnp.float64))
    node.process_scan(0, _scan_at(pose_np, 0.0))
    node.process_scan(0, _scan_at(pose_np, 1.0))
    pose_before = np.asarray(node.localizers[0].pose)

    ring = LaserScan(ranges=np.full(BEAMS, 0.3), angle_min=PHI0,
                     angle_increment=RES, range_max=RMAX, stamp=2.0)
    out = node.process_scan(0, ring)
    assert out is not None and not out.is_nan
    np.testing.assert_array_equal(np.asarray(node.localizers[0].pose),
                                  pose_before)


def test_slam_start_stop():
    """start_stop_slam service equivalent (SlamNode.cpp:159-189)."""
    node = SlamNode(CFG, dtype=jnp.float64)
    node.set_active(False)
    pose_np = np.array(se2.make(5.12, 5.12, 0.2, dtype=jnp.float64))
    assert node.process_scan(0, _scan_at(pose_np, 0.0)) is None
    assert not node.localizers[0].initialized
    node.set_active(True)
    node.process_scan(0, _scan_at(pose_np, 1.0))
    assert node.localizers[0].initialized


def test_slam_mode_tsd_f32():
    """End-to-end trajectory in the reference's shipped default mode
    (registration_mode: 3, config/single-laser.yaml) at the production
    dtype float32."""
    import dataclasses
    from ohm_tsd_slam.config import RansacConfig, RegMode

    cfg = dataclasses.replace(
        CFG,
        robots=[dataclasses.replace(
            CFG.robots[0],
            registration=dataclasses.replace(
                CFG.robots[0].registration,
                mode=RegMode.TSD,
                ransac=RansacConfig(trials=50, size_control_set=140,
                                    eps_thresh=0.15, phi_max_deg=30.0)),
        )])
    node = SlamNode(cfg, dtype=jnp.float32)
    gt = _trajectory(12)
    err = []
    for k, (x, y, th) in enumerate(gt):
        pose_np = np.array(se2.make(x, y, th, dtype=jnp.float64))
        out = node.process_scan(0, _scan_at(pose_np, stamp=float(k)))
        if k == 0:
            continue
        assert out is not None and not out.is_nan
        est = np.asarray(node.localizers[0].pose)
        err.append(np.hypot(est[0, 2] - x, est[1, 2] - y))
    assert max(err) < 3.0 * CFG.grid.cellsize, max(err)


def test_slam_distinct_keys_per_scan(monkeypatch):
    """The stochastic matchers must receive a fresh PRNG key per scan
    (the r1 bug: every scan reused PRNGKey(0))."""
    from ohm_tsd_slam.slam import node as node_mod

    seen = []
    orig = node_mod.localize_step_jit

    def spy(*args, **kwargs):
        seen.append(np.array(kwargs["key"]))
        return orig(*args, **kwargs)

    monkeypatch.setattr(node_mod, "localize_step_jit", spy)
    node = SlamNode(CFG, dtype=jnp.float64)
    pose_np = np.array(se2.make(5.12, 5.12, 0.2, dtype=jnp.float64))
    node.process_scan(0, _scan_at(pose_np, 0.0))
    node.process_scan(0, _scan_at(pose_np, 1.0))
    node.process_scan(0, _scan_at(pose_np, 2.0))
    # 3 calls: the init-time compile priming + 2 scans
    assert len(seen) == 3
    assert not np.array_equal(seen[1], seen[2])


def test_slam_odom_rescue():
    """A teleported scan whose implausible transform would NaN out is
    rescued by the odometry delta instead (OdometryAnalyzer semantics;
    reference call sites ThreadLocalize.cpp:263-265,334-336,586-588)."""
    import dataclasses
    from ohm_tsd_slam.config import OdomRescueConfig

    cfg = dataclasses.replace(
        CFG, robots=[dataclasses.replace(
            CFG.robots[0],
            odom=OdomRescueConfig(use_odom_rescue=True))])
    node = SlamNode(cfg, dtype=jnp.float64)
    x, y, th = 5.12, 5.12, 0.2

    pose_np = np.array(se2.make(x, y, th, dtype=jnp.float64))
    # odometry says: robot not moving.  Scans 0.1 s apart.
    node.on_odometry(0, 0.0, 0.0, 0.0, stamp=0.0)
    node.process_scan(0, _scan_at(pose_np, 0.0))        # init
    node.on_odometry(0, 0.0, 0.0, 0.0, stamp=0.1)
    node.process_scan(0, _scan_at(pose_np, 0.1))        # odom init
    node.on_odometry(0, 0.0, 0.0, 0.0, stamp=0.2)
    node.process_scan(0, _scan_at(pose_np, 0.2))        # odom valid
    pose_before = np.asarray(node.localizers[0].pose)

    # teleported scan: ICP recovers a 0.35 m jump = 3.5 m/s >> vel max
    tele = np.array(se2.make(x + 0.35, y, th, dtype=jnp.float64))
    node.on_odometry(0, 0.0, 0.0, 0.0, stamp=0.3)
    out = node.process_scan(0, _scan_at(tele, 0.3))
    # rescued: odometry delta (identity) replaces the jump -> no NaN,
    # pose essentially unchanged
    assert out is not None and not out.is_nan
    moved = np.asarray(node.localizers[0].pose)
    assert np.hypot(moved[0, 2] - pose_before[0, 2],
                    moved[1, 2] - pose_before[1, 2]) < 0.01


def test_slam_amcl_recovers_kidnap():
    """RegMode.AMCL reachable from config: after a 0.5 m kidnap (beyond
    plain ICP's convergence basin) the particle matcher relocalizes
   ."""
    import dataclasses
    from ohm_tsd_slam.config import AmclConfig, RegMode

    cfg = dataclasses.replace(
        CFG, robots=[dataclasses.replace(
            CFG.robots[0],
            registration=dataclasses.replace(
                CFG.robots[0].registration,
                mode=RegMode.AMCL,
                trns_thresh=1.0, rot_thresh=0.9,
                amcl=AmclConfig(particles=512, iterations=8,
                                sigma_trans=0.3, sigma_rot=0.1)),
        )])
    node = SlamNode(cfg, dtype=jnp.float64, seed=7)
    x, y, th = 5.12, 5.12, 0.2
    pose_np = np.array(se2.make(x, y, th, dtype=jnp.float64))
    node.process_scan(0, _scan_at(pose_np, 0.0))
    node.process_scan(0, _scan_at(pose_np, 1.0))

    # kidnap: scan taken from 0.5 m away while the estimate stays put
    kid = (x + 0.35, y + 0.35, th)
    kid_np = np.array(se2.make(*kid, dtype=jnp.float64))
    out = node.process_scan(0, _scan_at(kid_np, 2.0))
    assert out is not None and not out.is_nan
    est = np.asarray(node.localizers[0].pose)
    err = np.hypot(est[0, 2] - kid[0], est[1, 2] - kid[1])
    assert err < 3.0 * CFG.grid.cellsize, err


def test_slam_multi_robot_shared_grid():
    """Two localizers share one grid (the reference's multi-SLAM,
    SlamNode.cpp:101-122, config/double-laser.yaml): both track their
    trajectories and both contribute to the map."""
    import dataclasses

    cfg = dataclasses.replace(
        CFG,
        robots=[
            dataclasses.replace(CFG.robots[0], name="robot0",
                                local_offset_x=0.0),
            dataclasses.replace(CFG.robots[0], name="robot1",
                                local_offset_x=1.2,
                                local_offset_yaw=2.6),
        ])
    node = SlamNode(cfg, dtype=jnp.float64)

    # robot0 starts at grid center, robot1 1.2 m to the right looking
    # back; both crawl forward
    starts = [(5.12, 5.12, 0.2), (6.32, 5.12, 2.6 + 0.2 - 0.2)]
    # note: local_offset_yaw anchors the SLAM frame; keep gt consistent
    gt = {0: [], 1: []}
    for k in range(10):
        for r, (x0, y0, th0) in enumerate(starts):
            x = x0 + 0.02 * k * math.cos(th0)
            y = y0 + 0.02 * k * math.sin(th0)
            gt[r].append((x, y, th0))
            pose_np = np.array(se2.make(x, y, th0, dtype=jnp.float64))
            out = node.process_scan(r, _scan_at(pose_np, stamp=float(k)))
            if k > 0:
                assert out is not None and not out.is_nan, (r, k)

    for r in range(2):
        est = np.asarray(node.localizers[r].pose)
        x, y, _ = gt[r][-1]
        err = np.hypot(est[0, 2] - x, est[1, 2] - y)
        assert err < 2.5 * CFG.grid.cellsize, (r, err)

    # both robots' surroundings made it into the one shared grid
    occ_msg, _ = node.publish_map()
    assert int((np.asarray(occ_msg.data) == 100).sum()) > 100


def test_slam_threaded_runtime():
    """The threaded runtime (start/on_scan/stop: localizer + mapper +
    grid threads over native latest-wins channels) processes scans and
    publishes poses via callbacks (ThreadSLAM architecture,
    SlamNode.cpp:85-122)."""
    import time as _time

    node = SlamNode(CFG, dtype=jnp.float64)
    got = []
    node.pose_callbacks.append(lambda robot, msg: got.append((robot, msg)))

    x, y, th = 5.12, 5.12, 0.2
    # first scan initializes synchronously in the callback thread
    pose_np = np.array(se2.make(x, y, th, dtype=jnp.float64))
    node.on_scan(0, _scan_at(pose_np, 0.0))
    assert node.localizers[0].initialized

    node.start()
    try:
        for k in range(1, 6):
            p = np.array(se2.make(x + 0.02 * k, y, th, dtype=jnp.float64))
            node.on_scan(0, _scan_at(p, float(k)))
            _time.sleep(0.3)
        deadline = _time.time() + 20.0
        while not got and _time.time() < deadline:
            _time.sleep(0.1)
    finally:
        node.stop()

    assert got, "no poses published by the localizer thread"
    # the latest-wins channel may drop intermediate scans (the
    # reference's lossy deque) but the final pose must track the motion
    last = np.asarray(node.localizers[0].pose)
    assert abs(last[0, 2] - x) < 0.2 and not math.isnan(last[0, 2])


def test_tf_map_odom_broadcast():
    """sendTransform's map->odom correction chain (ThreadLocalize.cpp:
    604-689): tf = pose_map_laser · T(laser->footprint) ·
    T(footprint->odom); previous tf re-broadcast while the odom hop is
    missing; NaN tf on registration failure (sendNanTransform)."""
    node = SlamNode(CFG, dtype=jnp.float64)
    tfs = []
    node.tf_callbacks.append(lambda r, tf: tfs.append(tf))

    node.set_static_tf(0, 0.10, 0.02, 0.05)     # laser -> footprint

    gt = _trajectory(4)
    for k, (x, y, th) in enumerate(gt[:2]):
        node.process_scan(0, _scan_at(
            np.array(se2.make(x, y, th, dtype=jnp.float64)), float(k)))
    # no footprint->odom yet: identity fallback broadcast (reference
    # broadcasts its default-constructed _tf)
    assert len(tfs) == 1
    assert tfs[0].x == 0.0 and tfs[0].theta == 0.0

    node.on_footprint_odom(0, -0.30, 0.05, -0.10)
    out = node.process_scan(0, _scan_at(
        np.array(se2.make(*gt[2], dtype=jnp.float64)), 2.0))
    assert out is not None and not out.is_nan
    assert len(tfs) == 2
    tf = tfs[-1]
    # chain math replicated independently
    pose = np.array(se2.make(out.x, out.y, out.theta, dtype=np.float64))
    expect = pose @ np.array(se2.make(0.10, 0.02, 0.05,
                                      dtype=np.float64)) \
        @ np.array(se2.make(-0.30, 0.05, -0.10, dtype=np.float64))
    assert abs(tf.x - expect[0, 2]) < 1e-9
    assert abs(tf.y - expect[1, 2]) < 1e-9
    assert abs(tf.theta - math.atan2(expect[1, 0], expect[0, 0])) < 1e-9

    # registration failure (NaN pose sentinel) => NaN tf
    # (sendNanTransform; the reg-error e2e path is covered elsewhere —
    # here the sentinel is fed directly)
    from ohm_tsd_slam.slam.messages import PoseStamped
    node._broadcast_tf(0, node.localizers[0],
                       PoseStamped(math.nan, math.nan, math.nan), 3.0)
    assert math.isnan(tfs[-1].x) and math.isnan(tfs[-1].theta)

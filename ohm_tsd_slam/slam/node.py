"""The SLAM node: grid ownership, per-robot localizers, runtime loops.

Host-side redesign of SlamNode + the ThreadSLAM thread architecture
(src/SlamNode.cpp, src/ThreadSLAM.cpp).  The reference runs boost threads
over one mutable shared TsdGrid; here the grid is an immutable pytree
swapped atomically under a lock, and the three roles become:

  * per-robot localization (ThreadLocalize) — `on_scan` / localizer
    threads with latest-wins scan slots (the reference's lossy deque,
    ThreadLocalize.cpp:271,321,331),
  * map updates (ThreadMapping) — `Mapper` queue drained newest-first,
  * occupancy publication (ThreadGrid) — `GridPublisher` on a timer.

Both a synchronous API (`process_scan`, deterministic; used by tests and
offline processing) and a threaded runtime (`start`/`stop`/`on_scan`,
replicating the reference's lossy real-time behavior) are provided.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import jax.numpy as jnp
import numpy as np

from ohm_tsd_slam.config import RegMode, RobotConfig, SlamConfig
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.grid import state as grid_state
from ohm_tsd_slam.grid.raycast_fast import extract_segments_jit
from ohm_tsd_slam.slam.grid_pub import GridPublisher
from ohm_tsd_slam.slam.localize import (
    LocalizeParams,
    calc_angle_02pi,
    localize_step_jit,
)
from ohm_tsd_slam import native
from ohm_tsd_slam.slam.mapping import Mapper
from ohm_tsd_slam.slam.messages import (
    LaserScan,
    PoseStamped,
    Transform2D,
    pack_scan,
    unpack_scan,
)
from ohm_tsd_slam.sensor.polar2d import (
    SensorPolar2D,
    clamp_min_range,
    standard_mask,
)


@dataclass
class Localizer:
    """Per-robot localization state (the mutable half of ThreadLocalize)."""

    config: RobotConfig
    grid_offset_x: float
    grid_offset_y: float
    geom: Optional[SensorPolar2D] = None
    params: Optional[LocalizeParams] = None
    pose: Optional[jnp.ndarray] = None
    last_pose: Optional[jnp.ndarray] = None
    reverse_scan: bool = False
    initialized: bool = False
    # latest-wins scan channel (threaded mode): the native C++ mailbox
    # (ohm_tsd_slam/native) replicating the reference's mutex-guarded
    # keep-newest deque + condition variable (ThreadLocalize.cpp:269-332)
    scan_channel: native.Channel = field(
        default_factory=lambda: native.Channel(native.MAILBOX))
    last_result: Optional[PoseStamped] = None
    # fast-raycast overflow of the latest scan (segments/beams past the
    # caster's capacity; the exact march re-rendered the scan when > 0)
    rays_dropped: int = 0
    # per-scan PRNG stream position (folded into the node key so the
    # stochastic matchers draw fresh trials every scan — the reference
    # reseeds rand() per call)
    scan_count: int = 0
    # odometry rescue (OdometryAnalyzer state; None until first odometry)
    odom_state: Optional[object] = None
    latest_odom: Optional[tuple] = None     # (pose 3x3 np, stamp)
    # tf chain for the map->odom correction (sendTransform,
    # ThreadLocalize.cpp:604-689): static laser->footprint transform and
    # the latest footprint->odom transform (the reference looks both up
    # from the tf tree; here they are fed via set_static_tf /
    # on_footprint_odom)
    tf_laser_footprint: Optional[np.ndarray] = None    # 3x3
    tf_footprint_odom: Optional[np.ndarray] = None     # 3x3
    # last successfully computed map->odom tf; re-published when the
    # footprint->odom lookup is unavailable (the reference broadcasts
    # its previous _tf in that case — quirk replicated)
    last_tf: Optional[Transform2D] = None


class SlamNode:
    def __init__(self, config: SlamConfig, dtype=jnp.float32,
                 seed: int = 0):
        import jax

        self.config = config
        self.dtype = dtype
        # base PRNG key; per-robot/per-scan keys are folded from it
        self._base_key = jax.random.PRNGKey(seed)
        self.grid = grid_state.create(config.grid, dtype=dtype)
        # _grid_lock guards only the (immutable-pytree) reference swap;
        # _write_lock serializes grid *writers* (init + mapper drain) so
        # no update is lost, without blocking readers during the compute.
        self._grid_lock = threading.Lock()
        self._write_lock = threading.Lock()
        self.mapper = Mapper()
        self.grid_pub = GridPublisher(config.grid_pub,
                                      config.runtime.x_offset,
                                      config.runtime.y_offset)
        gw = config.grid.size_meters
        gx = -(gw * 0.5 + config.runtime.x_offset)
        gy = -(gw * 0.5 + config.runtime.y_offset)
        self.localizers: List[Localizer] = [
            Localizer(config=rc, grid_offset_x=gx, grid_offset_y=gy)
            for rc in config.robots
        ]
        self._active = True      # start_stop_slam service state
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self.pose_callbacks: List[Callable[[int, PoseStamped], None]] = []
        # tf broadcast sink (map->odom correction, sendTransform
        # ThreadLocalize.cpp:604-689 / sendNanTransform :691-713)
        self.tf_callbacks: List[Callable[[int, Transform2D], None]] = []
        # per-grid-version isocontour cache: the raycast's segment
        # extraction depends only on the TSD field, so it runs once per
        # map update (mapper drain) instead of once per scan
        self._seg_lock = threading.Lock()
        self._seg_cache: tuple = (None, None)   # (grid ref, SegmentCache)

    def _segments_for(self, grid):
        """extract_segments() memoized on grid identity (grids are
        immutable pytrees swapped atomically, so identity == version)."""
        with self._seg_lock:
            ref, seg = self._seg_cache
            if ref is not grid:
                seg = extract_segments_jit(grid)
                self._seg_cache = (grid, seg)
            return seg

    def _needs_segments(self, loc: "Localizer") -> bool:
        return (loc.params.fast_raycast
                and loc.params.mode != int(RegMode.GN))

    # ------------------------------------------------------------------
    # control (start_stop_slam service, SlamNode.cpp:159-189)
    # ------------------------------------------------------------------
    def set_active(self, active: bool) -> None:
        self._active = active

    @property
    def active(self) -> bool:
        return self._active

    # ------------------------------------------------------------------
    # initialization on first scan (ThreadLocalize::init, :411-511)
    # ------------------------------------------------------------------
    def _init_localizer(self, loc: Localizer, scan: LaserScan) -> None:
        rc = loc.config
        inc = scan.angle_increment
        angle_min = scan.angle_min
        ranges = np.asarray(scan.ranges, dtype=np.float64)
        if inc < 0.0 and angle_min > 0:
            # reversed (CW) scanner normalization (:491-497)
            loc.reverse_scan = True
            inc = -inc
            angle_min = -angle_min
        loc.geom = SensorPolar2D(
            size=len(ranges),
            angular_res=float(inc),
            phi_min=float(angle_min),
            max_range=rc.sensor.max_range,
            min_range=rc.sensor.min_range,
            low_reflectivity_range=rc.sensor.low_reflectivity_range,
        )
        gw = self.config.grid.size_meters
        start_x = gw * 0.5 + self.config.runtime.x_offset + rc.local_offset_x
        start_y = gw * 0.5 + self.config.runtime.y_offset + rc.local_offset_y
        loc.pose = se2.make(start_x, start_y, rc.local_offset_yaw,
                            dtype=self.dtype)
        loc.last_pose = loc.pose

        bounds = (0.0, gw, 0.0, gw)
        loc.params = LocalizeParams.from_config(
            rc.registration, loc.geom, bounds=bounds, odom_cfg=rc.odom,
            cell_size=self.config.grid.cellsize)

        # free footprint + initial map push (:503-507)
        fp = rc.footprint
        center = np.array([start_x + fp.x_offset, start_y])
        with self._write_lock:
            with self._grid_lock:
                grid = self.grid
            grid = grid_state.free_footprint(grid, center, fp.width,
                                             fp.height)
            data, mask = self._preprocess(loc, ranges)
            if not self.mapper.initialized():
                grid = self.mapper.init_push(grid, loc.geom, loc.pose,
                                             data, mask)
            with self._grid_lock:
                self.grid = grid
        loc.initialized = True
        # Prime the jitted localization step with the real shapes so the
        # localizer thread never stalls on a first-compile (the reference
        # likewise does its heavy init in the laser callback thread,
        # ThreadLocalize.cpp:257-267).
        import jax
        seg = (self._segments_for(grid) if self._needs_segments(loc)
               else None)
        localize_step_jit(grid, loc.pose, loc.last_pose, data, mask,
                          loc.params, key=jax.random.PRNGKey(0),
                          segments=seg)

    def _preprocess(self, loc: Localizer, ranges: np.ndarray):
        """laserCallBack clamp + standard mask
        (ThreadLocalize.cpp:252-256,328-329)."""
        data = jnp.asarray(ranges, dtype=self.dtype)
        data = clamp_min_range(data, loc.config.sensor.laser_min_range)
        return standard_mask(loc.geom, data)

    # ------------------------------------------------------------------
    # synchronous per-scan processing (deterministic pipeline)
    # ------------------------------------------------------------------
    def process_scan(self, robot: int, scan: LaserScan,
                     drain_mapper: bool = True) -> Optional[PoseStamped]:
        """Run one localization cycle for `robot`; returns the published
        pose (NaN sentinel on registration failure, ThreadLocalize
        :381-387) or None before initialization/while stopped."""
        if not self._active:
            return None
        loc = self.localizers[robot]
        ranges = np.asarray(scan.ranges, dtype=np.float64)
        if not loc.initialized:
            self._init_localizer(loc, scan)
            return None
        if loc.reverse_scan:
            ranges = ranges[::-1].copy()

        data, mask = self._preprocess(loc, ranges)
        with self._grid_lock:
            grid = self.grid

        # fresh PRNG key per scan: fold robot id and scan counter into the
        # node key (the reference's matchers reseed rand() per call)
        import jax
        key = jax.random.fold_in(jax.random.fold_in(self._base_key, robot),
                                 loc.scan_count)
        loc.scan_count += 1

        # odometry rescue: advance the state with the latest odometry
        # sample (odomRescueUpdate call site, ThreadLocalize.cpp:334-336)
        odom_state = None
        if loc.params.odom is not None and loc.latest_odom is not None:
            from ohm_tsd_slam.slam import odometry
            odom_pose, odom_stamp = loc.latest_odom
            if loc.odom_state is None:
                loc.odom_state = odometry.init(loc.params.odom,
                                               jnp.asarray(odom_pose,
                                                           self.dtype),
                                               scan.stamp)
            else:
                loc.odom_state = odometry.update(
                    loc.odom_state, jnp.asarray(odom_pose, self.dtype),
                    scan.stamp, odom_ok=True)
            odom_state = loc.odom_state

        seg = (self._segments_for(grid) if self._needs_segments(loc)
               else None)
        res = localize_step_jit(grid, loc.pose, loc.last_pose, data, mask,
                                loc.params, key=key, odom_state=odom_state,
                                segments=seg)

        n_over = int(res.rays_dropped)
        loc.rays_dropped = n_over
        if n_over > 0:
            # fast-raycast capacity overflow: the guarded exact march
            # re-rendered the scan (no beams lost) — log the pressure
            # (RayCastPolar2D's degradation warning analogue,
            # ThreadLocalize.cpp:354-358)
            native.log(native.LOG_WARN, "localize",
                       f"fast raycast overflowed by {n_over} "
                       "segments/beams; exact-march fallback used")
        if bool(res.reg_error):
            pose_msg = PoseStamped(math.nan, math.nan, math.nan,
                                   stamp=scan.stamp)
        else:
            loc.pose = res.pose
            T = np.asarray(res.pose)
            pose_msg = PoseStamped(
                x=float(T[0, 2]) + loc.grid_offset_x,
                y=float(T[1, 2]) + loc.grid_offset_y,
                theta=float(calc_angle_02pi(res.pose)),
                stamp=scan.stamp)
            if bool(res.significant):
                loc.last_pose = res.pose
                self.mapper.queue_push(loc.geom, res.pose, data, mask)
                if drain_mapper:
                    self._drain_mapper()
        loc.last_result = pose_msg
        for cb in self.pose_callbacks:
            cb(robot, pose_msg)
        self._broadcast_tf(robot, loc, pose_msg, scan.stamp)
        return pose_msg

    def set_static_tf(self, robot: int, x: float, y: float,
                      yaw: float) -> None:
        """Static laser->footprint transform (the reference's
        `lookupTransform(laser, footprint)` fed by the launch file's
        static tf publishers, launch/slam.launch.py:32-49)."""
        self.localizers[robot].tf_laser_footprint = np.asarray(
            se2.make(x, y, yaw, dtype=np.float64))

    def on_footprint_odom(self, robot: int, x: float, y: float,
                          yaw: float, stamp: float = 0.0) -> None:
        """Latest footprint->odom transform (the reference's
        `lookupTransform(footprint, odom)` from the robot's odometry
        tf)."""
        self.localizers[robot].tf_footprint_odom = np.asarray(
            se2.make(x, y, yaw, dtype=np.float64))

    def _broadcast_tf(self, robot: int, loc: Localizer,
                      pose_msg: PoseStamped, stamp: float) -> None:
        """The map->odom correction chain of ThreadLocalize::sendTransform
        (ThreadLocalize.cpp:604-689): tf = pose_map_laser ·
        T(laser->footprint) · T(footprint->odom), with each hop applied
        only when available, and the previous tf re-broadcast when the
        odom hop is missing.  NaN pose => NaN tf (sendNanTransform)."""
        if not self.tf_callbacks:
            return
        if pose_msg.is_nan:
            tf = Transform2D(math.nan, math.nan, math.nan, stamp=stamp)
        else:
            pose = np.asarray(se2.make(pose_msg.x, pose_msg.y,
                                       pose_msg.theta, dtype=np.float64))
            if loc.tf_laser_footprint is not None:
                pose = pose @ loc.tf_laser_footprint
            if loc.tf_footprint_odom is not None:
                t = pose @ loc.tf_footprint_odom
                tf = Transform2D(
                    x=float(t[0, 2]), y=float(t[1, 2]),
                    theta=float(math.atan2(t[1, 0], t[0, 0])),
                    stamp=stamp)
                loc.last_tf = tf
            else:
                # no odom hop: the reference broadcasts its previous
                # _tf contents (identity before the first success) but
                # always with a FRESH stamp (_tf.header.stamp =
                # _stampLaser, ThreadLocalize.cpp:683) — re-sending an
                # old stamp would make tf2 consumers drop the frame
                tf = (dataclasses.replace(loc.last_tf, stamp=stamp)
                      if loc.last_tf is not None
                      else Transform2D(0.0, 0.0, 0.0, stamp=stamp))
        for cb in self.tf_callbacks:
            cb(robot, tf)

    def on_odometry(self, robot: int, x: float, y: float, yaw: float,
                    stamp: float = 0.0) -> None:
        """Feed an odometry sample for `robot` (the reference pulls the
        same information from the tf tree, OdometryAnalyzer.cpp:65-151).
        Used by the odometry-rescue stage when
        robot.odom.use_odom_rescue is set."""
        loc = self.localizers[robot]
        pose = np.asarray(se2.make(x, y, yaw, dtype=self.dtype))
        loc.latest_odom = (pose, stamp)

    def _drain_mapper(self) -> None:
        with self._write_lock:
            with self._grid_lock:
                grid = self.grid
            grid = self.mapper.drain(grid)
            with self._grid_lock:
                self.grid = grid

    def publish_map(self, stamp: float = 0.0):
        """ThreadGrid cycle on the current grid state."""
        with self._grid_lock:
            grid = self.grid
        return self.grid_pub.publish(grid, stamp)

    # ------------------------------------------------------------------
    # threaded runtime (replicates the reference's lossy behavior)
    # ------------------------------------------------------------------
    def on_scan(self, robot: int, scan: LaserScan) -> None:
        """Laser callback: latest-wins slot + wakeup
        (ThreadLocalize.cpp:269-275).  The first scan initializes
        synchronously in the callback thread, exactly like the reference
        (ThreadLocalize.cpp:257-267) — this also keeps the heavy
        first-compile off the localizer loop."""
        if not self._active:
            return
        loc = self.localizers[robot]
        if not loc.initialized:
            self._init_localizer(loc, scan)
            return
        loc.scan_channel.push(pack_scan(scan))

    def _localizer_loop(self, robot: int) -> None:
        loc = self.localizers[robot]
        while not self._stop.is_set():
            payload = loc.scan_channel.pop_wait(timeout_ms=100)
            if payload is None:
                continue
            if self._active:
                self.process_scan(robot, unpack_scan(payload),
                                  drain_mapper=False)
                self._mapper_wakeup.set()

    def _mapper_loop(self) -> None:
        while not self._stop.is_set():
            if not self._mapper_wakeup.wait(timeout=0.1):
                continue
            self._mapper_wakeup.clear()
            if self.mapper.pending():
                self._drain_mapper()

    def _grid_loop(self) -> None:
        interval = self.config.grid_pub.interval_s
        next_t = time.monotonic() + interval
        while not self._stop.wait(timeout=max(0.0,
                                              next_t - time.monotonic())):
            next_t = time.monotonic() + interval
            self.publish_map(stamp=time.time())

    def start(self) -> None:
        """Spawn the mapper and grid threads plus one localizer thread
        per robot (SlamNode.cpp:85-122)."""
        self._stop.clear()
        self._mapper_wakeup = threading.Event()
        self._threads = [
            threading.Thread(target=self._mapper_loop, daemon=True),
            threading.Thread(target=self._grid_loop, daemon=True),
        ] + [
            threading.Thread(target=self._localizer_loop, args=(i,),
                             daemon=True)
            for i in range(len(self.localizers))
        ]
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

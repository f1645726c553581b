"""Drive the ROS 2 bridge with a faked rclpy runtime (no ROS installed):
scan in → pose out, map/image publication, get_map + start_stop_slam
services — the reference node's full topic/service surface
(src/SlamNode.cpp:124-127, srv/StartStopSLAM.srv, launch/slam.launch.py).
"""

import importlib
import math
import sys
import types

import numpy as np
import pytest

from ohm_tsd_slam.config import (
    GridConfig,
    IcpConfig,
    RegistrationConfig,
    RobotConfig,
    SensorConfig,
    SlamConfig,
)
from ohm_tsd_slam.core import se2
from ohm_tsd_slam.utils.testing import rect_walls, simulate_scan

BEAMS = 241
RES = math.radians(1.0)
PHI0 = math.radians(-120.0)
RMAX = 9.0
WALLS = rect_walls(1.5, 1.5, 8.5, 8.5)

CFG = SlamConfig(
    grid=GridConfig(map_size=8, cellsize=0.04, truncation_radius=3.0),
    robots=[RobotConfig(
        local_offset_yaw=0.2,
        sensor=SensorConfig(max_range=RMAX, min_range=0.01,
                            low_reflectivity_range=1.0),
        registration=RegistrationConfig(
            icp=IcpConfig(iterations=20, dist_filter_max=0.5,
                          dist_filter_min=0.05)),
    )],
)


class _Msg:
    """Auto-vivifying attribute bag standing in for a ROS message."""

    def __getattr__(self, k):
        v = _Msg()
        object.__setattr__(self, k, v)
        return v


class _FakeNode:
    """rclpy.node.Node stand-in recording pubs/subs/services/timers."""

    def __init__(self, name):
        self.name = name
        self.subs = {}
        self.pubs = {}
        self.srvs = {}
        self.timers = []

    def declare_parameter(self, *_a, **_k):
        raise RuntimeError("no param server in the fake")

    def get_parameter(self, *_a, **_k):
        raise RuntimeError("no param server in the fake")

    def create_subscription(self, _type, topic, cb, _qos):
        self.subs[topic] = cb
        return object()

    def create_publisher(self, _type, topic, _qos):
        msgs = []
        self.pubs[topic] = msgs

        class _Pub:
            def publish(self, m, _msgs=msgs):
                _msgs.append(m)

        return _Pub()

    def create_service(self, _type, name, cb):
        self.srvs[name] = cb
        return object()

    def create_timer(self, interval, cb):
        self.timers.append((interval, cb))
        return object()


@pytest.fixture()
def bridge_module(monkeypatch):
    """Install fake rclpy/sensor_msgs/... modules and reload the
    bridge."""
    rclpy = types.ModuleType("rclpy")
    rclpy.init = lambda *a, **k: None
    rclpy.shutdown = lambda *a, **k: None
    rclpy.spin = lambda node: None
    node_mod = types.ModuleType("rclpy.node")
    node_mod.Node = _FakeNode
    rclpy.node = node_mod

    def msg_module(name, classes):
        m = types.ModuleType(name)
        for c in classes:
            setattr(m, c, type(c, (_Msg,), {}))
        return m

    mods = {
        "rclpy": rclpy,
        "rclpy.node": node_mod,
        "sensor_msgs": types.ModuleType("sensor_msgs"),
        "sensor_msgs.msg": msg_module("sensor_msgs.msg",
                                      ["Image", "LaserScan"]),
        "geometry_msgs": types.ModuleType("geometry_msgs"),
        "geometry_msgs.msg": msg_module("geometry_msgs.msg",
                                        ["PoseStamped",
                                         "TransformStamped"]),
        "nav_msgs": types.ModuleType("nav_msgs"),
        "nav_msgs.msg": msg_module("nav_msgs.msg", ["OccupancyGrid"]),
        "nav_msgs.srv": msg_module("nav_msgs.srv", ["GetMap"]),
        "std_srvs": types.ModuleType("std_srvs"),
        "std_srvs.srv": msg_module("std_srvs.srv", ["SetBool"]),
    }

    tf2_ros = types.ModuleType("tf2_ros")

    class _FakeTfBroadcaster:
        def __init__(self, node):
            self.sent = []
            node.tf_sent = self.sent

        def sendTransform(self, m):
            self.sent.append(m)

    tf2_ros.TransformBroadcaster = _FakeTfBroadcaster
    mods["tf2_ros"] = tf2_ros
    for k, v in mods.items():
        monkeypatch.setitem(sys.modules, k, v)

    import ohm_tsd_slam.ros_bridge as rb

    rb = importlib.reload(rb)
    assert rb.HAVE_ROS
    yield rb
    # restore the module to its no-ROS state for other tests
    for k in mods:
        sys.modules.pop(k, None)
    importlib.reload(rb)


def _scan_msg(x, y, th, stamp):
    pose_np = np.array(se2.make(x, y, th, dtype=np.float64))
    r = simulate_scan(pose_np, BEAMS, RES, PHI0, RMAX, segments=WALLS)
    m = _Msg()
    m.ranges = r
    m.angle_min = PHI0
    m.angle_increment = RES
    m.range_max = RMAX
    m.header.stamp.sec = int(stamp)
    m.header.stamp.nanosec = 0
    return m


def test_bridge_scan_to_pose_and_map(bridge_module):
    rb = bridge_module
    bridge = rb.RosSlamBridge(config=CFG)

    # reference surface: laser sub, pose/map/image pubs, two services,
    # one occupancy timer (SlamNode.cpp:124-128)
    assert "laser" in bridge.subs
    assert set(bridge.pubs) == {"estimated_pose", "map", "map/image"}
    assert set(bridge.srvs) == {"get_map", "start_stop_slam"}
    assert len(bridge.timers) == 1

    on_scan = bridge.subs["laser"]
    on_scan(_scan_msg(5.12, 5.12, 0.2, 0.0))     # first scan initializes
    assert bridge.pubs["estimated_pose"] == []
    bridge.slam.on_footprint_odom(0, -0.1, 0.0, 0.0)
    on_scan(_scan_msg(5.14, 5.12, 0.21, 1.0))
    poses = bridge.pubs["estimated_pose"]
    assert len(poses) == 1
    # tf map->odom broadcast rode along (sendTransform surface)
    assert len(bridge.tf_sent) == 1
    assert bridge.tf_sent[0].child_frame_id == "odom"
    p = poses[0]
    # published pose is grid-frame + grid offset (grid offset = -size/2)
    assert abs(p.pose.position.x - (5.14 - 5.12)) < 0.05
    assert abs(p.pose.position.y - (5.12 - 5.12)) < 0.05
    assert p.header.frame_id == "map"

    # occupancy + TSD color image publication (ThreadGrid path)
    _, timer_cb = bridge.timers[0]
    timer_cb()
    maps = bridge.pubs["map"]
    assert len(maps) == 1
    assert maps[0].info.width == 256 and maps[0].info.height == 256
    vals = set(maps[0].data)
    assert vals <= {-1, 0, 100} and 100 in vals
    imgs = bridge.pubs["map/image"]
    assert len(imgs) == 1 and imgs[0].encoding == "rgb8"
    assert imgs[0].width == 256 and len(imgs[0].data) == 256 * 256 * 3

    # get_map service (nav_msgs/GetMap; ThreadGrid.cpp:135-142)
    resp = bridge.srvs["get_map"](_Msg(), _Msg())
    assert resp.map.info.width == 256

    # start_stop_slam (SlamNode.cpp:159-189): stop -> scans ignored
    req = _Msg()
    req.data = False
    r2 = bridge.srvs["start_stop_slam"](req, _Msg())
    assert r2.success is True
    assert not bridge.slam.active
    on_scan(_scan_msg(5.16, 5.12, 0.22, 2.0))
    assert len(bridge.pubs["estimated_pose"]) == 1   # unchanged
    req.data = True
    bridge.srvs["start_stop_slam"](req, _Msg())
    on_scan(_scan_msg(5.16, 5.12, 0.22, 3.0))
    assert len(bridge.pubs["estimated_pose"]) == 2

"""Headless tests for the ROS1 shim: stub rospy/tf2_ros
and exercise the actual glue — param plumbing, scan callback TF handling,
upside-down-lidar detection, map message construction, services, and the
map->odom broadcast — without a ROS installation."""
import sys
import types

import numpy as np
import pytest

from yag_slam_tpu.core.transform import Transform


class _Obj:
    """Attribute bag for message stubs."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _make_ros_stubs(params, tf_rotation, recorded):
    rospy = types.ModuleType("rospy")
    rospy.init_node = lambda *a, **k: None
    rospy.get_param = lambda name, default=None: params.get(name, default)
    rospy.loginfo = rospy.logwarn = lambda *a, **k: None
    rospy.Duration = lambda s: s

    class _Time:
        @staticmethod
        def now():
            return 123.0

    rospy.Time = _Time

    class Publisher:
        def __init__(self, topic, _type, **kw):
            self.topic = topic

        def publish(self, msg):
            recorded.setdefault("published", []).append((self.topic, msg))

    class Service:
        def __init__(self, name, _type, handler):
            recorded.setdefault("services", {})[name] = handler

    class Subscriber:
        def __init__(self, topic, _type, cb):
            recorded.setdefault("subscribers", {})[topic] = cb

    rospy.Publisher = Publisher
    rospy.Service = Service
    rospy.Subscriber = Subscriber
    rospy.spin = lambda: None

    tf2_ros = types.ModuleType("tf2_ros")

    class Buffer:
        def lookup_transform(self, target, source, stamp, timeout=None):
            recorded.setdefault("tf_lookups", []).append((target, source))
            q = tf_rotation
            return _Obj(transform=_Obj(
                translation=_Obj(x=0.5, y=-0.25, z=0.3),
                rotation=_Obj(x=q[0], y=q[1], z=q[2], w=q[3]),
            ))

    class TransformListener:
        def __init__(self, buf):
            pass

    class TransformBroadcaster:
        def sendTransform(self, t):
            recorded.setdefault("tf_broadcasts", []).append(t)

    tf2_ros.Buffer = Buffer
    tf2_ros.TransformListener = TransformListener
    tf2_ros.TransformBroadcaster = TransformBroadcaster

    geometry = types.ModuleType("geometry_msgs")
    geometry_msg = types.ModuleType("geometry_msgs.msg")

    class Pose:
        def __init__(self):
            self.position = _Obj(x=0.0, y=0.0, z=0.0)
            self.orientation = _Obj(x=0.0, y=0.0, z=0.0, w=1.0)

    class TransformStamped:
        def __init__(self):
            self.header = _Obj(stamp=None, frame_id="")
            self.child_frame_id = ""
            self.transform = _Obj(
                translation=_Obj(x=0.0, y=0.0, z=0.0),
                rotation=_Obj(x=0.0, y=0.0, z=0.0, w=1.0),
            )

    geometry_msg.Pose = Pose
    geometry_msg.TransformStamped = TransformStamped
    geometry.msg = geometry_msg

    nav = types.ModuleType("nav_msgs")
    nav_msg = types.ModuleType("nav_msgs.msg")

    class MapMetaData:
        pass

    class OccupancyGrid:
        def __init__(self):
            self.info = _Obj(resolution=0.0, height=0, width=0, origin=None)
            self.data = []
            self.header = _Obj(frame_id="", stamp=None)

    nav_msg.MapMetaData = MapMetaData
    nav_msg.OccupancyGrid = OccupancyGrid
    nav.msg = nav_msg

    nav_srv = types.ModuleType("nav_msgs.srv")

    class GetMap:
        pass

    class GetMapResponse:
        def __init__(self):
            self.map = None

    nav_srv.GetMap = GetMap
    nav_srv.GetMapResponse = GetMapResponse
    nav.srv = nav_srv

    sensor = types.ModuleType("sensor_msgs")
    sensor_msg = types.ModuleType("sensor_msgs.msg")

    class LaserScan:
        pass

    sensor_msg.LaserScan = LaserScan
    sensor.msg = sensor_msg

    return {
        "rospy": rospy,
        "tf2_ros": tf2_ros,
        "geometry_msgs": geometry,
        "geometry_msgs.msg": geometry_msg,
        "nav_msgs": nav,
        "nav_msgs.msg": nav_msg,
        "nav_msgs.srv": nav_srv,
        "sensor_msgs": sensor,
        "sensor_msgs.msg": sensor_msg,
    }


class _FakeGrid:
    def __init__(self):
        self.resolution = 0.05
        self.width = 4
        self.height = 3
        self.offset = Transform.from_xyt(-1.0, -2.0, 0.0)


class _RecordingMapper:
    """Stands in for ThreadedOnlineMapper: records the glue-layer calls the
    node makes (the SLAM core is covered by tests/test_apps.py)."""

    instances = []

    def __init__(self, **kw):
        self.kw = kw
        self.enqueued = []
        type(self).instances.append(self)

    def enqueue_scan(self, ranges, amin, amax, ainc, rmin, rmax, pose,
                     invert=False):
        self.enqueued.append(dict(ranges=list(ranges), amin=amin, amax=amax,
                                  ainc=ainc, rmin=rmin, rmax=rmax, pose=pose,
                                  invert=invert))

    def map_to_odom(self):
        return Transform.from_xyt(1.5, 2.5, 0.3)

    def render_map(self):
        ros_img = np.array([[0, 100, -1, 0], [0, 0, 0, 100],
                            [-1, -1, 0, 0]], dtype=np.int8)
        return ros_img, _FakeGrid()

    def save_graph(self, path):
        with open(path, "wb") as ff:
            ff.write(b"graph")
        return path


def _run_node(monkeypatch, tf_rotation, params=None):
    recorded = {}
    params = dict(params or {})
    stubs = _make_ros_stubs(params, tf_rotation, recorded)
    for name, mod in stubs.items():
        monkeypatch.setitem(sys.modules, name, mod)

    import yag_slam_tpu.apps.online as online

    _RecordingMapper.instances.clear()
    monkeypatch.setattr(online, "ThreadedOnlineMapper", _RecordingMapper)

    from yag_slam_tpu.apps import ros1_node

    ros1_node.main()
    return recorded, _RecordingMapper.instances[-1]


def _scan_msg():
    n = 8
    return _Obj(
        header=_Obj(stamp=11.0, frame_id="base_laser_link"),
        ranges=tuple(1.0 + 0.1 * i for i in range(n)),
        angle_min=-1.0, angle_max=1.0, angle_increment=2.0 / n,
        range_min=0.02, range_max=20.0,
    )


def test_scan_callback_rightside_up(monkeypatch):
    recorded, mapper = _run_node(monkeypatch, tf_rotation=(0, 0, 0, 1))
    cb = recorded["subscribers"]["/scan"]
    cb(_scan_msg())

    assert recorded["tf_lookups"] == [("odom", "base_laser_link")]
    assert len(mapper.enqueued) == 1
    e = mapper.enqueued[0]
    assert e["invert"] is False
    assert e["pose"] == (0.5, -0.25, 0.0)  # yaw 0 from identity quaternion
    assert e["ranges"][0] == 1.0

    # map->odom broadcast fired with the mapper's correction
    t = recorded["tf_broadcasts"][0]
    assert t.header.frame_id == "map" and t.child_frame_id == "odom"
    assert t.transform.translation.x == pytest.approx(1.5)
    assert t.transform.rotation.w != 0.0


def test_scan_callback_upside_down_lidar(monkeypatch):
    # roll = pi: sensor z-axis points down -> ranges must be inverted
    recorded, mapper = _run_node(monkeypatch, tf_rotation=(1, 0, 0, 0))
    cb = recorded["subscribers"]["/scan"]
    cb(_scan_msg())
    assert mapper.enqueued[0]["invert"] is True


def test_dynamic_map_service_and_value_contract(monkeypatch):
    recorded, mapper = _run_node(monkeypatch, tf_rotation=(0, 0, 0, 1))
    handler = recorded["services"]["dynamic_map"]
    resp = handler(None)
    msg = resp.map
    assert (msg.info.width, msg.info.height) == (4, 3)
    assert msg.info.resolution == 0.05
    assert msg.info.origin.position.x == pytest.approx(-1.0)
    assert msg.info.origin.position.y == pytest.approx(-2.0)
    assert msg.header.frame_id == "map"
    # ROS occupancy values pass through {-1, 0, 100}
    assert set(msg.data) <= {-1, 0, 100}
    assert len(msg.data) == 12


def test_param_plumbing(monkeypatch):
    params = {"~range_threshold": 7.5, "~min_distance": 0.9,
              "~loop_search_distance": 2.5}
    _, mapper = _run_node(monkeypatch, (0, 0, 0, 1), params)
    kw = mapper.kw
    assert kw["range_threshold"] == 7.5
    assert kw["seq_config"]["range_threshold"] == 7.5
    assert kw["loop_config"]["range_threshold"] == 7.5
    assert kw["min_distance"] == 0.9
    assert kw["loop_search_distance"] == 2.5

"""Checkpoint format compatibility with files written by the reference.

The reference serializes via ___name-tagged dicts -> msgpack -> zlib
(/root/reference/yag_slam/graph_slam.py:77-105, serde.py:56-95).  This test
hand-builds a checkpoint in exactly that wire format (including the
reference's dir()-ordered ScanMatcherConfig fields and its Transform
layout) and loads it.
"""
import zlib

import msgpack
import numpy as np
import pytest

from yag_slam_tpu.slam.graph_slam import GraphSlam


def ref_transform(x, y, t):
    import math

    return {
        "x": x, "y": y, "z": 0.0,
        "qx": 0.0, "qy": 0.0,
        "qz": math.sin(t / 2.0), "qw": math.cos(t / 2.0),
        "___name": "Transform",
    }


def ref_scan(num, x, y, t, n=60):
    rng = np.random.default_rng(num)
    return {
        "ranges": rng.uniform(0.5, 4.0, n).tolist(),
        "min_angle": -np.pi,
        "max_angle": np.pi,
        "angle_increment": 2 * np.pi / n,
        "min_range": 0.0,
        "max_range": 30.0,
        "range_threshold": 5.0,
        "odom_pose": ref_transform(x, y, t),
        "corrected_pose": ref_transform(x + 0.01, y - 0.01, t),
        "num": num,
        "___name": "LocalizedRangeScan",
    }


def ref_config():
    # reference field order is dir()-alphabetical (serde.py:90)
    return {
        "angle_variance_penalty": 0.3,
        "coarse_angle_resolution": 0.0349,
        "coarse_search_angle_offset": 0.349,
        "distance_variance_penalty": 0.5,
        "fine_search_angle_resolution": 0.00349,
        "minimum_angle_penalty": 0.9,
        "range_threshold": 5.0,
        "resolution": 0.02,
        "search_size": 0.5,
        "smear_deviation": 0.05,
        "use_response_expansion": True,
        "___name": "ScanMatcherConfig",
    }


def make_reference_blob():
    scans = [ref_scan(i, 0.4 * i, 0.1 * i, 0.05 * i) for i in range(4)]
    edges = []
    for i in range(3):
        edges.append(
            [
                i,
                i + 1,
                {
                    "mean": ref_transform(0.4, 0.1, 0.05),
                    "covariance": (np.eye(3) * 0.01).tolist(),
                    "___name": "LinkLabel",
                },
            ]
        )
    out = {
        "scans": scans,
        "edges": edges,
        "running_scans": [1, 2, 3],
        "seq_matcher_config": ref_config(),
        "loop_matcher_config": dict(ref_config(), search_size=2.0,
                                    resolution=0.05),
        "scan_buffer_len": 10,
        "loop_search_dist": 3,
        "loop_search_min_chain_size": 10,
        "min_response_coarse": 0.35,
        "min_response_fine": 0.45,
    }
    return zlib.compress(msgpack.packb(out))


def test_load_reference_format_checkpoint():
    slam = GraphSlam.unbinarize(make_reference_blob())
    assert len(slam.graph.vertices) == 4
    assert len(slam.graph.edges) == 3
    assert [s.num for s in slam.running_scans] == [1, 2, 3]
    assert slam.seq_matcher.config.resolution == 0.02
    assert slam.loop_matcher.config.search_size == 2.0
    v1 = slam.graph.vertices[1].obj
    assert np.isclose(v1.corrected_pose.x, 0.41)
    assert np.isclose(v1.odom_pose.euler[-1], 0.05)

    # re-serialized blob must round-trip through our own loader too and keep
    # the reference's tags
    blob2 = slam.binarize()
    d = msgpack.unpackb(zlib.decompress(blob2))
    assert d["scans"][0]["___name"] == "LocalizedRangeScan"
    assert d["scans"][0]["corrected_pose"]["___name"] == "Transform"
    assert d["seq_matcher_config"]["___name"] == "ScanMatcherConfig"
    slam2 = GraphSlam.unbinarize(blob2)
    assert len(slam2.graph.vertices) == 4


def test_config_extension_keys_wire_format():
    """Default configs must serialize with EXACTLY the reference's 11 keys
    (byte-compatible wire format); the extension fields
    (use_karto_penalties, minimum_distance_penalty) appear only when
    non-default and round-trip through our loader."""
    from yag_slam_tpu.core.config import make_config
    from yag_slam_tpu.slam.serde import _deserialize, _serialize

    plain = make_config({"range_threshold": 5.0})
    d = _serialize(plain)
    assert set(d) == set(ref_config()), sorted(d)

    karto = make_config({
        "range_threshold": 5.0, "use_karto_penalties": True,
        "minimum_distance_penalty": 0.7,
    })
    d2 = _serialize(karto)
    assert d2["use_karto_penalties"] is True
    assert d2["minimum_distance_penalty"] == 0.7
    back = _deserialize(d2)
    assert back.use_karto_penalties and back.minimum_distance_penalty == 0.7


def test_serde_roundtrip_randomized():
    """Fuzz the registry serializer: random scans, transforms and configs
    must round-trip exactly through ___name-tagged dicts -> msgpack ->
    zlib (the persistence boundary the reference format defines)."""
    import msgpack

    from yag_slam_tpu.core.config import make_config
    from yag_slam_tpu.core.scan import LocalizedRangeScan
    from yag_slam_tpu.core.transform import Transform
    from yag_slam_tpu.slam.serde import _deserialize, _serialize

    rng = np.random.default_rng(23)
    for trial in range(25):
        n = int(rng.integers(4, 400))
        ranges = rng.uniform(0.1, 30.0, n)
        ranges[rng.random(n) < 0.1] = np.nan  # invalid beams
        scan = LocalizedRangeScan(
            ranges,
            float(rng.uniform(-np.pi, 0)), float(rng.uniform(0, np.pi)),
            float(rng.uniform(0.001, 0.1)), 0.0,
            float(rng.uniform(10, 90)), float(rng.uniform(1, 20)),
            float(rng.normal(0, 50)), float(rng.normal(0, 50)),
            float(rng.uniform(-np.pi, np.pi)),
        )
        scan.num = int(rng.integers(0, 10000))
        scan.corrected_pose = Transform.from_xyt(
            float(rng.normal(0, 50)), float(rng.normal(0, 50)),
            float(rng.uniform(-np.pi, np.pi)),
        )
        blob = zlib.compress(msgpack.packb(_serialize(scan)))
        back = _deserialize(msgpack.unpackb(zlib.decompress(blob)))
        np.testing.assert_array_equal(np.asarray(back.ranges),
                                      np.asarray(scan.ranges))
        assert back.num == scan.num
        for attr in ("x", "y"):
            assert getattr(back.odom_pose, attr) == getattr(
                scan.odom_pose, attr)
            assert getattr(back.corrected_pose, attr) == getattr(
                scan.corrected_pose, attr)
        assert np.isclose(back.corrected_pose.euler[-1],
                          scan.corrected_pose.euler[-1])

        res = float(rng.uniform(0.005, 0.1))
        cfg = make_config({
            "resolution": res,
            "smear_deviation": float(rng.uniform(0.5 * res, 10 * res)),
            "search_size": float(rng.uniform(0.1, 5.0)),
            "range_threshold": float(rng.uniform(3, 30)),
            "use_response_expansion": bool(rng.random() < 0.5),
        })
        cfg2 = _deserialize(
            msgpack.unpackb(msgpack.packb(_serialize(cfg)))
        )
        assert cfg2 == cfg

"""Portable serialization: ``___name``-tagged dicts → msgpack → zlib
(written by the built-in slam.msgpack_lite codec).

Byte-compatible with the reference's registry-driven serializer
(/root/reference/yag_slam/serde.py:25-95): same type tags, same field
orders, numpy arrays as lists, so checkpoints written by the reference load
here and vice versa.  (The tag "Wrapper" — the reference's C++ matcher
shell — is accepted on read and mapped onto our matcher config.)
"""
from __future__ import annotations

from collections import namedtuple

import numpy as np

from yag_slam_tpu.core.config import (
    REFERENCE_CONFIG_KEYS,
    ScanMatcherConfig,
    make_config,
)
from yag_slam_tpu.core.scan import LaserScanConfig, LocalizedRangeScan
from yag_slam_tpu.core.transform import Pose2, Transform
from yag_slam_tpu.graphopt.graph import LinkLabel

SerdeConfig = namedtuple("SerdeConfig", ["cls", "variables", "factory"])
NAME = "___name"


def _class_name(obj):
    return obj.__class__.__name__


def _serialize(obj):
    n = _class_name(obj)
    if n in _configs:
        d = {v: _serialize(getattr(obj, v)) for v in _configs[n].variables}
        if n == "ScanMatcherConfig":
            # extension fields (use_karto_penalties et al.) enter
            # the checkpoint only when non-default, so the wire format
            # stays byte-identical to the reference's 11-key layout for
            # every reference-expressible config (core/config.py docstring)
            defaults = ScanMatcherConfig()
            for f in sorted(obj.__dataclass_fields__):
                if f not in REFERENCE_CONFIG_KEYS and (
                    getattr(obj, f) != getattr(defaults, f)
                ):
                    d[f] = _serialize(getattr(obj, f))
        d[NAME] = n
        return d
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    return obj


def _deserialize(d):
    if isinstance(d, dict) and NAME in d:
        cfg = _configs[d[NAME]]
        if cfg.factory:
            dd = {k: v for k, v in d.items() if k != NAME}
            return cfg.factory(dd)
        return cfg.cls(*[_deserialize(d[v]) for v in cfg.variables])
    return d


def _scan_matcher_config_factory(d):
    return make_config(d)


_configs = {
    "LocalizedRangeScan": SerdeConfig(
        LocalizedRangeScan,
        [
            "ranges",
            "min_angle",
            "max_angle",
            "angle_increment",
            "min_range",
            "max_range",
            "range_threshold",
            "odom_pose",
            "corrected_pose",
            "num",
        ],
        LocalizedRangeScan.deserialize,
    ),
    "Pose2": SerdeConfig(Pose2, ["x", "y", "yaw"], None),
    "LaserScanConfig": SerdeConfig(
        LaserScanConfig,
        [
            "min_angle",
            "max_angle",
            "angular_resolution",
            "min_range",
            "max_range",
            "range_threshold",
            "sensor_name",
        ],
        None,
    ),
    # Reference field order is dir()-alphabetical
    # (/root/reference/yag_slam/serde.py:90) — reproduced by sorting; the
    # variable list is pinned to the reference's 11 keys (extensions are
    # appended by _serialize only when non-default).
    "ScanMatcherConfig": SerdeConfig(
        ScanMatcherConfig,
        list(REFERENCE_CONFIG_KEYS),
        _scan_matcher_config_factory,
    ),
    # The reference's C++ matcher shell serializes as {config: ...}
    # (/root/reference/yag_slam/serde.py:87); accept the tag for
    # reference-written files.
    "Wrapper": SerdeConfig(dict, ["config"], None),
    "LinkLabel": SerdeConfig(LinkLabel, ["mean", "covariance"], None),
    "Transform": SerdeConfig(
        Transform, ["x", "y", "z", "qx", "qy", "qz", "qw"], None
    ),
}

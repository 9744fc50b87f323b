"""yag_slam_tpu — a 2D graph-SLAM engine in JAX/XLA.

A from-scratch rebuild of the capability set of safijari/yag-slam
(online correlation-grid scan matching, pose-graph construction, loop
closure, sparse pose adjustment, occupancy-grid mapping, portable
serialization, lifelong mapping / map splicing) architected for an
accelerator (an NVIDIA GPU):

- scans are fixed-width array pytrees, not Python objects shadowed by C++
  (reference keeps dual state: /root/reference/yag_slam/models.py:37-39);
- the correlation matcher scores the full (x, y, theta) candidate lattice in
  one batched XLA program instead of a numba triple loop
  (reference: /root/reference/yag_slam/helpers.py:156-295);
- pose-graph optimization is an array-native Gauss-Newton/LM solver
  (reference delegates to the C++ `sba_cpp.SPA2d`,
  /root/reference/yag_slam/graph_slam.py:23,65,265);
- occupancy-grid rendering and map raytracing are batched DDA sweeps on
  device (reference: C++ `create_occupancy_grid` and numba
  /root/reference/yag_slam/raytracing.py);
- multi-chip scaling goes through `jax.sharding.Mesh` + `shard_map`
  (the reference is strictly single-process).

Public API is importable from submodules, mirroring how reference users
import from `yag_slam.*` (the reference `__init__` is empty,
/root/reference/yag_slam/__init__.py).
"""

__version__ = "0.1.0"

from yag_slam_tpu.core.transform import Transform, Pose2
from yag_slam_tpu.core.scan import LocalizedRangeScan, LaserScanConfig
from yag_slam_tpu.core.config import (
    default_config,
    default_config_loop,
    ScanMatcherConfig,
    make_config,
)

__all__ = [
    "Transform",
    "Pose2",
    "LocalizedRangeScan",
    "LaserScanConfig",
    "ScanMatcherConfig",
    "default_config",
    "default_config_loop",
    "make_config",
    "__version__",
]

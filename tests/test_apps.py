"""Application layer: online mapper (ROS-free node equivalent), CARMEN
loader integration, offline CLI."""
import json

import numpy as np
import jax.numpy as jnp
import pytest

from yag_slam_tpu.apps.online import OnlineMapper, ThreadedOnlineMapper
from yag_slam_tpu.io.carmen import load_carmen_log, carmen_to_localized_scans
from yag_slam_tpu.io.simulator import (
    SimWorld,
    drifted_odometry,
    simulate_scan,
    square_loop_trajectory,
)

SMALL_SEQ = {"range_threshold": 5.0, "search_size": 0.5, "resolution": 0.02,
             "smear_deviation": 0.05}
SMALL_LOOP = {"range_threshold": 5.0, "search_size": 2.0, "resolution": 0.05,
              "smear_deviation": 0.05}


def feed(mapper, n_poses=20, seed=0):
    world = SimWorld.office()
    gt = square_loop_trajectory(side=5.0, step=0.5, laps=1, start=(-2.5, -2.5))
    gt = gt[:n_poses]
    odom = drifted_odometry(gt, yaw_bias=0.002, seed=seed)
    rng = np.random.default_rng(seed)
    results = []
    for i in range(len(gt)):
        scan = simulate_scan(world, gt[i], n_beams=200, range_threshold=5.0,
                             noise=0.004, rng=rng)
        results.append(
            mapper.add_scan(
                scan.ranges, scan.min_angle, scan.max_angle,
                scan.angle_increment, 0.0, 30.0, tuple(odom[i]),
            )
        )
    return gt, odom, results


def make_mapper(**kw):
    return OnlineMapper(
        seq_config=SMALL_SEQ, loop_config=SMALL_LOOP,
        min_distance=0.4, min_rotation=0.4,
        range_threshold=5.0, loop_search_distance=2.0,
        loop_search_min_chain_size=5,
        min_response_coarse=0.35, min_response_fine=0.45,
        dtype=jnp.float64, **kw,
    )


def test_online_mapper_gating_and_tracking():
    maps_seen = []
    mapper = make_mapper(map_callback=lambda im, grid: maps_seen.append(im),
                         map_every_n_scans=5)
    gt, odom, results = feed(mapper, n_poses=16)
    integrated = [r[0] for r in results]
    # first scan integrates; straight-line 0.5 m steps beat the 0.4 m gate
    assert integrated[0] and sum(integrated) >= 10
    assert len(mapper.slam.graph.vertices) == sum(integrated)
    # map callback fired with ROS-style values
    assert maps_seen
    vals = set(np.unique(maps_seen[-1]))
    assert vals.issubset({-1, 0, 100})

    # map->odom should roughly cancel odometry drift (small here)
    m2o = mapper.map_to_odom()
    assert abs(m2o.x) < 0.5 and abs(m2o.y) < 0.5


def test_online_mapper_motion_gate_rejects_static():
    mapper = make_mapper()
    world = SimWorld.office()
    scan = simulate_scan(world, np.array([0.0, 0.0, 0.0]), n_beams=200,
                         range_threshold=5.0)
    for i in range(5):
        ok, _, _ = mapper.add_scan(
            scan.ranges, scan.min_angle, scan.max_angle, scan.angle_increment,
            0.0, 30.0, (0.001 * i, 0.0, 0.0),
        )
        assert ok == (i == 0)


def test_online_mapper_motion_gate_wraps_yaw():
    """Crossing +/-pi is a tiny rotation, not a 2*pi one: the gate must
    wrap the yaw difference."""
    mapper = make_mapper()
    world = SimWorld.office()
    scan = simulate_scan(world, np.array([0.0, 0.0, 3.1]), n_beams=200,
                         range_threshold=5.0)

    def add(theta):
        ok, _, _ = mapper.add_scan(
            scan.ranges, scan.min_angle, scan.max_angle,
            scan.angle_increment, 0.0, 30.0, (0.0, 0.0, theta),
        )
        return ok

    assert add(3.1)            # first scan always integrates
    # true rotation |wrap(-3.1 - 3.1)| = 0.083 rad < 0.4 gate
    assert not add(-3.1)
    # a genuine 0.5 rad turn across the boundary still integrates
    assert add(-2.7)


def test_localization_mapper_batch_stream_bootstrap():
    """add_scans_batch_stream on a fresh localization mapper (base map
    loaded, no running scans, pending initial_pose) must splice the first
    scan per-scan instead of streaming it (the streamed path
    would assign a duplicate node id and stamp the initial pose onto
    every scan)."""
    from tests.test_splicing import make_map_image

    grid = make_map_image()
    world = SimWorld.rectangle(10.0, 6.0)
    pose0 = np.array([-2.4, 0.1, 0.2])
    mapper = OnlineMapper(
        seq_config={"range_threshold": 5.0, "resolution": 0.02,
                    "search_size": 0.5, "smear_deviation": 0.05},
        loop_config=SMALL_LOOP,
        min_distance=0.2, min_rotation=0.2, range_threshold=5.0,
        base_map=(grid.image, grid.resolution,
                  [grid.offset.x, grid.offset.y]),
        initial_pose=tuple(pose0),
        dtype=jnp.float64,
    )
    n_base = len(mapper.slam.graph.vertices)
    assert n_base >= 2 and not mapper.slam.running_scans

    rng = np.random.default_rng(3)
    poses = [pose0 + [0.3 * i, 0.02 * i, 0.0] for i in range(4)]
    prepared = []
    for p in poses:
        scan = simulate_scan(world, p, n_beams=500, range_threshold=5.0,
                             noise=0.003, rng=rng)
        s = mapper._prepare_scan(scan.ranges, scan.min_angle, scan.max_angle,
                                 scan.angle_increment, 0.0, 30.0, tuple(p))
        assert s is not None
        prepared.append(s)
    # preparation must NOT stamp the pending initial_pose onto the scans
    assert abs(prepared[1].odom_pose.x - poses[1][0]) < 1e-9

    out = mapper.add_scans_batch_stream(prepared, sync_every=2)
    assert len(out) == len(prepared)
    assert mapper.initial_pose is None
    # the first live scan was spliced against the base map; the rest
    # extended the graph without duplicate-node errors
    assert len(mapper.slam.graph.vertices) == n_base + len(prepared)
    assert abs(mapper.slam.graph.vertices[n_base].obj.corrected_pose.x
               - pose0[0]) < 0.3


def test_threaded_online_mapper():
    mapper = ThreadedOnlineMapper(
        seq_config=SMALL_SEQ, loop_config=SMALL_LOOP,
        min_distance=0.4, min_rotation=0.4, range_threshold=5.0,
        dtype=jnp.float64,
    )
    try:
        world = SimWorld.office()
        gt = square_loop_trajectory(side=5.0, step=0.5, laps=1,
                                    start=(-2.5, -2.5))[:8]
        rng = np.random.default_rng(0)
        for p in gt:
            scan = simulate_scan(world, p, n_beams=200, range_threshold=5.0,
                                 noise=0.004, rng=rng)
            mapper.enqueue_scan(
                scan.ranges, scan.min_angle, scan.max_angle,
                scan.angle_increment, 0.0, 30.0, tuple(p),
            )
        assert mapper.drain(timeout=120)
        assert len(mapper.slam.graph.vertices) >= 6
    finally:
        mapper.close()


def test_carmen_loader(tmp_path):
    n = 180
    rng = np.random.default_rng(5)
    lines = []
    for i in range(4):
        ranges = " ".join(f"{v:.3f}" for v in rng.uniform(0.5, 15.0, n))
        lines.append(
            f"FLASER {n} {ranges} {0.1*i} {0.0} {0.0} {0.1*i} {0.0} {0.0} "
            f"{100.0+i} host {1.0+i}"
        )
    path = tmp_path / "mini.clf"
    path.write_text("\n".join(lines) + "\n")
    scans = load_carmen_log(str(path))
    assert len(scans) == 4
    assert len(scans[0].ranges) == n
    assert np.isclose(scans[1].odom_x, 0.1)
    lrs = carmen_to_localized_scans(scans)
    assert len(lrs) == 4
    px, py = lrs[0].points()
    assert len(px) > 100


def test_carmen_robotlaser1_real_layout(tmp_path):
    """ROBOTLASER1 lines in the exact CARMEN v2 field layout (laser
    params, readings, remissions, laser+robot poses, tv/rv/safety/
    turn_axis, timestamps) must parse identically through the native C++
    parser and the pure-Python fallback, end to end into LocalizedRangeScan
   ."""
    from yag_slam_tpu import native
    from yag_slam_tpu.io.benchmark import generate_benchmark_log
    from yag_slam_tpu.io.carmen import parse_carmen_line

    log, gtp, n = generate_benchmark_log(
        str(tmp_path / "sim_rl1.clf"), step=0.5, laps=1, n_beams=180,
        seed=0, fmt="robotlaser1",
    )
    with open(log) as f:
        first_line = f.readline()
    assert first_line.startswith("ROBOTLASER1 0 ")
    # python parser
    py_scans = [parse_carmen_line(l) for l in open(log)]
    py_scans = [s for s in py_scans if s is not None]
    assert len(py_scans) == n
    s0 = py_scans[1]
    assert len(s0.ranges) == 180
    assert np.isclose(s0.min_angle, -np.pi / 2)
    assert np.isclose(s0.angle_increment, np.pi / 180, atol=1e-5)
    assert np.isclose(s0.max_range, 81.9)
    assert np.isclose(s0.timestamp, 0.05)  # NOT the tv/turn_axis fields
    # native parser must agree field-for-field
    if native.available():
        nat = native.parse_carmen(log)
        assert len(nat) == n
        for a, b in zip(py_scans[:5], nat[:5]):
            np.testing.assert_allclose(a.ranges, b.ranges)
            for f in ("min_angle", "max_angle", "angle_increment",
                      "max_range", "odom_x", "odom_y", "odom_theta",
                      "timestamp"):
                assert np.isclose(getattr(a, f), getattr(b, f)), f
    # end-to-end into the scan model + matcher view
    lrs = carmen_to_localized_scans(py_scans, range_threshold=8.0)
    px, py = lrs[0].points()
    assert len(px) > 100


def test_offline_mapper_cli(tmp_path):
    from yag_slam_tpu.apps.offline_mapper import main

    out = str(tmp_path / "run")
    summary = main(["--synthetic-laps", "1", "--out", out])
    assert summary["vertices"] > 30
    assert summary["ate_rmse"] < 0.3
    import os

    assert os.path.exists(out + ".graph")

    # --stream (blocked device-chained ingestion) must reproduce the
    # per-scan run: same graph, same closures, same ATE
    out2 = str(tmp_path / "run_stream")
    summary2 = main(["--synthetic-laps", "1", "--out", out2, "--stream",
                     "--no-map-image"])
    assert summary2["vertices"] == summary["vertices"]
    assert summary2["loop_closures"] == summary["loop_closures"]
    assert abs(summary2["ate_rmse"] - summary["ate_rmse"]) < 1e-6


def test_offline_mapper_resumes_from_checkpoint(tmp_path):
    """--resume loads a saved graph and keeps mapping the rest of the log
    (--first-scan); each run reports ATE for the scans it integrated,
    beside raw odometry's."""
    from yag_slam_tpu.apps.offline_mapper import main
    from yag_slam_tpu.io.benchmark import generate_benchmark_log

    log, gtp, n = generate_benchmark_log(
        str(tmp_path / "b.clf"), step=0.5, laps=1, n_beams=120, seed=1)
    cfg = ["--carmen", log, "--gt", gtp, "--range-threshold", "6",
           "--resolution", "0.03", "--search-size", "0.5",
           "--smear-deviation", "0.05", "--loop-resolution", "0.06",
           "--no-map-image"]
    first = main(cfg + ["--max-scans", "60", "--out", str(tmp_path / "a")])
    second = main(cfg + ["--max-scans", "90", "--first-scan", "60",
                         "--resume", first["graph"],
                         "--out", str(tmp_path / "b")])
    assert first["integrated"] > 10 and second["integrated"] > 5
    assert second["vertices"] == first["vertices"] + second["integrated"]
    for s in (first, second):
        assert np.isfinite(s["ate_rmse"]) and np.isfinite(s["ate_rmse_odom"])
        assert s["ate_rmse"] < 0.5

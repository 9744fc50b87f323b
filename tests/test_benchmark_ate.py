"""Benchmark-sequence ATE through the CARMEN parse path.

The reference names the Intel/MIT CARMEN datasets in an unimplemented stub
(/root/reference/yag_slam/helpers.py:607-610) and never produces an ATE
number.  This test produces one end-to-end through the exact pipeline a
real Intel log would take: io.benchmark generates an Intel-style building
tour as standard FLASER lines + a ground-truth sidecar, the offline mapper
CLI loads it through io.carmen/parse_carmen, runs online SLAM with loop
closure, and the summary's `ate_rmse` must beat raw odometry and land
under an absolute bound.
"""
import json
import numpy as np
import pytest

from yag_slam_tpu.io.benchmark import generate_benchmark_log
from yag_slam_tpu.io.carmen import load_carmen_log
from yag_slam_tpu.utils.metrics import ate_rmse


@pytest.fixture(scope="module")
def benchmark_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("carmen_bench")
    log, gtp, n = generate_benchmark_log(
        str(tmp / "sim_intel.clf"), step=0.5, laps=1, n_beams=180, seed=0,
        yaw_bias=0.0020, xy_noise=0.003, yaw_noise=0.0015,
    )
    from yag_slam_tpu.apps.offline_mapper import main

    summary = main([
        "--carmen", log, "--gt", gtp, "--out", str(tmp / "map"),
        "--range-threshold", "8",
        "--resolution", "0.02", "--search-size", "0.5",
        "--smear-deviation", "0.03",
        "--loop-resolution", "0.05", "--loop-search-size", "2.0",
        "--loop-search-distance", "2.5", "--loop-min-chain", "5",
        "--min-response-coarse", "0.35", "--min-response-fine", "0.45",
        "--min-distance", "0.4", "--min-rotation", "0.4",
        "--no-map-image",
    ])
    return log, gtp, n, summary


def test_carmen_ate_beats_odometry(benchmark_run):
    log, gtp, n, summary = benchmark_run
    assert summary["loop_closures"] >= 1
    assert "ate_rmse" in summary

    # raw-odometry ATE over the same (integrated-subset superset) sequence:
    # the drifted odometry recorded in the FLASER lines vs the sidecar gt
    scans = load_carmen_log(log)
    odom = np.array([[s.odom_x, s.odom_y] for s in scans])
    gt = np.loadtxt(gtp)[: len(scans), :2]
    ate_odom = ate_rmse(odom, gt, align=False)

    assert summary["ate_rmse"] < ate_odom, (
        f"SLAM ATE {summary['ate_rmse']:.3f} did not beat odometry "
        f"{ate_odom:.3f}"
    )
    # absolute bound: published Intel-sequence results for graph SLAM sit
    # well under 0.5 m RMSE; this synthetic tour is easier (no glass, no
    # people), so hold a similar absolute bar
    assert summary["ate_rmse"] < 0.5


def test_carmen_log_is_wellformed(benchmark_run):
    log, gtp, n, summary = benchmark_run
    with open(log) as f:
        first = f.readline().split()
    assert first[0] == "FLASER"
    n_beams = int(first[1])
    assert n_beams == 180
    # FLASER layout: tag, count, ranges..., x y theta odom_x odom_y
    # odom_theta ts host ts
    assert len(first) == 2 + n_beams + 6 + 3
    assert np.loadtxt(gtp).shape == (n, 3)

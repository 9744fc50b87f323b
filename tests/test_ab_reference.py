"""Whole-pipeline A/B: reference-matcher-driven GraphSlam vs the JAX
pipeline on the same CARMEN log.

The per-match golden tests pin 1e-12 parity against the reference
algorithm (tests/test_native.py, tests/test_matching.py); this module
converts that into whole-TRAJECTORY parity evidence:
the full GraphSlam orchestration driven by the reference-equivalent C++
matcher (native/refbaseline.cpp wrapped by matching/refmatcher.py — the
reference pipeline, /root/reference/yag_slam/graph_slam.py:306-339)
produces a reference trajectory, and the JAX pipeline's ATE/closure count
must match or beat it.
"""
import numpy as np
import pytest

from yag_slam_tpu import native

pytestmark = pytest.mark.skipif(
    not native.refbaseline_available(),
    reason="native _refbaseline extension not built",
)


@pytest.fixture(scope="module")
def ab_run(tmp_path_factory):
    import jax.numpy as jnp

    from yag_slam_tpu.apps.ab_compare import ab_compare, build_parser
    from yag_slam_tpu.io.benchmark import generate_benchmark_log

    tmp = tmp_path_factory.mktemp("ab_ref")
    log, gtp, n = generate_benchmark_log(
        str(tmp / "sim_intel.clf"), step=0.5, laps=1, n_beams=180, seed=0,
        yaw_bias=0.0020, xy_noise=0.003, yaw_noise=0.0015,
    )
    args = build_parser().parse_args([])
    args.dtype = jnp.float64  # CPU test lane matches tests/conftest.py
    return ab_compare(log, gtp, args)


def test_reference_pipeline_runs(ab_run):
    ref = ab_run["ref"]
    assert ref["matcher"] == "refbaseline_cpp"
    assert ref["vertices"] > 100
    assert ref["loop_closures"] >= 1
    assert np.isfinite(ref["ate_rmse"])
    # the reference pipeline itself must beat raw odometry on its own run
    assert ref["ate_rmse"] < ref["ate_odom"]


def test_ate_parity_vs_reference_pipeline(ab_run):
    """JAX-pipeline trajectory matches or beats the reference-driven
    run on the same log: same integrated subset, ATE within 10% (both
    pipelines make float-boundary accept/reject decisions, so exact
    trajectory equality is not required — closure-level agreement is)."""
    ref, ours = ab_run["ref"], ab_run["jax"]
    # identical gating -> identical integrated subset -> same vertex count
    assert ours["vertices"] == ref["vertices"]
    # closure behavior must agree to within one closure
    assert abs(ours["loop_closures"] - ref["loop_closures"]) <= 1
    assert ours["loop_closures"] >= 1
    # the headline: ATE matches (10% + 2 cm slack for decision-boundary
    # divergence) or beats the reference pipeline's
    assert ours["ate_rmse"] <= ref["ate_rmse"] * 1.10 + 0.02, ab_run
    # and both beat raw odometry
    assert ours["ate_rmse"] < ours["ate_odom"]

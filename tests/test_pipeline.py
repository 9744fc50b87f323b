"""OnlineMatchPipeline: the device-chained sequential matcher must
reproduce the step-by-step match_scan loop (same windows, same priors)."""
import numpy as np
import jax.numpy as jnp
import pytest

from yag_slam_tpu.core.transform import Transform
from yag_slam_tpu.io.simulator import SimWorld, simulate_scan
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu.matching.pipeline import OnlineMatchPipeline

CFG = {
    "range_threshold": 6.0,
    "resolution": 0.02,
    "search_size": 0.5,
    "smear_deviation": 0.05,
}


def make_stream(n=18, n_beams=240, drift=0.004):
    """Simulated scans with noisy odometry: odom_pose drifts from the true
    pose so the matcher has corrections to make."""
    world = SimWorld.office()
    rng = np.random.default_rng(3)
    scans = []
    true_poses = []
    odom = np.zeros(3)
    for i in range(n):
        true = np.array([0.12 * i - 1.0, 0.08 * i - 0.8, 0.04 * i])
        s = simulate_scan(world, true, n_beams=n_beams,
                          range_threshold=CFG["range_threshold"],
                          noise=0.003, rng=rng)
        if i == 0:
            odom = true.copy()
        else:
            odom = true + rng.normal(0, drift, 3)
        s.odom_pose = Transform.from_xyt(*odom)
        s.corrected_pose = Transform.from_xyt(*true)
        scans.append(s)
        true_poses.append(true)
    return scans, true_poses


def run_sequential(scans, window):
    """The reference's online loop: blocking match per scan, odometry
    prior from the previous corrected pose."""
    m = CorrelativeScanMatcher(CFG, dtype=jnp.float64)
    results = []
    for k in range(window, len(scans)):
        scan = scans[k]
        last = scans[k - 1]
        scan.corrected_pose = last.corrected_pose + (
            scan.odom_pose - last.odom_pose
        )
        base = scans[k - window: k]
        res = m.match_scan(scan, base, True, True)
        scan.corrected_pose = res.best_pose
        results.append(res)
    return results


def test_pipeline_matches_sequential_loop():
    window = 6
    scans_a, _ = make_stream()
    scans_b, _ = make_stream()

    ref = run_sequential(scans_a, window)

    m = CorrelativeScanMatcher(CFG, dtype=jnp.float64)
    pipe = OnlineMatchPipeline(m, window=window, sync_every=4)
    pipe.seed(scans_b[:window])
    for s in scans_b[window:]:
        pipe.push(s)
    got = pipe.flush()

    assert len(got) == len(ref)
    for r_ref, r_got, s_ref, s_got in zip(
        ref, got, scans_a[window:], scans_b[window:]
    ):
        # identical windows/grids; centers differ only by f64 SE(2) vs
        # quaternion composition rounding
        assert r_got.response == pytest.approx(r_ref.response, abs=1e-9)
        np.testing.assert_allclose(
            [s_got.corrected_pose.x, s_got.corrected_pose.y,
             s_got.corrected_pose.euler[-1]],
            [s_ref.corrected_pose.x, s_ref.corrected_pose.y,
             s_ref.corrected_pose.euler[-1]],
            atol=1e-9,
        )
        np.testing.assert_allclose(r_got.covariance, r_ref.covariance,
                                   rtol=1e-9, atol=1e-12)


def test_block_dispatch_matches_sequential_loop():
    """block_dispatch=True (sync_every chained steps in ONE lax.scan
    program — 1 dispatch + 1 readback per block) must produce the
    sequential loop's results exactly, including a partial block at
    flush."""
    window = 6
    scans_a, _ = make_stream()
    scans_b, _ = make_stream()

    ref = run_sequential(scans_a, window)

    m = CorrelativeScanMatcher(CFG, dtype=jnp.float64)
    pipe = OnlineMatchPipeline(m, window=window, sync_every=5,
                               block_dispatch=True)
    pipe.seed(scans_b[:window])
    for s in scans_b[window:]:
        pipe.push(s)
    got = pipe.flush()          # 12 pushes: 2 full blocks + partial of 2

    assert len(got) == len(ref)
    for r_ref, r_got, s_ref, s_got in zip(
        ref, got, scans_a[window:], scans_b[window:]
    ):
        assert r_got.response == pytest.approx(r_ref.response, abs=1e-9)
        np.testing.assert_allclose(
            [s_got.corrected_pose.x, s_got.corrected_pose.y,
             s_got.corrected_pose.euler[-1]],
            [s_ref.corrected_pose.x, s_ref.corrected_pose.y,
             s_ref.corrected_pose.euler[-1]],
            atol=1e-9,
        )
        np.testing.assert_allclose(r_got.covariance, r_ref.covariance,
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("block,sync_every,lag",
                         [(True, 2, 1), (True, 4, 1), (False, 4, 2)])
def test_lagged_readback_matches_sequential_loop(block, sync_every, lag):
    """lag_blocks > 0 (readback coalescing) defers
    each group's host fetch by `lag` dispatches so the transfer overlaps
    the next block's compute.  Results and final poses must still equal
    the sequential loop's exactly, including the lagged tail at flush."""
    window = 6
    scans_a, _ = make_stream(n=20)
    scans_b, _ = make_stream(n=20)

    ref = run_sequential(scans_a, window)

    m = CorrelativeScanMatcher(CFG, dtype=jnp.float64)
    pipe = OnlineMatchPipeline(m, window=window, sync_every=sync_every,
                               block_dispatch=block, lag_blocks=lag)
    pipe.seed(scans_b[:window])
    n_results_seen = 0
    for s in scans_b[window:]:
        pipe.push(s)
        n_results_seen += len(pipe.drain())
    got_tail = pipe.flush()
    assert n_results_seen + len(got_tail) == len(ref)
    for r_ref, s_ref, s_got in zip(ref, scans_a[window:], scans_b[window:]):
        np.testing.assert_allclose(
            [s_got.corrected_pose.x, s_got.corrected_pose.y,
             s_got.corrected_pose.euler[-1]],
            [s_ref.corrected_pose.x, s_ref.corrected_pose.y,
             s_ref.corrected_pose.euler[-1]],
            atol=1e-9,
        )


def test_lagged_redo_folds_in_kept_groups():
    """A redo detected in a drained group must also re-run the
    still-lagged groups (their device chain consumed the poisoned pose)
    and still reproduce the sequential loop exactly."""
    window = 6
    scans_a, _ = make_stream(n=20)
    scans_b, _ = make_stream(n=20)

    ref = run_sequential(scans_a, window)

    m = CorrelativeScanMatcher(CFG, dtype=jnp.float64)
    pipe = OnlineMatchPipeline(m, window=window, sync_every=2,
                               block_dispatch=True, lag_blocks=1)
    real_valid = pipe._subgrid_valid
    calls = []

    def fake_valid(base, center, sub_used):
        calls.append(center)
        if len(calls) == 2:
            return False
        return real_valid(base, center, sub_used)

    pipe._subgrid_valid = fake_valid
    pipe.seed(scans_b[:window])
    for s in scans_b[window:]:
        pipe.push(s)
    got = pipe.flush()

    assert pipe.stats["redo_sweeps"] >= 1
    assert len(got) == len(ref)
    for r_ref, s_ref, s_got in zip(ref, scans_a[window:], scans_b[window:]):
        np.testing.assert_allclose(
            [s_got.corrected_pose.x, s_got.corrected_pose.y,
             s_got.corrected_pose.euler[-1]],
            [s_ref.corrected_pose.x, s_ref.corrected_pose.y,
             s_ref.corrected_pose.euler[-1]],
            atol=1e-9,
        )


def test_pipeline_redo_sweep_mid_batch():
    """The sync-time validation's synchronous forward sweep: when a mid-batch match is flagged (subgrid insufficient
    at the device-exact poses, or empty coarse response), it and every
    chained match after it must be redone as ONE bounded lockstep sweep —
    each retry centered on the previous scan's device-exact pose composed
    with the odometry delta — and the final results
    must equal the sequential loop's exactly."""
    window = 6
    scans_a, _ = make_stream(n=20)
    scans_b, _ = make_stream(n=20)

    ref = run_sequential(scans_a, window)

    m = CorrelativeScanMatcher(CFG, dtype=jnp.float64)
    pipe = OnlineMatchPipeline(m, window=window, sync_every=8)
    # flag the 3rd entry of the first sync batch as invalid: the sweep
    # must redo entries 3.. of that batch (the chained poses after a bad
    # match are all tainted) and leave entries 0-2 from the device
    real_valid = pipe._subgrid_valid
    calls = []

    def fake_valid(base, center, sub_used):
        calls.append(center)
        if len(calls) == 3:
            return False
        return real_valid(base, center, sub_used)

    pipe._subgrid_valid = fake_valid
    pipe.seed(scans_b[:window])
    for s in scans_b[window:]:
        pipe.push(s)
    got = pipe.flush()

    assert pipe.stats["redo_sweeps"] == 1
    assert pipe.stats["redo_matches"] == 8 - 2  # entries 2..7 of batch 1
    assert len(got) == len(ref)
    for r_ref, r_got, s_ref, s_got in zip(
        ref, got, scans_a[window:], scans_b[window:]
    ):
        assert r_got.response == pytest.approx(r_ref.response, abs=1e-9)
        np.testing.assert_allclose(
            [s_got.corrected_pose.x, s_got.corrected_pose.y,
             s_got.corrected_pose.euler[-1]],
            [s_ref.corrected_pose.x, s_ref.corrected_pose.y,
             s_ref.corrected_pose.euler[-1]],
            atol=1e-9,
        )


def test_subgrid_valid_semantics():
    """_subgrid_valid must pass when the exact-pose base occupancy (+
    smear halo) fits the used subgrid and fail when it leaks past an
    edge."""
    window = 4
    scans, _ = make_stream(n=window + 1)
    m = CorrelativeScanMatcher(CFG, dtype=jnp.float64)
    pipe = OnlineMatchPipeline(m, window=window)
    pipe.seed(scans[:window])
    pipe.push(scans[window])
    pipe.flush()

    base = scans[:window]
    center = np.array([scans[window].corrected_pose.x,
                       scans[window].corrected_pose.y, 0.0])
    # ground truth from the matcher's own (margin-free) subgrid selection
    sox, soy, S = m._subgrid_for(base, center[0], center[1], m._point_cap)
    G = m.grid_size
    if S >= G:
        assert pipe._subgrid_valid(base, center, (0, 0, S))
        return
    assert pipe._subgrid_valid(base, center, (sox, soy, S))
    # shift the subgrid so the occupied bbox leaks past its high edge
    assert not pipe._subgrid_valid(base, center, (sox - S // 2, soy, S))
    assert not pipe._subgrid_valid(base, center, (sox, soy - S // 2, S))


def test_pipeline_corrects_odometry_drift():
    """With strong odometry noise the pipeline must still pull poses back
    toward the truth (i.e. it genuinely matches, not just integrates)."""
    window = 6
    scans, true_poses = make_stream(drift=0.03)
    m = CorrelativeScanMatcher(CFG, dtype=jnp.float64)
    pipe = OnlineMatchPipeline(m, window=window, sync_every=16)
    pipe.seed(scans[:window])
    for s in scans[window:]:
        pipe.push(s)
    results = pipe.flush()
    assert all(r.response > 0.3 for r in results)
    errs = [
        np.hypot(s.corrected_pose.x - t[0], s.corrected_pose.y - t[1])
        for s, t in zip(scans[window:], true_poses[window:])
    ]
    odo_errs = [
        np.hypot(s.odom_pose.x - t[0], s.odom_pose.y - t[1])
        for s, t in zip(scans[window:], true_poses[window:])
    ]
    # matched poses closer to truth than raw odometry on average
    assert np.mean(errs) < np.mean(odo_errs)
    assert np.mean(errs) < 0.06

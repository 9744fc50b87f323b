"""Multi-chip paths on the 8-virtual-device CPU mesh: sharded loop-closure
matching and distributed SPA must agree with their single-device versions."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from yag_slam_tpu.io.simulator import SimWorld, simulate_scan
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu.parallel.sharding import default_mesh
from yag_slam_tpu.parallel.loop_search import ShardedLoopMatcher
from yag_slam_tpu.parallel.dist_spa import DistributedSPA
from yag_slam_tpu.graphopt.spa import SPA2d
from yag_slam_tpu.core.transform import se2_compose, se2_relative

CFG = {"range_threshold": 5.0, "resolution": 0.05, "search_size": 2.0,
       "smear_deviation": 0.05}


def make_jobs(n_jobs=5):
    world = SimWorld.office()
    rng = np.random.default_rng(0)
    jobs = []
    for j in range(n_jobs):
        base_pose = np.array([0.3 * j - 1.0, 0.2 * j - 1.0, 0.1 * j])
        chain = [
            simulate_scan(world, base_pose + [0.3 * i, 0.05, 0.0], n_beams=180,
                          range_threshold=5.0, noise=0.004, rng=rng)
            for i in range(3)
        ]
        query = simulate_scan(world, base_pose + [0.1, 0.05, 0.02],
                              n_beams=180, range_threshold=5.0, noise=0.004,
                              rng=rng)
        jobs.append((query, chain))
    return jobs


def test_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_loop_matcher_matches_unsharded():
    jobs = make_jobs(5)
    matcher = CorrelativeScanMatcher(CFG, loop=True, dtype=jnp.float64)
    plain = matcher.match_many(jobs, penalty=False, do_fine=False)

    mesh = default_mesh()
    sharded = ShardedLoopMatcher(
        CorrelativeScanMatcher(CFG, loop=True, dtype=jnp.float64), mesh
    )
    shard_res = sharded.match_many(jobs, penalty=False, do_fine=False)

    assert len(plain) == len(shard_res) == 5
    for a, b in zip(plain, shard_res):
        assert np.isclose(a.response, b.response, rtol=1e-9)
        assert np.allclose(
            [a.best_pose.x, a.best_pose.y, a.best_pose.euler[-1]],
            [b.best_pose.x, b.best_pose.y, b.best_pose.euler[-1]],
            atol=1e-9,
        )


def build_loop_graph(spa):
    rng = np.random.default_rng(3)
    true = [np.array([0.0, 0.0, 0.0])]
    for side in range(4):
        for _ in range(4):
            true.append(se2_compose(true[-1], np.array([1.0, 0.0, 0.0])))
        true.append(se2_compose(true[-1], np.array([0.0, 0.0, np.pi / 2])))
    n = len(true)
    info = np.diag([50.0, 50.0, 100.0])
    guesses = [true[0]]
    edges = []
    for i in range(n - 1):
        mean = se2_relative(true[i + 1], true[i]) + rng.normal(0, 0.02, 3)
        edges.append(((i, i + 1), mean, info))
        guesses.append(se2_compose(guesses[-1], mean))
    edges.append(((n - 1, 0), se2_relative(true[0], true[-1]),
                  np.diag([500.0, 500.0, 1000.0])))
    for i, g in enumerate(guesses):
        spa.add_node(g[0], g[1], g[2], i)
    for (i, j), mean, I in edges:
        spa.add_constraint(i, j, *mean, I.tolist())
    return n


@pytest.mark.parametrize("mixed", [True, False])
def test_distributed_spa_matches_single_device(mixed):
    """Both the mixed-precision (f32 inner CG + f64 refinement) and the
    all-f64 distributed solves must match the single-device optimum."""
    ref = SPA2d()
    build_loop_graph(ref)
    ref_cost = ref.compute(100, 1.0e-4, True, 1.0e-12, 50)

    dist = DistributedSPA(default_mesh(), mixed=mixed)
    build_loop_graph(dist)
    dist_cost = dist.compute(100, 1.0e-4, True, 1.0e-12, 50)

    assert np.isclose(ref_cost, dist_cost, rtol=1e-6)
    for a, b in zip(ref.nodes, dist.nodes):
        assert np.allclose([a.x, a.y, a.yaw], [b.x, b.y, b.yaw], atol=1e-5)


def test_graphslam_with_sharded_loop_matcher():
    """ShardedLoopMatcher drops into GraphSlam as the loop matcher and the
    2-lap loop still closes on the virtual mesh."""
    from yag_slam_tpu.io.simulator import (
        SimWorld, drifted_odometry, simulate_scan, square_loop_trajectory)
    from yag_slam_tpu.slam.graph_slam import GraphSlam
    from yag_slam_tpu.utils.metrics import ate_rmse, trajectory_from_slam

    seq_cfg = {"range_threshold": 5.0, "resolution": 0.02, "search_size": 0.5,
               "smear_deviation": 0.05}
    loop_cfg = {"range_threshold": 5.0, "resolution": 0.05, "search_size": 2.0,
                "smear_deviation": 0.05}
    world = SimWorld.office()
    gt = square_loop_trajectory(side=5.0, step=0.5, laps=2, start=(-2.5, -2.5))
    odom = drifted_odometry(gt, yaw_bias=0.0025, seed=1)
    rng = np.random.default_rng(101)
    scans = [
        simulate_scan(world, gt[i], n_beams=250, range_threshold=5.0,
                      noise=0.004, rng=rng, odom_pose_xyt=odom[i])
        for i in range(len(gt))
    ]
    loop = ShardedLoopMatcher(
        CorrelativeScanMatcher(loop_cfg, loop=True, dtype=jnp.float64),
        default_mesh(),
    )
    slam = GraphSlam(
        CorrelativeScanMatcher(seq_cfg, dtype=jnp.float64), loop,
        loop_search_dist=2.0, loop_search_min_chain_size=5,
    )
    for s in scans:
        slam.process_scan(s)
    assert slam.stats["loop_closures"] >= 1
    est = trajectory_from_slam(slam)
    assert ate_rmse(est, gt[:, :2], align=False) < 0.15


def test_graphslam_fully_sharded_stack():
    """ShardedLoopMatcher AND DistributedSPA inside ONE GraphSlam
   : loop-closure fan-out and the global solve both
    ride the same virtual mesh, end to end, and the loop still closes."""
    from yag_slam_tpu.io.simulator import (
        SimWorld, drifted_odometry, simulate_scan, square_loop_trajectory)
    from yag_slam_tpu.slam.graph_slam import GraphSlam
    from yag_slam_tpu.utils.metrics import ate_rmse, trajectory_from_slam

    seq_cfg = {"range_threshold": 5.0, "resolution": 0.02, "search_size": 0.5,
               "smear_deviation": 0.05}
    loop_cfg = {"range_threshold": 5.0, "resolution": 0.05, "search_size": 2.0,
                "smear_deviation": 0.05}
    world = SimWorld.office()
    gt = square_loop_trajectory(side=5.0, step=0.5, laps=2, start=(-2.5, -2.5))
    odom = drifted_odometry(gt, yaw_bias=0.0025, seed=1)
    rng = np.random.default_rng(101)
    scans = [
        simulate_scan(world, gt[i], n_beams=250, range_threshold=5.0,
                      noise=0.004, rng=rng, odom_pose_xyt=odom[i])
        for i in range(len(gt))
    ]
    mesh = default_mesh()
    slam = GraphSlam(
        CorrelativeScanMatcher(seq_cfg, dtype=jnp.float64),
        ShardedLoopMatcher(
            CorrelativeScanMatcher(loop_cfg, loop=True, dtype=jnp.float64),
            mesh,
        ),
        loop_search_dist=2.0, loop_search_min_chain_size=5,
        opt=DistributedSPA(mesh),
    )
    for s in scans:
        slam.process_scan(s)
    assert slam.stats["loop_closures"] >= 1
    est = trajectory_from_slam(slam)
    assert ate_rmse(est, gt[:, :2], align=False) < 0.15


def _serpentine_grid_graph(spa, rows=64, cols=64, seed=5):
    """A ~4k-node 'lifelong mapping' graph: serpentine sweep over a
    rows x cols lattice (odometry chain) + loop-closure edges between
    vertically adjacent lattice nodes (row revisits), all with noise.
    Returns node count."""
    rng = np.random.default_rng(seed)
    true = []
    for r in range(rows):
        rng_cols = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        for c in rng_cols:
            true.append(np.array([float(c), float(r), 0.0]))
    n = len(true)
    info = np.diag([50.0, 50.0, 100.0])
    info_lc = np.diag([200.0, 200.0, 400.0])
    guesses = [true[0]]
    for i in range(n - 1):
        mean = se2_relative(true[i + 1], true[i]) + rng.normal(0, 0.01, 3)
        guesses.append(se2_compose(guesses[-1], mean))
    for i, g in enumerate(guesses):
        spa.add_node(g[0], g[1], g[2], i)
    for i in range(n - 1):
        mean = se2_relative(true[i + 1], true[i]) + rng.normal(0, 0.01, 3)
        spa.add_constraint(i, i + 1, *mean, info.tolist())
    # vertical revisit closures: node (r, c) <-> (r+1, c)
    def node_id(r, c):
        return r * cols + (c if r % 2 == 0 else cols - 1 - c)
    for r in range(rows - 1):
        for c in range(0, cols, 4):
            a, b = node_id(r, c), node_id(r + 1, c)
            mean = se2_relative(true[b], true[a]) + rng.normal(0, 0.005, 3)
            spa.add_constraint(a, b, *mean, info_lc.tolist())
    return n


def test_dist_spa_cg_large_graph_matches_host():
    """The scalable distributed path (matrix-free psum-reduced PCG) must
    reproduce the exact host solve on a 4096-node noisy loop graph across
    the 8-device mesh."""
    host = SPA2d(solver="host")
    n = _serpentine_grid_graph(host)
    assert n == 4096
    host_cost = host.compute(100, 1.0e-4, True, 1.0e-9, 50, conv_tol=1e-12)

    dist = DistributedSPA(default_mesh(), solver="cg")
    _serpentine_grid_graph(dist)
    dist_cost = dist.compute(60, 1.0e-4, True, 1.0e-8, 600, conv_tol=1e-12)

    assert np.isclose(host_cost, dist_cost, rtol=1e-5)
    hp = np.array([[v.x, v.y, v.yaw] for v in host.nodes])
    dp = np.array([[v.x, v.y, v.yaw] for v in dist.nodes])
    assert np.max(np.abs(hp - dp)) < 1e-5


def test_dist_spa_no_dense_hessian():
    """No (3N, 3N) — nor any O(N^2) — array may be materialized anywhere in
    the sharded CG program: per-device memory must be O(E/n + N)."""
    from yag_slam_tpu.parallel.dist_spa import make_distributed_lm_run_cg
    from yag_slam_tpu.graphopt.spa import _cap

    n_cap = 4096
    e_cap = 8192
    mesh = default_mesh()
    prog = make_distributed_lm_run_cg(mesh, n_cap, 10, 50)

    import jax.numpy as jnp
    args = (
        jnp.zeros((n_cap, 3)), jnp.zeros((e_cap, 2), jnp.int32),
        jnp.zeros((e_cap, 3)), jnp.zeros((e_cap, 3, 3)),
        jnp.zeros(e_cap, bool), jnp.zeros(n_cap, bool),
        jnp.asarray(1e-4), jnp.asarray(1e-12), jnp.asarray(1e-9),
    )
    jaxpr = jax.make_jaxpr(prog)(*args)

    limit = 9 * n_cap * n_cap  # dense H element count
    biggest = 0

    def walk(jx):
        nonlocal biggest
        for eqn in jx.eqns:
            for v in eqn.outvars:
                if hasattr(v, "aval") and hasattr(v.aval, "shape"):
                    sz = int(np.prod(v.aval.shape)) if v.aval.shape else 1
                    biggest = max(biggest, sz)
                    assert sz < limit, (
                        f"dense-scale intermediate {v.aval.shape} in "
                        f"{eqn.primitive}"
                    )
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    # sanity: the program's biggest live array is edge-shard/pose scale,
    # orders of magnitude below dense-H scale
    assert biggest <= 16 * max(9 * e_cap, 3 * n_cap)


def test_dist_spa_cg_float32():
    """The distributed path with float32 poses:
    LM with f32 PCG steps on a moderate loop graph must still reach the
    f64 host optimum to ~1e-3."""
    host = SPA2d(solver="host")
    build_loop_graph(host)
    host.compute(100, 1.0e-4, True, 1.0e-9, 50, conv_tol=1e-12)
    hp = np.array([[v.x, v.y, v.yaw] for v in host.nodes])

    with jax.enable_x64(False):
        dist = DistributedSPA(default_mesh(), solver="cg",
                              dtype=jnp.float32)
        build_loop_graph(dist)
        cost = dist.compute(100, 1.0e-4, True, 1.0e-6, 200, conv_tol=1e-10)
    assert np.isfinite(cost)
    dp = np.array([[v.x, v.y, v.yaw] for v in dist.nodes])
    assert np.max(np.abs(hp - dp)) < 2e-3

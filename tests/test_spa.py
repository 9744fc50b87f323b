"""Pose-graph optimizer tests, including a scipy least-squares oracle."""
import numpy as np
import pytest

from yag_slam_tpu.core.transform import se2_compose, se2_relative, se2_wrap
from yag_slam_tpu.graphopt.spa import SPA2d, PoseGraphSolver


def relative(a, b):
    """Pose of b in a's frame (the reference's `to - from`)."""
    return se2_relative(b, a)


def test_chain_exact_recovery():
    """Perfect odometry constraints with corrupted initial guesses must be
    pulled back to the exact chain (gauge: node 0)."""
    rng = np.random.default_rng(0)
    true = [np.array([0.0, 0.0, 0.0])]
    for i in range(8):
        step = np.array([1.0, 0.1 * np.sin(i), 0.2])
        true.append(se2_compose(true[-1], step))

    spa = SPA2d()
    for i, p in enumerate(true):
        guess = p + rng.normal(0, 0.3, 3) if i > 0 else p
        spa.add_node(guess[0], guess[1], guess[2], i)
    for i in range(len(true) - 1):
        m = relative(true[i], true[i + 1])
        spa.add_constraint(i, i + 1, m[0], m[1], m[2], np.eye(3).tolist())

    spa.compute(100, 1.0e-4, True, 1.0e-9, 50)
    for i, p in enumerate(true):
        n = spa.nodes[i]
        assert np.allclose([n.x, n.y], p[:2], atol=1e-6)
        assert abs(se2_wrap(n.yaw - p[2])) < 1e-6


def scipy_pose_graph_cost(poses0, edges, niter=200):
    """Oracle: optimize the same graph with scipy and return final cost."""
    from scipy.optimize import least_squares

    n = len(poses0)

    def residuals(x):
        p = np.vstack([poses0[0], x.reshape(n - 1, 3)])
        out = []
        for (i, j), mean, sqrt_info in edges:
            r = se2_relative(p[j], p[i]) - mean
            r[2] = se2_wrap(r[2])
            out.append(sqrt_info @ r)
        return np.concatenate(out)

    x0 = np.asarray(poses0[1:]).ravel()
    sol = least_squares(residuals, x0, max_nfev=niter)
    return 2 * sol.cost  # scipy cost = 0.5 * sum r^2


def test_noisy_loop_matches_scipy_oracle():
    """Square loop with noisy odometry + one loop closure: final chi2 must
    match scipy's optimum."""
    rng = np.random.default_rng(3)
    # ground truth: walk a square, 4 sides x 3 steps
    true = [np.array([0.0, 0.0, 0.0])]
    for side in range(4):
        for _ in range(3):
            true.append(se2_compose(true[-1], np.array([1.0, 0.0, 0.0])))
        true.append(se2_compose(true[-1], np.array([0.0, 0.0, np.pi / 2])))
    n = len(true)

    # noisy odometry means; noisy initial guesses by dead reckoning
    edges = []
    guesses = [true[0]]
    info = np.diag([50.0, 50.0, 100.0])
    sqrt_info = np.sqrt(info)
    for i in range(n - 1):
        mean = relative(true[i], true[i + 1]) + rng.normal(0, 0.03, 3)
        edges.append(((i, i + 1), mean, sqrt_info))
        guesses.append(se2_compose(guesses[-1], mean))
    # loop closure: last node to first with strong info
    lc_info = np.diag([500.0, 500.0, 1000.0])
    lc_mean = relative(true[-1], true[0])
    edges.append(((n - 1, 0), lc_mean, np.sqrt(lc_info)))

    spa = SPA2d()
    for i, g in enumerate(guesses):
        spa.add_node(g[0], g[1], g[2], i)
    for (i, j), mean, sqrt_info in edges:
        spa.add_constraint(i, j, *mean, (sqrt_info @ sqrt_info).tolist())
    final_cost = spa.compute(100, 1.0e-4, True, 1.0e-12, 50)

    oracle_cost = scipy_pose_graph_cost(guesses, edges)
    assert final_cost <= oracle_cost * (1 + 1e-6) + 1e-9
    # chi2 parity within 0.1%
    assert np.isclose(final_cost, oracle_cost, rtol=1e-3)

    # the loop must actually be closed: last node near where the closure says
    last = spa.nodes[n - 1]
    err = se2_relative(np.array([spa.nodes[0].x, spa.nodes[0].y, spa.nodes[0].yaw]),
                       np.array([last.x, last.y, last.yaw])) - lc_mean
    assert np.linalg.norm(err[:2]) < 0.05


def test_gauge_fixed():
    spa = SPA2d()
    spa.add_node(1.0, 2.0, 0.3, 0)
    spa.add_node(5.0, 5.0, 1.0, 1)
    spa.add_constraint(0, 1, 1.0, 0.0, 0.0, np.eye(3).tolist())
    spa.compute()
    assert np.allclose(
        [spa.nodes[0].x, spa.nodes[0].y, spa.nodes[0].yaw], [1.0, 2.0, 0.3]
    )
    # node 1 should now satisfy the constraint exactly
    rel = se2_relative(
        np.array([spa.nodes[1].x, spa.nodes[1].y, spa.nodes[1].yaw]),
        np.array([1.0, 2.0, 0.3]),
    )
    assert np.allclose(rel, [1.0, 0.0, 0.0], atol=1e-8)


def test_empty_and_tiny_graphs_noop():
    spa = SPA2d()
    assert spa.compute() == 0.0
    spa.add_node(0, 0, 0, 0)
    assert spa.compute() == 0.0


def test_incremental_reuse():
    """Growing the graph between solves must work (capacity bucketing)."""
    spa = SPA2d()
    spa.add_node(0, 0, 0, 0)
    for i in range(1, 40):
        spa.add_node(i * 1.0 + 0.1, 0.05, 0.0, i)
        spa.add_constraint(i - 1, i, 1.0, 0.0, 0.0, np.eye(3).tolist())
        if i % 10 == 0:
            spa.compute()
    spa.compute(200, 1.0e-4, True, 1.0e-16, 50)
    # cost tolerance maps to looser pose tolerance at the far end of the
    # chain (gauge lever arm), hence atol 1e-4
    for i in range(40):
        n = spa.nodes[i]
        assert np.allclose([n.x, n.y, n.yaw], [float(i), 0.0, 0.0], atol=1e-4)


def test_cg_solver_matches_dense():
    """Matrix-free PCG path must reach the same optimum as the dense
    factorization."""
    dense = SPA2d(solver="dense")
    cg = SPA2d(solver="cg")
    rng = np.random.default_rng(11)
    true = [np.array([0.0, 0.0, 0.0])]
    for side in range(4):
        for _ in range(5):
            true.append(se2_compose(true[-1], np.array([1.0, 0.0, 0.0])))
        true.append(se2_compose(true[-1], np.array([0.0, 0.0, np.pi / 2])))
    n = len(true)
    info = np.diag([40.0, 40.0, 90.0])
    guesses = [true[0]]
    edges = []
    for i in range(n - 1):
        mean = relative(true[i], true[i + 1]) + rng.normal(0, 0.02, 3)
        edges.append(((i, i + 1), mean))
        guesses.append(se2_compose(guesses[-1], mean))
    edges.append(((n - 1, 0), relative(true[-1], true[0])))

    for spa in (dense, cg):
        for i, g in enumerate(guesses):
            spa.add_node(g[0], g[1], g[2], i)
        for (i, j), mean in edges:
            spa.add_constraint(i, j, *mean, info.tolist())

    cd = dense.compute(100, 1.0e-4, True, 1.0e-12, 200)
    cc = cg.compute(100, 1.0e-4, True, 1.0e-12, 200)
    assert np.isclose(cd, cc, rtol=1e-4)
    for a, b in zip(dense.nodes, cg.nodes):
        assert np.allclose([a.x, a.y, a.yaw], [b.x, b.y, b.yaw], atol=1e-3)


def _noisy_loop_graph(n_side=12, seed=5):
    rng = np.random.default_rng(seed)
    true = [np.array([0.0, 0.0, 0.0])]
    for side in range(4):
        for _ in range(n_side):
            true.append(se2_compose(true[-1], np.array([0.5, 0.0, 0.0])))
        true.append(se2_compose(true[-1], np.array([0.0, 0.0, np.pi / 2])))
    info = np.diag([100.0, 100.0, 400.0])
    guesses = [true[0]]
    edges = []
    for i in range(len(true) - 1):
        mean = relative(true[i], true[i + 1]) + rng.normal(0, 0.01, 3)
        edges.append(((i, i + 1), mean))
        guesses.append(se2_compose(guesses[-1], mean))
    edges.append(((len(true) - 1, 0), relative(true[-1], true[0])))
    return guesses, edges, info


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_mixed_precision_matches_f64_and_host(solver):
    """The mixed-precision device steps (f32 factorization/CG + f64
    matrix-free iterative refinement) must reach the
    same optimum as the all-f64 device path and the host sparse solver on
    an ill-conditioned noisy loop."""
    guesses, edges, info = _noisy_loop_graph()
    results = {}
    for key, spa in (
        ("mixed", SPA2d(solver=solver, precision="mixed")),
        ("f64", SPA2d(solver=solver, precision="f64")),
        ("host", SPA2d(solver="host")),
    ):
        for i, g in enumerate(guesses):
            spa.add_node(g[0], g[1], g[2], i)
        for (i, j), mean in edges:
            spa.add_constraint(i, j, *mean, info.tolist())
        cost = spa.compute(100, 1.0e-4, True, 1.0e-12, 100)
        results[key] = (cost, np.array([[n.x, n.y, n.yaw]
                                        for n in spa.nodes]))
    c_m, p_m = results["mixed"]
    c_f, p_f = results["f64"]
    c_h, p_h = results["host"]
    assert np.isclose(c_m, c_h, rtol=1e-3), (c_m, c_h)
    assert np.isclose(c_m, c_f, rtol=1e-3), (c_m, c_f)
    assert np.allclose(p_m, p_h, atol=2e-3), np.abs(p_m - p_h).max()


def _f32_dot_precisions(fn, *args, **kwargs):
    """Precision of every float32 dot_general in fn's traced program,
    nested programs included."""
    import jax
    import jax.numpy as jnp

    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if (eqn.primitive.name == "dot_general"
                    and eqn.invars[0].aval.dtype == jnp.float32):
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else (v,):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jax.make_jaxpr(lambda *a: fn(*a, **kwargs))(*args).jaxpr)
    return found


def _padded_loop(n_side=4, seed=9, n_cap=32, e_cap=64):
    import jax.numpy as jnp

    guesses, edges, info = _noisy_loop_graph(n_side=n_side, seed=seed)
    n = len(guesses)
    poses = np.zeros((n_cap, 3))
    poses[:n] = np.asarray(guesses)
    eidx = np.zeros((e_cap, 2), dtype=np.int32)
    means = np.zeros((e_cap, 3))
    infos = np.zeros((e_cap, 3, 3))
    emask = np.zeros(e_cap, bool)
    for k, ((i, j), mean) in enumerate(edges):
        eidx[k] = (i, j)
        means[k] = mean
        infos[k] = info
        emask[k] = True
    free = np.zeros(n_cap, bool)
    free[1:n] = True
    return (jnp.asarray(poses), jnp.asarray(eidx), jnp.asarray(means),
            jnp.asarray(infos), jnp.asarray(emask), jnp.asarray(free),
            jnp.asarray(1.0e-4))


@pytest.mark.parametrize("step", ["dense", "cg"])
def test_mixed_steps_trace_f32_products_at_highest(step):
    """The f32 products of the mixed-precision steps carry precision
    HIGHEST, so no backend may run them in a reduced format (TF32)."""
    import jax
    import jax.numpy as jnp

    from yag_slam_tpu.graphopt import spa as S

    args = _padded_loop()
    if step == "dense":
        found = _f32_dot_precisions(S._lm_candidate_mixed, *args, n_cap=32)
    else:
        found = _f32_dot_precisions(S._lm_candidate_cg_mixed, *args,
                                    jnp.asarray(1e-9), n_cap=32, cg_iters=20)
    assert found, "no f32 products traced"
    hi = jax.lax.Precision.HIGHEST
    assert all(p == (hi, hi) for p in found), found


def test_mixed_dense_step_matches_f64_step():
    """One damped step: f32 Cholesky + f64 refinement lands on the all-f64
    step (the refinement recovers f64 accuracy)."""
    from yag_slam_tpu.graphopt import spa as S

    args = _padded_loop()
    cand_m, cost_m = S._lm_candidate_mixed(*args, n_cap=32)
    cand_f, cost_f = S.lm_candidate(*args, n_cap=32)
    np.testing.assert_allclose(np.asarray(cand_m), np.asarray(cand_f),
                               atol=1e-9)
    assert np.isclose(float(cost_m), float(cost_f), rtol=1e-9)


def test_host_lm_disconnected_free_node():
    """A free node with no incident constraints must not break the host
    sparse path (structurally singular H): it gets an identity row and a
    zero update, like the device paths."""
    spa = SPA2d(solver="host")
    spa.add_node(0.0, 0.0, 0.0, 0)
    spa.add_node(1.0, 0.1, 0.0, 1)
    spa.add_node(5.0, 5.0, 1.0, 2)  # disconnected
    info = np.diag([100.0, 100.0, 100.0])
    spa.add_constraint(0, 1, 1.05, 0.0, 0.0, info.tolist())
    cost = spa.compute(50, 1.0e-4, True, 1.0e-9, 50)
    assert np.isfinite(cost)
    n = spa.nodes
    # connected free node moved toward the constraint...
    assert abs(n[1].x - 1.05) < 1e-6 and abs(n[1].y) < 1e-6
    # ...disconnected node untouched
    assert (n[2].x, n[2].y, n[2].yaw) == (5.0, 5.0, 1.0)


def test_conv_tol_plumbed_through_compute():
    """Tighter conv_tol must not stop earlier than a loose one (SPA2d.compute
    previously had no way to tighten the LM stop)."""
    rng = np.random.default_rng(3)

    def build(spa):
        poses = [np.zeros(3)]
        info = np.diag([50.0, 50.0, 80.0])
        for i in range(30):
            mean = np.array([1.0, 0.0, 0.2]) + rng.normal(0, 0.05, 3)
            poses.append(se2_compose(poses[-1], mean))
        for i, p in enumerate(poses):
            spa.add_node(p[0], p[1], p[2], i)
        for i in range(30):
            spa.add_constraint(
                i, i + 1, *(relative(poses[i], poses[i + 1]) +
                            rng.normal(0, 0.03, 3)), info.tolist())
        spa.add_constraint(30, 0, *relative(poses[30], poses[0]),
                           (np.diag([500.0, 500.0, 500.0])).tolist())

    loose = SPA2d(solver="host")
    tight = SPA2d(solver="host")
    rng = np.random.default_rng(3)
    build(loose)
    rng = np.random.default_rng(3)
    build(tight)
    c_loose = loose.compute(100, 1.0e-4, True, 1.0e-9, 50, conv_tol=1e-1)
    c_tight = tight.compute(100, 1.0e-4, True, 1.0e-9, 50, conv_tol=1e-10)
    assert c_tight <= c_loose + 1e-12

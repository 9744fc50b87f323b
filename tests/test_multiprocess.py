"""Real multi-process distributed tests: 2 local processes x 4 virtual CPU
devices, coordinated by jax.distributed over TCP (the DCN analog) — the
2-fake-host harness SURVEY §7 calls for, exercising
parallel.sharding.initialize_multihost, DistributedSPA and
ShardedLoopMatcher across a process boundary."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def mp_outputs():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORM_NAME", None)
    # the worker script's sys.path only gets tests/; make the repo root
    # importable regardless of where pytest was launched from
    repo_root = os.path.dirname(_HERE)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_HERE, "mp_worker.py"),
             str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{stderr[-4000:]}"
        line = [l for l in stdout.strip().splitlines() if l.startswith("{")][-1]
        outs.append(json.loads(line))
    return outs


def test_two_processes_see_global_mesh(mp_outputs):
    for o in mp_outputs:
        assert o["process_count"] == 2
        assert o["n_devices"] == 8
        assert o["n_local"] == 4


def test_multiprocess_dist_spa_agrees_across_processes(mp_outputs):
    a, b = mp_outputs
    assert np.isclose(a["spa_cost"], b["spa_cost"], rtol=1e-12)
    assert np.isclose(a["pose_sum"], b["pose_sum"], rtol=1e-12)


def test_multiprocess_dist_spa_matches_single_process(mp_outputs):
    """The 2-process solve must equal the same solve on one process with 8
    virtual devices (this test process)."""
    from yag_slam_tpu.parallel.dist_spa import DistributedSPA
    from yag_slam_tpu.parallel.sharding import default_mesh
    from yag_slam_tpu.core.transform import se2_compose, se2_relative

    rng = np.random.default_rng(3)
    true = [np.array([0.0, 0.0, 0.0])]
    for side in range(4):
        for _ in range(4):
            true.append(se2_compose(true[-1], np.array([1.0, 0.0, 0.0])))
        true.append(se2_compose(true[-1], np.array([0.0, 0.0, np.pi / 2])))
    n = len(true)
    info = np.diag([50.0, 50.0, 100.0])
    spa = DistributedSPA(default_mesh(), solver="cg")
    guess = true[0]
    spa.add_node(guess[0], guess[1], guess[2], 0)
    means = []
    for i in range(n - 1):
        mean = se2_relative(true[i + 1], true[i]) + rng.normal(0, 0.02, 3)
        means.append(mean)
        guess = se2_compose(guess, mean)
        spa.add_node(guess[0], guess[1], guess[2], i + 1)
    for i, mean in enumerate(means):
        spa.add_constraint(i, i + 1, *mean, info.tolist())
    spa.add_constraint(n - 1, 0, *se2_relative(true[0], true[-1]),
                       np.diag([500.0, 500.0, 1000.0]).tolist())
    # both worker (explicit enable_x64) and this process (conftest) run f64
    cost = spa.compute(50, 1.0e-4, True, 1.0e-10, 100, conv_tol=1e-10)
    poses = np.array([[v.x, v.y, v.yaw] for v in spa.nodes])
    for o in mp_outputs:
        assert np.isclose(o["spa_cost"], cost, rtol=1e-6)
        assert np.isclose(o["pose_sum"], float(np.abs(poses).sum()),
                          rtol=1e-6)


def test_multiprocess_loop_matcher_agrees_across_processes(mp_outputs):
    a, b = mp_outputs
    assert len(a["responses"]) == 4
    np.testing.assert_allclose(a["responses"], b["responses"], rtol=1e-12)
    np.testing.assert_allclose(a["best_x"], b["best_x"], rtol=1e-12)
    assert min(a["responses"]) > 0.0

"""Worker for the real multi-process distributed test.

Launched as: python mp_worker.py <process_id> <num_processes> <port>
with JAX_PLATFORMS=cpu and XLA_FLAGS=--xla_force_host_platform_device_count=4
in the environment, so 2 processes x 4 virtual devices = 8 global devices —
the 2-fake-host harness SURVEY §7 calls for (the DCN analog is the TCP
coordination between the two processes).

Runs the two distributed paths over the *global* mesh and prints one JSON
line with results every process must agree on.
"""
import json
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]

import jax  # noqa: E402  (env configured by the launcher)

# the launcher sets JAX_PLATFORMS=cpu; the config update also covers a
# jax that was imported before the environment was read
jax.config.update("jax_platforms", "cpu")

from yag_slam_tpu.parallel.sharding import default_mesh, initialize_multihost

initialize_multihost(f"127.0.0.1:{port}", nproc, pid)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yag_slam_tpu.parallel.dist_spa import DistributedSPA  # noqa: E402
from yag_slam_tpu.parallel.loop_search import ShardedLoopMatcher  # noqa: E402
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher  # noqa: E402
from yag_slam_tpu.io.simulator import SimWorld, simulate_scan  # noqa: E402
from yag_slam_tpu.core.transform import se2_compose, se2_relative  # noqa: E402

mesh = default_mesh()

# --- distributed SPA over both processes ---------------------------------
rng = np.random.default_rng(3)
true = [np.array([0.0, 0.0, 0.0])]
for side in range(4):
    for _ in range(4):
        true.append(se2_compose(true[-1], np.array([1.0, 0.0, 0.0])))
    true.append(se2_compose(true[-1], np.array([0.0, 0.0, np.pi / 2])))
n = len(true)
info = np.diag([50.0, 50.0, 100.0])
spa = DistributedSPA(mesh, solver="cg")
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
cost = spa.compute(50, 1.0e-4, True, 1.0e-10, 100, conv_tol=1e-10)
poses = np.array([[v.x, v.y, v.yaw] for v in spa.nodes])

# --- sharded loop matching over both processes ----------------------------
world = SimWorld.office()
rng = np.random.default_rng(0)
jobs = []
for j in range(4):
    base_pose = np.array([0.3 * j - 1.0, 0.2 * j - 1.0, 0.1 * j])
    chain = [
        simulate_scan(world, base_pose + [0.3 * i, 0.05, 0.0], n_beams=120,
                      range_threshold=5.0, noise=0.004, rng=rng)
        for i in range(3)
    ]
    query = simulate_scan(world, base_pose + [0.1, 0.05, 0.02], n_beams=120,
                          range_threshold=5.0, noise=0.004, rng=rng)
    jobs.append((query, chain))

cfg = {"range_threshold": 5.0, "resolution": 0.05, "search_size": 2.0,
       "smear_deviation": 0.05}
sharded = ShardedLoopMatcher(
    CorrelativeScanMatcher(cfg, loop=True, dtype=jnp.float64), mesh
)
results = sharded.match_many(jobs, penalty=False, do_fine=False)

print(json.dumps({
    "pid": pid,
    "n_devices": len(jax.devices()),
    "n_local": len(jax.local_devices()),
    "process_count": jax.process_count(),
    "spa_cost": float(cost),
    "pose_sum": float(np.abs(poses).sum()),
    "responses": [round(float(r.response), 10) for r in results],
    "best_x": [round(float(r.best_pose.x), 9) for r in results],
}), flush=True)

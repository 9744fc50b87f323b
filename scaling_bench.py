"""Scaling-efficiency harness: sharded loop-closure match throughput and
distributed-SPA solve time at 1, 2, 4, ... devices.

    python scaling_bench.py          # every local device (e.g. 4 GPUs)
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scaling_bench.py      # rehearsal on virtual CPU devices

Prints one JSON line per mesh size and a final efficiency summary.
Virtual CPU devices share the same physical cores, so CPU-mesh efficiency
numbers validate the harness, not the hardware.
"""
import json
import time

import numpy as np


def build_jobs(n_jobs, n_beams=180):
    from yag_slam_tpu.io.simulator import SimWorld, simulate_scan

    world = SimWorld.office()
    rng = np.random.default_rng(0)
    jobs = []
    for j in range(n_jobs):
        base_pose = np.array([0.25 * (j % 12) - 1.5, 0.2 * (j % 10) - 1.0,
                              0.05 * j])
        chain = [
            simulate_scan(world, base_pose + [0.3 * i, 0.05, 0.0],
                          n_beams=n_beams, range_threshold=5.0, noise=0.004,
                          rng=rng)
            for i in range(3)
        ]
        query = simulate_scan(world, base_pose + [0.1, 0.05, 0.02],
                              n_beams=n_beams, range_threshold=5.0,
                              noise=0.004, rng=rng)
        jobs.append((query, chain))
    return jobs


def build_spa_graph(spa, n_nodes, seed=0):
    """The shared noisy square-loop benchmark graph (io.benchmark) loaded
    into `spa`; returns the node count."""
    from yag_slam_tpu.io.benchmark import noisy_loop_pose_graph, populate_spa

    guesses, edges, info = noisy_loop_pose_graph(n_nodes, seed=seed)
    populate_spa(spa, guesses, edges, info)
    return len(guesses)


def bench_dist_spa(sizes, edges_per_device=512, repeats=3):
    """Weak-scaling row for the distributed SPA: edges/device held constant, LM/CG iteration counts pinned, so ideal
    weak scaling is FLAT solve time as devices grow."""
    import jax

    from yag_slam_tpu.parallel.dist_spa import DistributedSPA
    from yag_slam_tpu.parallel.sharding import default_mesh

    results = {}
    for n_dev in sizes:
        n_nodes = edges_per_device * n_dev
        spa = DistributedSPA(default_mesh(n_dev))
        build_spa_graph(spa, n_nodes)
        spa.compute(10, 1.0e-4, True, 1.0e-9, 25)  # compile + warm
        best = float("inf")
        for _ in range(repeats):
            spa2 = DistributedSPA(default_mesh(n_dev))
            build_spa_graph(spa2, n_nodes)
            t0 = time.time()
            c = spa2.compute(10, 1.0e-4, True, 1.0e-9, 25)
            best = min(best, time.time() - t0)
        results[n_dev] = best
        print(json.dumps({
            "dist_spa_devices": n_dev, "nodes": n_nodes,
            "solve_ms": round(best * 1e3, 1), "chi2": round(float(c), 4),
        }))
    if len(results) > 1:
        base = results[sizes[0]]
        eff = {n: base / results[n] for n in sizes[1:]}  # flat = 1.0
        print(json.dumps({
            "metric": "dist_spa_weak_scaling_efficiency",
            "backend": jax.default_backend(),
            "efficiency": {str(n): round(e, 3) for n, e in eff.items()},
        }))
    return results


def main(n_jobs=32, repeats=3):
    import jax

    from yag_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher
    from yag_slam_tpu.parallel.loop_search import ShardedLoopMatcher
    from yag_slam_tpu.parallel.sharding import default_mesh

    cfg = {"range_threshold": 5.0, "resolution": 0.05, "search_size": 2.0,
           "smear_deviation": 0.05}
    n_avail = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    jobs = build_jobs(n_jobs)
    results = {}
    for n_dev in sizes:
        matcher = ShardedLoopMatcher(
            CorrelativeScanMatcher(cfg, loop=True),
            default_mesh(n_dev),
        )
        matcher.match_many(jobs, penalty=False, do_fine=False)  # compile
        best = float("inf")
        for _ in range(repeats):
            t0 = time.time()
            res = matcher.match_many(jobs, penalty=False, do_fine=False)
            best = min(best, time.time() - t0)
        rate = n_jobs / best
        results[n_dev] = rate
        print(json.dumps({"devices": n_dev, "jobs_per_s": round(rate, 2),
                          "ms": round(best * 1e3, 1),
                          "responses_ok": bool(min(r.response for r in res) > 0)}))
    if len(results) > 1:
        base = results[sizes[0]]
        eff = {n: results[n] / (base * n / sizes[0]) for n in sizes[1:]}
        print(json.dumps({
            "metric": "scaling_efficiency",
            "backend": jax.default_backend(),
            "efficiency": {str(n): round(e, 3) for n, e in eff.items()},
        }))
    bench_dist_spa(sizes, repeats=repeats)
    return results


if __name__ == "__main__":
    main()

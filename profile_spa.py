"""SPA solve times by solver and graph size on the current device: host
sparse f64 vs device dense vs device matrix-free PCG, each device path in
f64 and mixed precision, on the noisy-loop benchmark graphs.

    python profile_spa.py

The host/device crossover it shows is what PoseGraphSolver's "auto" policy
(AUTO_HOST_NODE_LIMIT) should follow.  Prints the device and the card's
name and power limit first.
"""
import time

from yag_slam_tpu.graphopt.spa import SPA2d
from yag_slam_tpu.io.benchmark import noisy_loop_pose_graph, populate_spa
from yag_slam_tpu.utils.card import card_name_and_power_limit
from yag_slam_tpu.utils.compile_cache import enable_compile_cache


def build(n_nodes, solver, precision="mixed"):
    return populate_spa(
        SPA2d(solver=solver, precision=precision),
        *noisy_loop_pose_graph(n_nodes),
    )


def main():
    import jax

    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}; "
          f"card: {card_name_and_power_limit()}")
    sizes = [100, 500, 1000, 2000, 4000]
    # (solver, precision) columns: "mixed" = f32 factorization/CG + f64
    # matrix-free iterative refinement; "f64" = f64 steps throughout
    cols = [("host", "f64"), ("dense", "mixed"), ("dense", "f64"),
            ("cg", "mixed"), ("cg", "f64")]
    names = [f"{s}:{p}" if s != "host" else s for s, p in cols]
    print(f"{'nodes':>6} | " + " | ".join(f"{s:>11}" for s in names)
          + "  (best-of-3 ms; cost must agree)")
    rows = {}
    for n in sizes:
        times = {}
        costs = {}
        for (solver, prec), name in zip(cols, names):
            build(n, solver, prec).compute(100, 1e-4, True, 1e-9, 200)
            best = float("inf")
            for _ in range(3):
                spa = build(n, solver, prec)
                t0 = time.perf_counter()
                c = spa.compute(100, 1e-4, True, 1e-9, 200)
                best = min(best, time.perf_counter() - t0)
            times[name] = best * 1e3
            costs[name] = c
        rows[n] = times
        print(f"{n:>6} | " + " | ".join(
            f"{times[s]:>11.1f}" for s in names)
            + f"   chi2={costs['host']:.4g}")
    return rows


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Smoke run of the SLAM main path on an NVIDIA GPU.

    python chip_smoke.py                 # one card: the phases below
    python chip_smoke.py --four-cards    # four cards: the sharded path only

Default phases, in one process; any failure exits non-zero:

1. device check — refuses any platform but "gpu"; prints the card's name
   and power limit, the JAX version and XLA_FLAGS;
2. main path — `yag-slam-tpu-mapper` (apps.offline_mapper.main) on a
   CARMEN log generated from --seed (28 x 16 m building, 2 laps at 0.4 m,
   180 beams over 180 degrees) at the reference ROS node's settings, per
   scan and --stream: three quarters of the log, checkpoint, then the rest
   resumed from the checkpoint.  Each part must close a loop (the first)
   and beat odometry on ATE against the log's ground truth;
3. matcher parity — float32 sequential matches on the card against the
   float64 oracle (tests/oracle.py);
4. SPA — device solvers ("dense" f64 and mixed, "cg") against the host
   sparse float64 solve on 505- and 2005-node noisy loop graphs ("cg"
   on the 505-node one: see CG_MAX_NODES).

--four-cards runs GraphSlam with a ShardedLoopMatcher and a DistributedSPA
over a 4-device mesh and the same stack on one device, on the same log, and
requires equal vertex and loop-closure counts and final poses within
1e-3 m / 1e-3 rad.

The last line of stdout is {"ok": true, "device": {...}}; nothing is
printed there unless every phase passed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Matcher parity (float32 on the card vs the float64 oracle).  Responses
# are sums of integer grid values times f32 penalties, so they agree to
# RESPONSE_ATOL while every point lands in the oracle's cell.  A float32
# world coordinate resolves ~4e-4 of a cell over a 40 m grid, so a point
# within that of a rounding boundary can take the neighbouring cell; the
# score then moves by a few grid units over the point count.  So: the
# oracle's response (to RESPONSE_ATOL) and lattice cell (within half a
# fine step) in MIN_EXACT of every 8 jobs, and in every job a response
# within RESPONSE_FLIP_ATOL and a best pose within one fine step.
RESPONSE_ATOL = 1e-4
RESPONSE_FLIP_ATOL = 1e-2
MIN_EXACT = 7
# SPA device solves vs the host sparse f64 solve, both run to convergence.
SPA_COST_RTOL = 1e-6
SPA_POSE_ATOL = 1e-4
# Four cards vs one: psum reduction order differs.
SHARDED_XY_ATOL = 1e-3
SHARDED_THETA_ATOL = 1e-3


def log(msg):
    print(msg, flush=True)


def import_repo():
    """Import the package from this checkout only."""
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import yag_slam_tpu

    pkg = os.path.dirname(os.path.abspath(yag_slam_tpu.__file__))
    if os.path.dirname(pkg) != HERE:
        raise SystemExit(f"yag_slam_tpu imported from {pkg}, not {HERE}")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def device_check(n_devices):
    """The accelerator, or SystemExit.  Returns the device description of
    the result line and nvidia-smi's name and power limit of the card."""
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform} devices "
                         f"({dev.device_kind})")
    if len(devices) < n_devices:
        raise SystemExit(f"need {n_devices} GPUs, JAX found {len(devices)}")
    from yag_slam_tpu.utils.card import card_name_and_power_limit

    card = card_name_and_power_limit()
    if card is None:
        raise SystemExit("nvidia-smi gave no card name and power limit")
    log(card)   # as nvidia-smi prints it: "<name>, <power limit>"
    log(f"jax {jax.__version__}; devices {len(devices)} x {dev.device_kind}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}, card


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, from its
    monitoring events (reported apart from steady-state time)."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0)


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def make_log(workdir, seed):
    from yag_slam_tpu.io.benchmark import generate_benchmark_log

    return generate_benchmark_log(
        os.path.join(workdir, "building.clf"), step=0.4, laps=2,
        n_beams=180, seed=seed,
    )


def main_path(workdir, log_path, gt_path, n_scans, stream, clock,
              extra_args=()):
    """Map 3/4 of the log, then resume from the checkpoint for the rest."""
    from yag_slam_tpu.apps.offline_mapper import main as mapper_main
    from yag_slam_tpu.slam.graph_slam import GraphSlam

    mode = "stream" if stream else "per-scan"
    split = (3 * n_scans) // 4
    common = ["--carmen", log_path, "--gt", gt_path, *extra_args]
    if stream:
        common.append("--stream")
    out1 = os.path.join(workdir, f"{mode}-part1")
    out2 = os.path.join(workdir, f"{mode}-part2")

    c0 = clock.seconds
    first = mapper_main(common + ["--max-scans", str(split), "--out", out1])
    c1 = clock.seconds
    blob = open(first["graph"], "rb").read()
    if GraphSlam.from_file(first["graph"]).binarize() != blob:
        raise AssertionError(f"{mode}: checkpoint does not round-trip")
    second = mapper_main(common + ["--first-scan", str(split),
                                   "--resume", first["graph"],
                                   "--out", out2])
    c2 = clock.seconds

    for name, s, compile_s in (("part 1", first, c1 - c0),
                               ("resumed", second, c2 - c1)):
        log(f"[main {mode} {name}] {s['integrated']} scans in "
            f"{s['seconds']:.2f} s = {s['scans_per_sec']:.2f} scans/s "
            f"(compile {compile_s:.2f} s inside), "
            f"{s['loop_closures']} loop closures, ATE {s['ate_rmse']:.4f} m "
            f"vs odometry {s['ate_rmse_odom']:.4f} m, "
            f"{s['vertices']} vertices, map {s.get('map_size')}")
    if first["loop_closures"] < 1:
        raise AssertionError(f"{mode}: no loop closure")
    for name, s in (("part 1", first), ("resumed", second)):
        if not s["ate_rmse"] < s["ate_rmse_odom"]:
            raise AssertionError(f"{mode} {name}: ATE {s['ate_rmse']} does "
                                 f"not beat odometry {s['ate_rmse_odom']}")
    if second["vertices"] != first["vertices"] + second["integrated"]:
        raise AssertionError(f"{mode}: resumed graph lost vertices")
    return first, second


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def matcher_parity(log_path, gt_path, n_jobs=8, seq_config=None,
                   window=10, stride=3):
    """f32 matcher on the card vs the f64 oracle on `n_jobs` sequential
    jobs: base = `window` consecutive scans at their true poses, query =
    the next scan at its odometry-propagated guess."""
    import jax.numpy as jnp
    from oracle import oracle_match_scan

    from yag_slam_tpu.apps.online import DEFAULT_SEQ_CONFIG
    from yag_slam_tpu.core.transform import Transform
    from yag_slam_tpu.io.carmen import load_carmen_log
    from yag_slam_tpu.matching.matcher import (
        CorrelativeScanMatcher, sanitize_covariance,
    )
    from yag_slam_tpu.core.scan import LocalizedRangeScan

    cfg = dict(DEFAULT_SEQ_CONFIG, **(seq_config or {}))
    res = cfg["resolution"]
    fine_theta = cfg["fine_search_angle_resolution"]
    gt = np.loadtxt(gt_path)
    raw = load_carmen_log(log_path)

    def scan(i, pose):
        c = raw[i]
        return LocalizedRangeScan(
            c.ranges, c.min_angle, c.max_angle, c.angle_increment, 0.0,
            c.max_range, cfg["range_threshold"], *pose)

    m = CorrelativeScanMatcher(cfg, dtype=jnp.float32)
    exact = 0
    worst = {"response": 0.0, "xy": 0.0, "theta": 0.0}
    for j in range(n_jobs):
        q = window + j * stride
        base = [scan(i, gt[i]) for i in range(q - window, q)]
        # odometry delta from the last base scan, applied to its true pose
        o_prev = np.array([raw[q - 1].odom_x, raw[q - 1].odom_y,
                           raw[q - 1].odom_theta])
        o_q = np.array([raw[q].odom_x, raw[q].odom_y, raw[q].odom_theta])
        guess = (Transform.from_xyt(*gt[q - 1])
                 + (Transform.from_xyt(*o_q) - Transform.from_xyt(*o_prev)))
        query = scan(q, (guess.x, guess.y, guess.euler[-1]))
        got = m.match_scan(query, base, penalty=True, do_fine=True)
        resp, pose, cov, _ = oracle_match_scan(
            query.points_local(), (guess.x, guess.y, guess.euler[-1]),
            [s.points() for s in base], cfg, penalty=True, do_fine=True)
        d_resp = abs(got.response - resp)
        dx = max(abs(got.best_pose.x - pose[0]),
                 abs(got.best_pose.y - pose[1]))
        dt = abs((got.best_pose.euler[-1] - pose[2] + np.pi) % (2 * np.pi)
                 - np.pi)
        worst = {"response": max(worst["response"], d_resp),
                 "xy": max(worst["xy"], dx), "theta": max(worst["theta"], dt)}
        exact += (d_resp <= RESPONSE_ATOL and dx < 0.5 * res
                  and dt < 0.5 * fine_theta)
        ref_cov = sanitize_covariance(np.asarray(cov), m.config)
        for name, c in (("card", got.covariance), ("oracle", ref_cov)):
            if not (np.isfinite(c).all()
                    and np.linalg.eigvalsh(c).min() > 0):
                raise AssertionError(f"job {j}: {name} covariance not "
                                     f"positive definite: {c}")
        log(f"[parity job {j}] response {got.response:.6f} vs "
            f"{resp:.6f}; pose diff xy {dx:.2e} m, theta {dt:.2e} rad")
        if d_resp > RESPONSE_FLIP_ATOL:
            raise AssertionError(f"job {j}: response off by {d_resp}")
        if dx > res + 1e-9 or dt > fine_theta + 1e-9:
            raise AssertionError(f"job {j}: best pose more than one fine "
                                 f"step from the oracle's")
    log(f"[parity] {n_jobs} jobs, {exact} with the oracle's response and "
        f"cell; worst |d response| {worst['response']:.3e}, |d xy| "
        f"{worst['xy']:.3e} m, |d theta| {worst['theta']:.3e} rad")
    if exact < n_jobs * MIN_EXACT // 8:
        raise AssertionError(f"only {exact}/{n_jobs} jobs matched the "
                             f"oracle's response and lattice cell")
    return worst, exact


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

SPA_SOLVERS = (("host", "f64"), ("dense", "f64"), ("dense", "mixed"),
               ("cg", "mixed"))
# Block-Jacobi PCG steps do not take LM to the host optimum on the
# 2005-node loop within 200 LM x 2000 CG iterations (its cost stays ~20%
# above the host's, in f64 as in mixed precision, on the CPU as on the
# card), so "cg" is held to the host solve on the smaller graph only.
CG_MAX_NODES = 1000


def spa_solves(sizes=(500, 2000), card="", cg_iters=2000):
    """Each solver on the noisy-loop graphs: once at the reference's
    settings (timed: compute(100, 1e-4, True, 1e-9, 50)), once run to
    convergence (compared with the host solve)."""
    from yag_slam_tpu.graphopt.spa import SPA2d
    from yag_slam_tpu.io.benchmark import noisy_loop_pose_graph, populate_spa

    worst = {}
    for n in sizes:
        graph = noisy_loop_pose_graph(n)
        ref = None
        for solver, precision in SPA_SOLVERS:
            name = solver if solver == "host" else f"{solver}:{precision}"
            if solver == "cg" and len(graph[0]) > CG_MAX_NODES:
                continue

            def build():
                return populate_spa(SPA2d(solver=solver,
                                          precision=precision), *graph)

            build().compute(100, 1e-4, True, 1e-9, 50)      # compile
            spa = build()
            t0 = time.perf_counter()
            spa.compute(100, 1e-4, True, 1e-9, 50)
            ms = 1e3 * (time.perf_counter() - t0)
            spa = build()
            cost = spa.compute(200, 1e-4, True, 1e-14, cg_iters,
                               conv_tol=1e-13)
            poses = np.array([[v.x, v.y, v.yaw] for v in spa.nodes])
            line = (f"[spa {len(poses)} nodes {name}] {ms:.1f} ms at the "
                    f"reference settings on {card}; converged cost "
                    f"{cost:.10g}")
            if ref is None:
                ref = (cost, poses)
                log(line)
                continue
            d_cost = abs(cost - ref[0]) / abs(ref[0])
            d_pose = np.abs(poses - ref[1])
            d_pose[:, 2] = np.abs((d_pose[:, 2] + np.pi) % (2 * np.pi)
                                  - np.pi)
            log(f"{line}; vs host: cost rel {d_cost:.2e}, "
                f"pose max {d_pose.max():.2e}")
            worst[(len(poses), name)] = (d_cost, float(d_pose.max()))
            if d_cost > SPA_COST_RTOL or d_pose.max() > SPA_POSE_ATOL:
                raise AssertionError(f"SPA {name} at {len(poses)} nodes "
                                     f"disagrees with the host solve")
    return worst


# ---------------------------------------------------------------------------
# --four-cards
# ---------------------------------------------------------------------------

def sharded_vs_single(log_path, n_devices=4, seq_config=None,
                      loop_config=None, max_scans=None):
    """One GraphSlam with ShardedLoopMatcher + DistributedSPA over an
    n-device mesh against the same stack on one device."""
    import jax

    from yag_slam_tpu.apps.online import (
        DEFAULT_LOOP_CONFIG, DEFAULT_SEQ_CONFIG, OnlineMapper,
    )
    from yag_slam_tpu.io.carmen import load_carmen_log
    from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher
    from yag_slam_tpu.parallel import (
        DistributedSPA, ShardedLoopMatcher, default_mesh,
    )
    from yag_slam_tpu.slam.graph_slam import GraphSlam

    seq_cfg = dict(DEFAULT_SEQ_CONFIG, **(seq_config or {}))
    loop_cfg = dict(DEFAULT_LOOP_CONFIG, **(loop_config or {}))
    raw = load_carmen_log(log_path, max_scans=max_scans)

    def run(n):
        mesh = default_mesh(n)
        mapper = OnlineMapper(seq_config=seq_cfg, loop_config=loop_cfg,
                              range_threshold=seq_cfg["range_threshold"])
        loop = CorrelativeScanMatcher(loop_cfg, loop=True)
        s = mapper.slam
        mapper.slam = GraphSlam(
            s.seq_matcher, ShardedLoopMatcher(loop, mesh),
            scan_buffer_len=s.scan_buffer_len,
            loop_search_dist=s.loop_search_dist,
            loop_search_min_chain_size=s.loop_search_min_chain_size,
            min_response_coarse=s.min_response_coarse,
            min_response_fine=s.min_response_fine,
            opt=DistributedSPA(mesh),
        )
        t0 = time.perf_counter()
        for c in raw:
            mapper.add_scan(c.ranges, c.min_angle, c.max_angle,
                            c.angle_increment, 0.0, c.max_range,
                            (c.odom_x, c.odom_y, c.odom_theta))
        seconds = time.perf_counter() - t0
        slam = mapper.slam
        poses = np.array([[v.obj.corrected_pose.x, v.obj.corrected_pose.y,
                           v.obj.corrected_pose.euler[-1]]
                          for v in slam.graph.vertices])
        log(f"[{n} device(s)] {len(poses)} vertices, "
            f"{slam.stats['loop_closures']} loop closures, "
            f"{slam.stats['opt_runs']} SPA runs in {seconds:.2f} s")
        return poses, slam.stats["loop_closures"]

    single, closures1 = run(1)
    sharded, closures_n = run(n_devices)
    devices = jax.devices()[:n_devices]
    peaks = [peak_bytes(d) for d in devices]
    log(f"[sharded] mesh devices {[d.id for d in devices]}, peak bytes "
        f"per device {peaks}")
    if len(single) != len(sharded) or closures1 != closures_n:
        raise AssertionError(f"sharded run differs: {len(sharded)} vs "
                             f"{len(single)} vertices, {closures_n} vs "
                             f"{closures1} closures")
    if closures1 < 1:
        raise AssertionError("no loop closure")
    d = np.abs(sharded - single)
    d[:, 2] = np.abs((d[:, 2] + np.pi) % (2 * np.pi) - np.pi)
    log(f"[sharded] max |d xy| {d[:, :2].max():.3e} m, max |d theta| "
        f"{d[:, 2].max():.3e} rad")
    if d[:, :2].max() > SHARDED_XY_ATOL or d[:, 2].max() > SHARDED_THETA_ATOL:
        raise AssertionError("sharded poses differ from the single-device "
                             "run")
    if devices[0].platform == "gpu" and min(peaks) <= 0:
        raise AssertionError(f"not every device of the mesh ran: {peaks}")
    return d


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device sharded path and its "
                         "single-device comparison")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated log")
    args = ap.parse_args(argv)

    import_repo()
    n_devices = 4 if args.four_cards else 1
    device, card = device_check(n_devices)

    import jax

    from yag_slam_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    clock = CompileClock()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        log_path, gt_path, n_scans = make_log(workdir, args.seed)
        log(f"log: {n_scans} scans, seed {args.seed}")
        if args.four_cards:
            sharded_vs_single(log_path, n_devices)
        else:
            for stream in (False, True):
                main_path(workdir, log_path, gt_path, n_scans, stream,
                          clock)
            log(f"[main] compile total {clock.seconds:.2f} s; peak device "
                f"memory {peak_bytes(jax.devices()[0]) / 2**20:.1f} MiB "
                f"on {card}")
            matcher_parity(log_path, gt_path)
            spa_solves(card=card)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

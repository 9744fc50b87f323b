#!/usr/bin/env python
"""Benchmark: correlative scan matches/sec on the current jax backend.

Prints ONE JSON line:
  {"metric": "scan_matches_per_sec", "value": N, "unit": "matches/s",
   "vs_baseline": N, ...}

Workload: the reference's FULL default sequential-matching configuration
(search 0.5 m @ 0.01 m, range_threshold 20 m => 4051^2 correlation-grid
coordinate space, /root/reference/yag_slam/helpers.py:339-351; coarse
25x25x10 + fine 4x4x10 lattices, ~360-beam scans, 10-scan base buffer)
over a *distinct* scan stream — every call matches a different query
against a different sliding window, as GraphSlam does online, so no
caching can flatter the numbers.

Primary value = batched throughput (`match_many` dispatches — the
loop-closure / offline path); `single_stream` reports the online path
through the device-chained sequential pipeline (matching/pipeline.py) in
which match N's corrected pose feeds match N+1's search center ON DEVICE
and results are fetched in lagged blocks; `single_stream_lockstep` is the
plain loop that blocks on every result.

Every device phase must succeed: an exception ends the run with a
traceback and no result line.  The output names the device it ran on
(platform, device_kind, device count, the card's name and power limit).

Baseline (`vs_baseline`, host CPU): the reference algorithm as optimized
multithreaded C++ on the host's CPU (native/refbaseline.cpp — same grid
build, scoring and reductions as /root/reference/yag_slam/helpers.py:
156-295, theta-parallel exactly like its numba prange, golden-tested to
1e-12 against the float64 oracle in tests/test_native.py).  The
reference's own numba/C++ stack is not pip-installable here; this is the
honest stand-in, measured over the same distinct-scan stream at the SAME
config as the device path.
"""
import json
import os
import sys
import time

import numpy as np


def _log(msg):
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr,
          flush=True)


_T0 = time.time()

CFG = {
    # reference default_config (/root/reference/yag_slam/helpers.py:339-351):
    # range_threshold 20 m, resolution 0.01 m, search 0.5 m => G = 4051
    "range_threshold": 20.0,
    "resolution": 0.01,
    "search_size": 0.5,
    "smear_deviation": 0.05,
}

N_BASE = 10
BATCH = 16


def build_stream(n_scans=150, n_beams=360, seed=0):
    from yag_slam_tpu.io.simulator import SimWorld, simulate_scan

    world = SimWorld.office()
    rng = np.random.default_rng(seed)
    return [
        simulate_scan(
            world,
            np.array([0.05 * i - 2.0, 0.04 * i - 1.5, 0.02 * i]),
            n_beams=n_beams,
            range_threshold=CFG["range_threshold"],
            noise=0.004,
            rng=rng,
        )
        for i in range(n_scans)
    ]


def bench_device(scans):
    from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher

    m = CorrelativeScanMatcher(CFG)

    # warm up compiles for both paths
    _log("warm: single match")
    res = m.match_scan(scans[N_BASE], scans[:N_BASE], True, True)
    _log("warm: batched match x16")
    m.match_many(
        [(scans[N_BASE + 1], scans[1 : N_BASE + 1])] * BATCH, True, True
    )
    _log("warm: batched match x64")
    m.match_many(
        [(scans[N_BASE + 1], scans[1 : N_BASE + 1])] * 64, True, True
    )

    # single-stream online path: the DEVICE-CHAINED sequential pipeline
    # (matching/pipeline.py) — scan k's corrected pose feeds scan k+1's
    # search center on device, so the host only dispatches; results are
    # fetched in blocks of sync_every.  This is the genuinely sequential
    # workload (every match depends on the previous one's pose).
    # `single_stream_lockstep` below reports the plain loop that blocks on
    # every match.
    from yag_slam_tpu.matching.pipeline import OnlineMatchPipeline

    stream = scans[: N_BASE + 60]
    # Both chained modes are measured: streaming (one dispatch per push)
    # and block (sync_every steps per dispatch via lax.scan).  Warm on a
    # SEPARATE stream covering the same trajectory
    # extent so the sticky subgrid bucket (and its compiled programs)
    # reach steady state before timing — a bucket-growth recompile inside
    # the timed loop would skew the headline rate.  Scan
    # uploads for the timed stream stay inside the timed region
    # (distinct scans).
    single_rates = {}
    warm = build_stream(len(stream), seed=1)
    # a distinct timed stream per mode so neither inherits the other's
    # device-library uploads; mode -> (sync_every, block, lag_blocks).
    # The lowlat modes are small blocks with lagged readback: a group's
    # transfer overlaps the next block's compute, so per-scan latency is
    # bounded by sync_every*(lag+1) pushes instead of the block-8 window,
    # while still one dispatch and one readback per block.
    modes = {
        "stream": (8, False, 0),
        "block": (8, True, 0),
        "lowlat_s2_l1": (2, True, 1),
        "lowlat_s4_l1": (4, True, 1),
    }
    timed_streams = {
        mode: (stream if i == 0 else build_stream(len(stream), seed=2 + i))
        for i, mode in enumerate(modes)
    }
    for mode, (sync_every, block, lag) in modes.items():
        pipe = OnlineMatchPipeline(m, window=N_BASE, sync_every=sync_every,
                                   block_dispatch=block, lag_blocks=lag)
        _log(f"warm: pipeline {mode}")
        pipe.seed(warm[:N_BASE])
        for s in warm[N_BASE:]:
            pipe.push(s)
        pipe.flush()
        _log(f"timed: pipeline {mode}")
        tstream = timed_streams[mode]
        pipe.seed(tstream[:N_BASE])
        t0 = time.time()
        for s in tstream[N_BASE:]:
            pipe.push(s)
        n_done = len(pipe.flush())
        single_rates[mode] = n_done / (time.time() - t0)
    single_rate = max(single_rates[m] for m in ("stream", "block"))

    # lockstep online path, distinct inputs, pipelined one-deep: the
    # dispatch of match i overlaps the readback of match i-1 (jax
    # dispatch is async; only the result fetch blocks).
    jobs = [
        (scans[i], scans[i - N_BASE : i])
        for i in range(N_BASE + 2, min(N_BASE + 42, len(scans)))
    ]
    _log("timed: lockstep loop")
    t0 = time.time()
    pending = None
    for q, bs in jobs:
        h = m.match_scan_async(q, bs, True, True)
        if pending is not None:
            pending.result()
        pending = h
    pending.result()
    lockstep_rate = len(jobs) / (time.time() - t0)

    # batched throughput, distinct inputs; batches pipelined one-deep so
    # batch N's device time + readback overlaps batch N+1's host assembly
    # + dispatch (independent jobs — the loop-closure / offline fan-out
    # has no cross-batch dependency)
    jobs = [
        (scans[i], scans[i - N_BASE : i])
        for i in range(N_BASE, len(scans) - 1)
    ]
    # mega-dispatch: the whole job list as ONE program (lax.scan over
    # fixed-size chunks through the batch core) — 1 dispatch + 1 readback
    # total.  Same distinct jobs.
    import jax
    import jax.numpy as jnp

    CH = BATCH
    n_ch = len(jobs) // CH
    mega_jobs = jobs[: n_ch * CH]
    P = m._ensure_point_cap([q for q, _ in mega_jobs] +
                            [s for _, bs in mega_jobs for s in bs])
    B = m._base_bucket(N_BASE)
    idx, mask, pose, q_idx, center, sub, S = m._assemble_jobs(
        mega_jobs, P, B
    )
    core = m.batched_core(P, B, penalty=True, do_fine=True, S=S)

    def mega(lib, idx, mask, pose, q_idx, center, vp, sub):
        def body(carry, xs):
            return carry, core(lib, *xs)[0]

        _, packs = jax.lax.scan(body, 0, (idx, mask, pose, q_idx, center,
                                          vp, sub))
        return packs                                 # (n_ch, CH, 2, 8)

    def chunked(a):
        return np.ascontiguousarray(a).reshape((n_ch, CH) + a.shape[1:])

    margs = (chunked(idx), chunked(mask), chunked(pose), chunked(q_idx),
             chunked(center), chunked(center[:, :2]), chunked(sub))
    mega_prog = jax.jit(mega)
    _log("warm: batched mega")
    np.asarray(mega_prog(m.library.fields, *margs))  # compile + warm
    _log("timed: batched mega")
    t0 = time.time()
    packs = np.asarray(mega_prog(m.library.fields, *margs))
    mega_rate = (n_ch * CH) / (time.time() - t0)
    assert np.isfinite(packs).all()

    rates = {"mega": mega_rate}
    for bsz in (BATCH, 64):
        n_batches = max(1, len(jobs) // bsz)
        _log(f"timed: batched x{bsz}")
        t0 = time.time()
        done = 0
        pending = None
        for bi in range(n_batches):
            chunk = jobs[bi * bsz : (bi + 1) * bsz]
            h = m.match_many_async(chunk, True, True)
            if pending is not None:
                pending.result()
            pending = h
            done += len(chunk)
        pending.result()
        rates[bsz] = done / (time.time() - t0)
    # report the best batch size plus each
    batched_rate = max(rates.values())
    _log("device phases done")
    return single_rate, single_rates, lockstep_rate, batched_rate, rates, res


def bench_reference_native(scans, seconds=20.0, range_threshold=None):
    """The honest baseline: reference-equivalent C++ over the same
    distinct-scan stream (one match = one sliding-window job), all host
    cores.  Returns matches/s."""
    from yag_slam_tpu import native

    if not native.refbaseline_available():
        return float("nan")
    cfg = dict(
        CFG,
        coarse_search_angle_offset=0.349,
        coarse_angle_resolution=0.0349,
    )
    if range_threshold is not None:
        cfg["range_threshold"] = range_threshold
    jobs = [
        (scans[i], scans[i - N_BASE : i])
        for i in range(N_BASE, len(scans) - 1)
    ]
    # warm-up call (page-cache, thread pool)
    native.refbaseline_match_scan(jobs[0][0], jobs[0][1], cfg)
    t0 = time.time()
    done = 0
    while time.time() - t0 < seconds:
        q, bs = jobs[done % len(jobs)]
        native.refbaseline_match_scan(q, bs, cfg)
        done += 1
    return done / (time.time() - t0)


def bench_spa(n_nodes=500, repeats=3, solver=None):
    """SPA solve wall time on a noisy loop graph of n_nodes (the
    reference's per-closure budget is <=100 LM iters on CPU,
    /root/reference/yag_slam/graph_slam.py:265).

    With solver=None the SPA2d facade routes "auto" -> the host sparse
    f64 path at these sizes — that number is HOST CPU time and is labeled
    as such in the output.  solver="cg" / "dense" time the device paths
    on the current backend."""
    from yag_slam_tpu.graphopt.spa import SPA2d
    from yag_slam_tpu.io.benchmark import noisy_loop_pose_graph, populate_spa

    graph = noisy_loop_pose_graph(n_nodes)

    def build2():
        return populate_spa(
            SPA2d() if solver is None else SPA2d(solver=solver), *graph
        )

    spa = build2()
    spa.compute(100, 1.0e-4, True, 1.0e-9, 50)  # warm compile
    times = []
    for _ in range(repeats):
        spa2 = build2()
        t0 = time.time()
        spa2.compute(100, 1.0e-4, True, 1.0e-9, 50)
        times.append(time.time() - t0)
    return min(times), len(spa._solver.poses)


def main():
    import jax

    from yag_slam_tpu.utils.card import card_name_and_power_limit
    from yag_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    scans = build_stream()
    (single_rate, srates, lockstep_rate, batched_rate, brates,
     res) = bench_device(scans)
    _log("spa host")
    spa_time, spa_nodes = bench_spa()
    _log("spa device cg")
    # device matrix-free PCG (mixed precision: f32 inner CG + f64
    # refinement) at the 505-node graph
    spa_dev_time, spa_dev_nodes = bench_spa(n_nodes=500, repeats=1,
                                            solver="cg")
    _log("spa device dense mixed")
    spa_dense_time, _ = bench_spa(n_nodes=500, repeats=1, solver="dense")
    # host-CPU baseline: optional (needs the native extension), NaN if
    # it is not built
    _log("cpu baseline 20m")
    baseline = bench_reference_native(scans)
    baseline_12m = bench_reference_native(scans, seconds=10.0,
                                          range_threshold=12.0)
    value = max(single_rate, batched_rate)
    out = {
        "metric": "scan_matches_per_sec",
        "value": round(value, 2),
        "unit": "matches/s",
        "vs_baseline": (
            round(value / baseline, 2) if baseline == baseline else None
        ),
        "single_stream": round(single_rate, 2),
        "single_stream_by_mode": {k: round(v, 2) for k, v in srates.items()},
        # lowlat: small-block + lagged-readback online mode; latency is
        # bounded by sync_every*(lag+1) pushes (2*2=4 / 4*2=8), vs the
        # block-8 pipeline's 8-push window
        "single_stream_lowlat": round(
            max(v for k, v in srates.items() if k.startswith("lowlat")), 2
        ),
        "single_stream_lockstep": round(lockstep_rate, 2),
        "batched": round(batched_rate, 2),
        "batched_by_size": {str(k): round(v, 2) for k, v in brates.items()},
        "baseline_cpu_native": (
            round(baseline, 3) if baseline == baseline else None
        ),
        "baseline_cpu_native_12m": (
            round(baseline_12m, 3) if baseline_12m == baseline_12m else None
        ),
        "single_vs_baseline": (
            round(single_rate / baseline, 2) if baseline == baseline else None
        ),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_name_and_power_limit(),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "match_response": round(float(res.response), 3),
        # HOST sparse-f64 path (SPA2d "auto" routes to the host CPU)
        "spa_solve_ms_host": round(spa_time * 1000.0, 1),
        "spa_nodes_host": spa_nodes,
        # DEVICE matrix-free PCG, mixed precision
        "spa_solve_ms_device_cg": round(spa_dev_time * 1000.0, 1),
        "spa_nodes_device_cg": spa_dev_nodes,
        # DEVICE dense mixed-precision LM (f32 Cholesky + f64 refinement)
        "spa_solve_ms_device_dense_mixed": round(spa_dense_time * 1000.0, 1),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()

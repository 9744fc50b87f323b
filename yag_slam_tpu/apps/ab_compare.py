"""End-to-end reference A/B harness.

Runs the SAME CARMEN log through two complete GraphSlam pipelines that
differ ONLY in the scan matcher underneath:

  A ("ref") — RefBaselineScanMatcher: the reference algorithm as native
      C++ (native/refbaseline.cpp, golden-tested to 1e-12 against the f64
      oracle), i.e. the full reference pipeline
      (/root/reference/yag_slam/graph_slam.py:306-339) producing a
      reference *trajectory*;
  B ("jax") — CorrelativeScanMatcher: this framework's batched device
      matcher.

Both runs share one gating pass, one orchestration implementation
(GraphSlam via OnlineMapper) and identical configs/thresholds, so the
comparison isolates the matcher.  Converts the per-match 1e-12 golden
parity into whole-trajectory parity evidence: ATE + closure counts side
by side.

Usage:
  python -m yag_slam_tpu.apps.ab_compare --carmen log.clf --gt log.clf.gt
  python -m yag_slam_tpu.apps.ab_compare --synthetic   # generated tour
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _build_mapper(seq_cfg, loop_cfg, args, use_ref):
    from yag_slam_tpu.apps.online import OnlineMapper

    if use_ref:
        from yag_slam_tpu.matching.refmatcher import RefBaselineScanMatcher

        seq = RefBaselineScanMatcher(seq_cfg)
        loop = RefBaselineScanMatcher(loop_cfg, loop=True)
    else:
        from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher

        kw = {}
        if args.dtype is not None:
            dt = args.dtype
            kw = {"dtype": np.dtype(dt) if isinstance(dt, str) else dt}
        seq = CorrelativeScanMatcher(seq_cfg, **kw)
        loop = CorrelativeScanMatcher(loop_cfg, loop=True, **kw)
    return OnlineMapper(
        seq_matcher=seq,
        loop_matcher=loop,
        min_distance=args.min_distance,
        min_rotation=args.min_rotation,
        range_threshold=args.range_threshold,
        loop_search_distance=args.loop_search_distance,
        loop_search_min_chain_size=args.loop_min_chain,
        min_response_coarse=args.min_response_coarse,
        min_response_fine=args.min_response_fine,
    )


def run_one(scans, seq_cfg, loop_cfg, args, use_ref):
    """One full pipeline over the CARMEN scan list; returns a summary with
    the integrated-scan indices and estimated trajectory."""
    from yag_slam_tpu.utils.metrics import trajectory_from_slam

    mapper = _build_mapper(seq_cfg, loop_cfg, args, use_ref)
    t0 = time.time()
    integrated_idx = []
    for i, cs in enumerate(scans):
        ok, _, _ = mapper.add_scan(
            cs.ranges, cs.min_angle, cs.max_angle, cs.angle_increment,
            0.0, cs.max_range, (cs.odom_x, cs.odom_y, cs.odom_theta),
        )
        if ok:
            integrated_idx.append(i)
    elapsed = time.time() - t0
    slam = mapper.slam
    return {
        "matcher": "refbaseline_cpp" if use_ref else "correlative_jax",
        "vertices": len(slam.graph.vertices),
        "edges": len(slam.graph.edges),
        "loop_closures": slam.stats["loop_closures"],
        "loop_chains_tried": slam.stats["loop_chains_tried"],
        "elapsed_s": round(elapsed, 2),
        "scans_per_s": round(len(integrated_idx) / max(elapsed, 1e-9), 2),
        "integrated_idx": integrated_idx,
        "trajectory": trajectory_from_slam(slam),
    }


def ab_compare(log_path, gt_path, args):
    """Run both pipelines on `log_path`; returns the comparison dict."""
    from yag_slam_tpu.io.carmen import load_carmen_log
    from yag_slam_tpu.utils.metrics import ate_rmse

    scans = load_carmen_log(log_path, max_scans=args.max_scans)
    seq_cfg = {
        "range_threshold": args.range_threshold,
        "resolution": args.resolution,
        "search_size": args.search_size,
        "smear_deviation": args.smear_deviation,
    }
    loop_cfg = {
        "range_threshold": args.range_threshold,
        "resolution": args.loop_resolution,
        "search_size": args.loop_search_size,
        "smear_deviation": args.smear_deviation,
    }

    full_gt = np.loadtxt(gt_path) if gt_path else None
    out = {}
    for key, use_ref in (("ref", True), ("jax", False)):
        s = run_one(scans, seq_cfg, loop_cfg, args, use_ref)
        if full_gt is not None:
            gt = full_gt[np.asarray(s["integrated_idx"], dtype=int)]
            s["ate_rmse"] = ate_rmse(s["trajectory"], gt[:, :2], align=False)
            odom = np.array(
                [[scans[i].odom_x, scans[i].odom_y]
                 for i in s["integrated_idx"]]
            )
            s["ate_odom"] = ate_rmse(odom, gt[:, :2], align=False)
        del s["trajectory"], s["integrated_idx"]
        out[key] = s
    if full_gt is not None and out["ref"].get("ate_rmse"):
        out["ate_ratio_jax_over_ref"] = round(
            out["jax"]["ate_rmse"] / out["ref"]["ate_rmse"], 4
        )
    return out


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--carmen", help="CARMEN log (FLASER/ROBOTLASER1)")
    ap.add_argument("--gt", help="ground-truth sidecar (xyt row per scan)")
    ap.add_argument("--synthetic", action="store_true",
                    help="generate the io.benchmark building tour first")
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--range-threshold", type=float, default=8.0)
    ap.add_argument("--resolution", type=float, default=0.02)
    ap.add_argument("--search-size", type=float, default=0.5)
    ap.add_argument("--smear-deviation", type=float, default=0.03)
    ap.add_argument("--loop-resolution", type=float, default=0.05)
    ap.add_argument("--loop-search-size", type=float, default=2.0)
    ap.add_argument("--loop-search-distance", type=float, default=2.5)
    ap.add_argument("--loop-min-chain", type=int, default=5)
    ap.add_argument("--min-response-coarse", type=float, default=0.35)
    ap.add_argument("--min-response-fine", type=float, default=0.45)
    ap.add_argument("--min-distance", type=float, default=0.4)
    ap.add_argument("--min-rotation", type=float, default=0.4)
    ap.add_argument("--dtype", default=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    log, gt = args.carmen, args.gt
    if args.synthetic or not log:
        import tempfile

        from yag_slam_tpu.io.benchmark import generate_benchmark_log

        tmp = tempfile.mkdtemp(prefix="ab_compare_")
        log, gt, _ = generate_benchmark_log(
            tmp + "/sim_intel.clf", step=0.5, laps=1, n_beams=180, seed=0,
            yaw_bias=0.0020, xy_noise=0.003, yaw_noise=0.0015,
        )
    out = ab_compare(log, gt, args)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

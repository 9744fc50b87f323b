"""Offline mapping CLI.

Build a map + pose graph from a CARMEN log (Intel/MIT-style sequences) or
a synthetic benchmark world, save the checkpoint and the rendered map, and
report throughput/ATE.  This is the batch counterpart of the reference's
ROS node (which has no offline path).

Usage:
  yag-slam-tpu-mapper --carmen intel.clf --out /tmp/intel
  yag-slam-tpu-mapper --synthetic-laps 2 --out /tmp/sim
  # keep mapping the rest of a log from a saved checkpoint
  yag-slam-tpu-mapper --carmen intel.clf --first-scan 900 \
      --resume /tmp/intel.graph --out /tmp/intel2
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run_carmen(args):
    from yag_slam_tpu.apps.online import OnlineMapper
    from yag_slam_tpu.io.carmen import load_carmen_log

    scans = load_carmen_log(args.carmen, max_scans=args.max_scans)
    first = args.first_scan
    scans = scans[first:]
    print(f"loaded {len(scans)} scans from {args.carmen} "
          f"(from scan {first})")
    seq_cfg = {"range_threshold": args.range_threshold,
               "use_karto_penalties": args.karto_penalties}
    loop_cfg = {"range_threshold": args.range_threshold,
                "use_karto_penalties": args.karto_penalties}
    if args.resolution is not None:
        seq_cfg["resolution"] = args.resolution
    if args.search_size is not None:
        seq_cfg["search_size"] = args.search_size
    if args.smear_deviation is not None:
        seq_cfg["smear_deviation"] = args.smear_deviation
    if args.loop_resolution is not None:
        loop_cfg["resolution"] = args.loop_resolution
    if args.loop_search_size is not None:
        loop_cfg["search_size"] = args.loop_search_size
    mapper = OnlineMapper(
        seq_config=seq_cfg,
        loop_config=loop_cfg,
        min_distance=args.min_distance,
        min_rotation=args.min_rotation,
        range_threshold=args.range_threshold,
        map_resolution=args.map_resolution,
        loop_search_distance=args.loop_search_distance,
        loop_search_min_chain_size=args.loop_min_chain,
        min_response_coarse=args.min_response_coarse,
        min_response_fine=args.min_response_fine,
    )
    if args.resume:
        from yag_slam_tpu.slam.graph_slam import GraphSlam

        mapper.slam = GraphSlam.from_file(args.resume)
        print(f"resumed {len(mapper.slam.graph.vertices)} vertices from "
              f"{args.resume}")
    n_before = len(mapper.slam.graph.vertices)
    closures_before = mapper.slam.stats["loop_closures"]
    t0 = time.time()
    integrated_idx = []
    if args.stream:
        # streamed bulk ingestion: device-chained matching in blocks,
        # loop closure at sync boundaries (GraphSlam.process_scan_stream
        # — semantically equal to the per-scan loop)
        prepared = []
        for i, cs in enumerate(scans):
            s = mapper._prepare_scan(
                cs.ranges, cs.min_angle, cs.max_angle, cs.angle_increment,
                0.0, cs.max_range, (cs.odom_x, cs.odom_y, cs.odom_theta),
            )
            if s is not None:
                prepared.append(s)
                integrated_idx.append(i)
        mapper.add_scans_batch_stream(prepared, sync_every=args.sync_every)
    else:
        for i, cs in enumerate(scans):
            ok, _, closed = mapper.add_scan(
                cs.ranges, cs.min_angle, cs.max_angle, cs.angle_increment,
                0.0, cs.max_range, (cs.odom_x, cs.odom_y, cs.odom_theta),
            )
            if ok:
                integrated_idx.append(i)
    elapsed = time.time() - t0
    integrated = len(integrated_idx)
    closures = mapper.slam.stats["loop_closures"] - closures_before
    print(
        f"integrated {integrated}/{len(scans)} scans in {elapsed:.1f}s "
        f"({integrated / max(elapsed, 1e-9):.2f} scans/s), "
        f"{closures} loop closures"
    )
    run = {"integrated": integrated, "seconds": elapsed,
           "scans_per_sec": integrated / max(elapsed, 1e-9),
           "loop_closures": closures}
    if args.gt:
        # sidecar ground truth, one xyt row per log scan (see
        # io/benchmark.write_carmen_log); the errors cover the scans this
        # run integrated, for the mapper and for raw odometry alike
        from yag_slam_tpu.utils.metrics import ate_rmse, trajectory_from_slam

        idx = np.asarray(integrated_idx, dtype=int)
        gt = np.loadtxt(args.gt)[first:][idx]
        est = trajectory_from_slam(mapper.slam)[n_before:]
        odom = np.array([[scans[i].odom_x, scans[i].odom_y] for i in idx])
        run["ate_rmse"] = ate_rmse(est, gt[:, :2], align=False)
        run["ate_rmse_odom"] = ate_rmse(odom, gt[:, :2], align=False)
    return mapper, run


def run_synthetic(args):
    from yag_slam_tpu.apps.online import OnlineMapper
    from yag_slam_tpu.io.simulator import (
        SimWorld, drifted_odometry, simulate_scan, square_loop_trajectory,
    )

    world = SimWorld.office()
    gt = square_loop_trajectory(side=5.0, step=0.5, laps=args.synthetic_laps,
                                start=(-2.5, -2.5))
    odom = drifted_odometry(gt, yaw_bias=0.003, seed=7)
    rng = np.random.default_rng(3)
    mapper = OnlineMapper(
        seq_config={"range_threshold": 5.0, "search_size": 0.5,
                    "resolution": 0.02, "smear_deviation": 0.05,
                    "use_karto_penalties": args.karto_penalties},
        loop_config={"range_threshold": 5.0, "search_size": 2.0,
                     "resolution": 0.05, "smear_deviation": 0.05,
                     "use_karto_penalties": args.karto_penalties},
        min_distance=0.0,  # pre-gated trajectory
        min_rotation=0.0,
        range_threshold=5.0,
        loop_search_distance=2.0,
        loop_search_min_chain_size=5,
        min_response_coarse=0.35,
        min_response_fine=0.45,
        map_resolution=args.map_resolution,
    )
    mapper.min_distance = -1.0  # integrate every pose
    t0 = time.time()
    scans = [
        simulate_scan(world, gt[i], n_beams=250, range_threshold=5.0,
                      noise=0.004, rng=rng, odom_pose_xyt=odom[i])
        for i in range(len(gt))
    ]
    if args.stream:
        mapper.slam.process_scan_stream(scans, sync_every=args.sync_every)
    else:
        for scan in scans:
            mapper.slam.process_scan(scan)
    elapsed = time.time() - t0
    print(
        f"processed {len(gt)} scans in {elapsed:.1f}s "
        f"({len(gt) / elapsed:.2f} scans/s), "
        f"{mapper.slam.stats['loop_closures']} loop closures"
    )
    from yag_slam_tpu.utils.metrics import ate_rmse, trajectory_from_slam

    run = {"integrated": len(gt), "seconds": elapsed,
           "scans_per_sec": len(gt) / elapsed,
           "loop_closures": mapper.slam.stats["loop_closures"],
           "ate_rmse": ate_rmse(trajectory_from_slam(mapper.slam),
                                gt[:, :2], align=False),
           "ate_rmse_odom": ate_rmse(odom[:, :2], gt[:, :2], align=False)}
    return mapper, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--carmen", help="CARMEN log file (FLASER/ROBOTLASER1)")
    ap.add_argument("--gt", help="ground-truth sidecar (xyt row per scan)")
    ap.add_argument("--synthetic-laps", type=int, default=0)
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--first-scan", type=int, default=0,
                    help="skip the log's scans before this index")
    ap.add_argument("--resume", default=None,
                    help="checkpoint (.graph) to load and keep mapping from")
    ap.add_argument("--out", default="/tmp/yag_slam_tpu_map")
    ap.add_argument("--range-threshold", type=float, default=20.0)
    ap.add_argument("--min-distance", type=float, default=0.5)
    ap.add_argument("--min-rotation", type=float, default=0.5)
    ap.add_argument("--map-resolution", type=float, default=0.05)
    # matcher grid overrides (None -> reference-node defaults,
    # apps/online.DEFAULT_SEQ_CONFIG / DEFAULT_LOOP_CONFIG)
    ap.add_argument("--resolution", type=float, default=None)
    ap.add_argument("--smear-deviation", type=float, default=None)
    ap.add_argument("--search-size", type=float, default=None)
    ap.add_argument("--loop-resolution", type=float, default=None)
    ap.add_argument("--loop-search-size", type=float, default=None)
    ap.add_argument("--loop-search-distance", type=float, default=4.0)
    ap.add_argument("--loop-min-chain", type=int, default=10)
    ap.add_argument("--min-response-coarse", type=float, default=0.6)
    ap.add_argument("--min-response-fine", type=float, default=0.7)
    ap.add_argument("--karto-penalties", action="store_true",
                    help="score with OpenKarto's C++ penalty semantics "
                         "(clamped minimums, search-center offsets) "
                         "instead of the reference Python spec's")
    ap.add_argument("--stream", action="store_true",
                    help="streamed ingestion: device-chained match blocks "
                         "with loop closure at sync boundaries (same "
                         "results as the per-scan loop)")
    ap.add_argument("--sync-every", type=int, default=8)
    ap.add_argument("--no-map-image", action="store_true",
                    help="skip the PNG render (benchmark runs)")
    args = ap.parse_args(argv)
    if args.resume and not args.carmen:
        ap.error("--resume needs --carmen")

    from yag_slam_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.carmen:
        mapper, run = run_carmen(args)
    elif args.synthetic_laps:
        mapper, run = run_synthetic(args)
    else:
        ap.error("need --carmen or --synthetic-laps")

    graph_path = mapper.save_graph(args.out + ".graph")
    print("saved graph:", graph_path)

    summary = {
        "vertices": len(mapper.slam.graph.vertices),
        "edges": len(mapper.slam.graph.edges),
        **run,
        "graph": graph_path,
    }
    if not args.no_map_image:
        ros_img, grid = mapper.render_map()
        png_path = args.out + ".png"
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.imsave(png_path, grid.image[::-1], cmap="gray", vmin=0,
                       vmax=255)
            print("saved map image:", png_path)
        except Exception as e:  # pragma: no cover
            print("map image not saved:", e)
        summary["map_size"] = [grid.width, grid.height]
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

"""Lifelong mapping: map image -> graph -> continue SLAM."""
import numpy as np
import jax.numpy as jnp
import pytest

from yag_slam_tpu.io.simulator import SimWorld, simulate_scan
from yag_slam_tpu.mapping.occupancy import create_occupancy_grid
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu.slam.graph_slam import GraphSlam
from yag_slam_tpu.splicing.splice import (
    create_edges,
    determine_centroids,
    map_to_graph,
    map_to_graphslam,
    segment_map,
)
from yag_slam_tpu.splicing.segmentation import spatial_segments


def make_map_image():
    """Render a real occupancy map of two connected rooms."""
    world = SimWorld.rectangle(10.0, 6.0)
    world = SimWorld(
        np.concatenate(
            [world.segments, [[[0.0, -3.0], [0.0, -0.8]], [[0.0, 0.8], [0.0, 3.0]]]]
        )
    )
    poses = [
        np.array([-2.5, 0.0, 0.0]),
        np.array([-1.0, 1.0, 1.2]),
        np.array([2.5, 0.0, 3.0]),
        np.array([1.0, -1.0, -1.5]),
        np.array([-2.0, -1.5, 0.5]),
        np.array([2.0, 1.5, -0.5]),
    ]
    scans = [
        simulate_scan(world, p, n_beams=1000, range_threshold=12.0) for p in poses
    ]
    grid = create_occupancy_grid(scans, resolution=0.05, range_threshold=12.0)
    return grid


def test_spatial_segments_basic():
    mask = np.zeros((60, 100), bool)
    mask[10:50, 10:90] = True
    seg = spatial_segments(mask, 4)
    assert seg.shape == mask.shape
    assert set(np.unique(seg[~mask])) == {0}
    ids = set(np.unique(seg[mask]))
    assert 0 not in ids and 2 <= len(ids) <= 4


def test_segment_pipeline_on_rendered_map():
    grid = make_map_image()
    im = grid.image
    segments = segment_map(im, density=30)
    cents = determine_centroids(segments)
    assert len(cents) >= 2
    edges = create_edges(segments)
    # adjacency graph should connect at least some regions
    assert len(edges) >= 1

    scans, edges2 = map_to_graph(im, grid.resolution,
                                 [grid.offset.x, grid.offset.y], density=30)
    assert len(scans) == len(cents)
    for s in scans:
        assert len(s.ranges) == 1439
        valid = s.ranges[s.ranges < 50]
        # synthetic scans should see real structure at sane distances
        assert len(valid) > 200
        assert 0.1 < np.median(valid) < 12.0


def test_map_to_graphslam_and_continue():
    grid = make_map_image()
    im = grid.image
    cfg = {"range_threshold": 5.0, "resolution": 0.02, "search_size": 0.5,
           "smear_deviation": 0.05}
    slam = GraphSlam(
        CorrelativeScanMatcher(cfg, dtype=jnp.float64), None,
        loop_search_min_chain_size=2,
    )
    slam = map_to_graphslam(slam, im, grid.resolution,
                            [grid.offset.x, grid.offset.y], density=30)
    assert len(slam.graph.vertices) >= 2
    assert len(slam.graph.edges) >= 1
    # the reference's workaround: round-trip to rebuild optimizer indices
    slam2 = GraphSlam.deserialize(slam.serialize())
    assert len(slam2.graph.vertices) == len(slam.graph.vertices)

    # splice bootstrap: localize a fresh scan against the injected map
    # (the ROS node's first-scan flow,
    #  /root/reference/ros1/slam_node_ros1:240-253)
    world = SimWorld.rectangle(10.0, 6.0)
    pose = np.array([-2.4, 0.1, 0.2])
    scan = simulate_scan(world, pose, n_beams=500, range_threshold=5.0)
    nearby = slam2.search.crude_radius_search(scan.odom_pose, 5)
    assert nearby
    res = slam2.seq_matcher.match_scan(scan, [v.obj for v in nearby],
                                       do_fine=True)
    assert res.response > 0.2
    assert abs(res.best_pose.x - pose[0]) < 0.3
    assert abs(res.best_pose.y - pose[1]) < 0.3


def test_kmeans_distance_products_at_highest_precision():
    """The k-means distance products are traced at precision HIGHEST, so a
    reduced-precision matmul (TF32) cannot move assignments."""
    import jax

    from yag_slam_tpu.splicing.segmentation import _kmeans_iters

    found = []
    pts = jnp.zeros((64, 2), jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda p, v, c: _kmeans_iters(p, v, c, n_iters=2)
    )(pts, jnp.ones(64, bool), pts[:4])

    def walk(j):
        for eqn in j.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else (v,):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jaxpr.jaxpr)
    hi = jax.lax.Precision.HIGHEST
    assert len(found) == 2 and all(p == (hi, hi) for p in found), found

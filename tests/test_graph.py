"""Pose-graph containers + RadiusHashSearch scaling semantics.

The reference's spatial hash scans EVERY bucket per query
(/root/reference/yag_slam/helpers.py:420-431) and is rebuilt from
scratch after every optimization (graph_slam.py:272).  Ours must return
the identical result sets while doing O((radius/res)^2) key lookups per
query (flat in graph size) and incremental re-keying.
"""
import time

import numpy as np

from yag_slam_tpu.core.transform import Transform
from yag_slam_tpu.graphopt.graph import (
    RadiusHashSearch, poses_dist_squared,
)


class _El:
    __slots__ = ("pose",)

    def __init__(self, x, y):
        self.pose = Transform.from_xyt(x, y, 0.0)


def _reference_scan_all(search, start_pose, radius):
    """The reference's O(all buckets) implementation, verbatim semantics
    (/root/reference/yag_slam/helpers.py:420-431) — the oracle."""
    r2 = (radius + search.res) ** 2
    out = []
    for key, elements in search.hmap.items():
        pose = search.key_to_pose(key)
        if poses_dist_squared(pose, start_pose) < r2:
            out.extend(elements)
    return out


def _build(n, extent, res, seed=0):
    rng = np.random.default_rng(seed)
    els = [
        _El(x, y)
        for x, y in rng.uniform(-extent, extent, (n, 2))
    ]
    return els, RadiusHashSearch(els, accessor=lambda e: e.pose, res=res)


def test_radius_search_matches_reference_semantics():
    els, search = _build(2000, extent=300.0, res=3.0, seed=1)
    rng = np.random.default_rng(2)
    for x, y in rng.uniform(-300, 300, (25, 2)):
        q = Transform.from_xyt(x, y, 0.0)
        got = search.crude_radius_search(q, 3.0)
        ref = _reference_scan_all(search, q, 3.0)
        assert {id(e) for e in got} == {id(e) for e in ref}
        assert len(got) == len(ref)
    # negative-coordinate keys (int() truncates toward zero — the
    # reference's pose_to_key quirk) must round-trip too
    q = Transform.from_xyt(-0.4, -0.4, 0.0)
    got = search.crude_radius_search(q, 3.0)
    ref = _reference_scan_all(search, q, 3.0)
    assert {id(e) for e in got} == {id(e) for e in ref}


def test_radius_search_flat_in_graph_size():
    """10k vertices spread over many buckets: per-query time must not
    scale with bucket count (the window probe beats the all-bucket scan
    by a wide margin at this size)."""
    els, search = _build(10_000, extent=5000.0, res=3.0, seed=3)
    rng = np.random.default_rng(4)
    queries = [Transform.from_xyt(x, y, 0.0)
               for x, y in rng.uniform(-5000, 5000, (50, 2))]

    # warm + correctness on a few
    for q in queries[:5]:
        assert (
            {id(e) for e in search.crude_radius_search(q, 3.0)}
            == {id(e) for e in _reference_scan_all(search, q, 3.0)}
        )

    t0 = time.perf_counter()
    for q in queries:
        search.crude_radius_search(q, 3.0)
    t_new = time.perf_counter() - t0

    t0 = time.perf_counter()
    for q in queries:
        _reference_scan_all(search, q, 3.0)
    t_old = time.perf_counter() - t0

    # ~10k buckets scanned vs ~36 probed: demand a conservative 5x
    assert t_new < t_old / 5.0, (t_new, t_old)


def test_incremental_update_matches_rebuild():
    els, search = _build(500, extent=100.0, res=3.0, seed=5)
    rng = np.random.default_rng(6)
    # post-SPA-style perturbation: most poses shift slightly, a few jump
    for e in els:
        d = rng.normal(0, 0.4, 2)
        e.pose = Transform.from_xyt(e.pose.x + d[0], e.pose.y + d[1], 0.0)
    for e in els[::50]:
        e.pose = Transform.from_xyt(e.pose.x + 25.0, e.pose.y - 13.0, 0.0)

    search.update_all()
    rebuilt = RadiusHashSearch(els, accessor=lambda e: e.pose, res=3.0)
    assert set(search.hmap.keys()) == set(rebuilt.hmap.keys())
    for key in search.hmap:
        assert (
            {id(e) for e in search.hmap[key]}
            == {id(e) for e in rebuilt.hmap[key]}
        )
    # and a search over the updated hash agrees with the oracle
    q = Transform.from_xyt(0.0, 0.0, 0.0)
    assert (
        {id(e) for e in search.crude_radius_search(q, 10.0)}
        == {id(e) for e in _reference_scan_all(search, q, 10.0)}
    )

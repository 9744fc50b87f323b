"""Scan-set matching, map-grid localization, response expansion, viz."""
import numpy as np
import jax.numpy as jnp
import pytest

from yag_slam_tpu.core.transform import Transform
from yag_slam_tpu.io.simulator import SimWorld, simulate_scan
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher

CFG = {"range_threshold": 5.0, "resolution": 0.02, "search_size": 0.5,
       "smear_deviation": 0.05}


def world_scans(poses, seed=0, n_beams=250):
    world = SimWorld.office()
    rng = np.random.default_rng(seed)
    return [
        simulate_scan(world, np.asarray(p), n_beams=n_beams,
                      range_threshold=5.0, noise=0.003, rng=rng)
        for p in poses
    ]


def test_match_scan_sets_rigid_alignment():
    """A submap of scans offset by a common rigid error must be pulled
    back together (/root/reference/yag_slam/scan_matching.py:56-122)."""
    base = world_scans([[0.0, 0.0, 0.0], [0.5, 0.1, 0.2], [1.0, 0.2, 0.3]],
                       seed=1)
    queries = world_scans([[0.3, -0.2, 0.1], [0.8, -0.1, 0.2]], seed=2)
    offset = (0.07, -0.05)
    truth = [(q.corrected_pose.x, q.corrected_pose.y) for q in queries]
    for q in queries:
        p = q.corrected_pose
        q.corrected_pose = Transform.from_xyt(
            p.x + offset[0], p.y + offset[1], p.euler[-1]
        )

    m = CorrelativeScanMatcher(CFG, dtype=jnp.float64)
    res = m.match_scan_sets(queries, base, penalty=False, do_fine=True)
    assert res.response > 0.4
    assert isinstance(res.best_pose, list) and len(res.best_pose) == 2
    for bp, (tx, ty) in zip(res.best_pose, truth):
        assert abs(bp.x - tx) < 0.05
        assert abs(bp.y - ty) < 0.05


def test_match_scan_sets_with_map():
    """Localize scans against a precomputed correlation grid built from an
    occupancy image (the reference's path is unrunnable as shipped;
    /root/reference/yag_slam/scan_matching.py:154)."""
    from yag_slam_tpu.mapping.occupancy import (
        create_occupancy_grid,
        occupancy_grid_map_to_correlation_grid,
    )

    map_scans = world_scans(
        [[0.0, 0.0, 0.0], [1.0, 0.5, 1.0], [-1.0, -0.5, -1.0],
         [0.5, -1.0, 2.0]],
        seed=3, n_beams=720,
    )
    grid = create_occupancy_grid(map_scans, resolution=0.05,
                                 range_threshold=5.0)
    cgrid = occupancy_grid_map_to_correlation_grid(grid.image, 0.05, 0.05)

    cfg = dict(CFG, resolution=0.05)
    m = CorrelativeScanMatcher(cfg, loop=True, dtype=jnp.float64)
    queries = world_scans([[0.2, 0.1, 0.3]], seed=4)
    truth = (queries[0].corrected_pose.x, queries[0].corrected_pose.y)
    p = queries[0].corrected_pose
    queries[0].corrected_pose = Transform.from_xyt(p.x + 0.08, p.y - 0.06,
                                                   p.euler[-1])
    res = m.match_scan_sets_with_map(
        cgrid, grid.offset.x, grid.offset.y, queries, penalty=False,
        do_fine=True,
    )
    assert res.response > 0.3
    bp = res.best_pose[0]
    assert abs(bp.x - truth[0]) < 0.1
    assert abs(bp.y - truth[1]) < 0.1


def test_response_expansion_triggers():
    """A hopeless match (no overlap) must walk the expansion schedule
    (README.md:40) — observable via the widened-offset program cache keys."""
    base = world_scans([[0.0, 0.0, 0.0]], seed=5)
    query = world_scans([[0.0, 0.0, 0.0]], seed=6)[0]
    # rotate the query belief far outside the +-0.1745 rad coarse window
    query.corrected_pose = Transform.from_xyt(30.0, 30.0, 2.5)

    m = CorrelativeScanMatcher(CFG, dtype=jnp.float64)
    res = m.match_scan(query, base, penalty=False, do_fine=True)
    offsets = sorted({k[4] for k in m._programs if not isinstance(k[0], str)})
    assert len(offsets) == 4  # base + 3 expansion retries
    assert res.response == 0.0

    # with expansion disabled: single program only
    m2 = CorrelativeScanMatcher(dict(CFG, use_response_expansion=False),
                                dtype=jnp.float64)
    m2.match_scan(query, base, penalty=False, do_fine=True)
    offsets2 = sorted({k[4] for k in m2._programs if not isinstance(k[0], str)})
    assert len(offsets2) == 1


def test_library_uploads_batched(monkeypatch):
    """Scan uploads are deferred and flushed in ONE batched insert
    dispatch per fields read (per-scan inserts doubled the online paths'
    dispatch count)."""
    import numpy as np

    from yag_slam_tpu.matching import matcher as M

    calls = []
    orig = M._library_insert

    def counting(fields, rows, slots):
        calls.append(len(np.asarray(slots)))
        return orig(fields, rows, slots)

    monkeypatch.setattr(M, "_library_insert", counting)
    m = CorrelativeScanMatcher(CFG)
    scans = world_scans(
        [[0.1 * i, 0.05 * i, 0.02 * i] for i in range(12)], seed=3,
        n_beams=200,
    )
    m.match_scan(scans[10], scans[:10])
    # the first job's 11 scans went up as ONE padded batch, not 11
    assert len(calls) == 1 and calls[0] >= 11, calls
    m.match_scan(scans[11], scans[1:11])
    # one more flush for the single new scan
    assert len(calls) == 2, calls


def test_viz_smoke(tmp_path):
    from yag_slam_tpu.slam import GraphSlam
    from yag_slam_tpu.utils.viz import save_slam_figure

    slam = GraphSlam(CorrelativeScanMatcher(CFG, dtype=jnp.float64), None)
    for s in world_scans(
        [[0.0, 0.0, 0.0], [0.5, 0.0, 0.1], [1.0, 0.1, 0.2]], seed=7,
        n_beams=500,
    ):
        slam.process_scan(s)
    out = save_slam_figure(slam, str(tmp_path / "map.png"))
    import os

    assert os.path.getsize(out) > 1000

    # 3-D inspector (the threeviz-equivalent view) renders too
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    from yag_slam_tpu.utils.viz import visualize_slam_3d

    ax3 = visualize_slam_3d(slam)
    p3 = str(tmp_path / "map3d.png")
    ax3.figure.savefig(p3, dpi=80)
    plt.close(ax3.figure)
    assert os.path.getsize(p3) > 1000


def test_stage_timer():
    from yag_slam_tpu.utils.profiling import StageTimer

    t = StageTimer()
    with t("a"):
        pass
    with t("a"):
        pass
    s = t.summary()
    assert s["a"]["count"] == 2


@pytest.mark.parametrize("backend,want", [("cpu", ()), ("gpu", (1,))])
def test_library_buffers_donated_off_cpu(monkeypatch, backend, want):
    """Library uploads donate their old buffers on every backend but the
    CPU, where donation is unsupported."""
    import jax

    from yag_slam_tpu.matching import matcher as M

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert M._donated((1,)) == want

"""Golden tests: the XLA matcher vs the float64 numpy oracle."""
import numpy as np
import jax.numpy as jnp
import pytest

from yag_slam_tpu.core.scan import LocalizedRangeScan
from yag_slam_tpu.matching import correlation as C
from yag_slam_tpu.matching import matcher as matcher_mod
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher

from oracle import (
    oracle_build_grid,
    oracle_find_best_pose,
    oracle_kernel,
    oracle_match_scan,
    oracle_validate,
)

# Small-grid config so CPU tests stay fast (range_threshold shrinks the
# correlation grid; all other semantics are unchanged).
TEST_CFG = {
    "range_threshold": 5.0,
    "resolution": 0.02,
    "search_size": 0.5,
    "smear_deviation": 0.05,
    "coarse_search_angle_offset": 0.349,
    "coarse_angle_resolution": 0.0349,
    "fine_search_angle_resolution": 0.00349,
    "use_response_expansion": True,
}


def make_room_scan(x, y, t, n_beams=180, seed=0, room=4.0):
    """Scan of a square room of half-size `room` centered at origin, taken
    from pose (x, y, t), with small range noise."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(-np.pi, np.pi, n_beams, endpoint=False)
    world_angles = angles + t
    ranges = np.empty(n_beams)
    for i, a in enumerate(world_angles):
        c, s = np.cos(a), np.sin(a)
        ds = []
        if c > 1e-9:
            ds.append((room - x) / c)
        if c < -1e-9:
            ds.append((-room - x) / c)
        if s > 1e-9:
            ds.append((room - y) / s)
        if s < -1e-9:
            ds.append((-room - y) / s)
        ranges[i] = min(d for d in ds if d > 0)
    ranges += rng.normal(0, 0.003, n_beams)
    return LocalizedRangeScan(
        ranges, -np.pi, np.pi, 2 * np.pi / n_beams, 0.0, 30.0, 5.0, x, y, t
    )


def test_kernel_matches_oracle():
    k2 = C.gaussian_kernel_2d(0.02, 0.05)
    ko = oracle_kernel(0.02, 0.05)
    # 4*np.round(0.05/0.02)+1 = 9 (banker's rounding: round(2.4999...) = 2)
    assert k2.shape == ko.shape == (9, 9)
    np.testing.assert_allclose(k2, ko, atol=1e-14)
    # size formula: 4*round(smear/res)+1
    assert C.gaussian_kernel_2d(0.01, 0.05).shape == (21, 21)
    assert C.gaussian_kernel_2d(0.05, 0.05).shape == (5, 5)


def test_validation_runs_match_oracle():
    rng = np.random.default_rng(7)
    scan = make_room_scan(0.3, -0.2, 0.4, n_beams=240, seed=3)
    wx, wy = scan.points()
    n = len(wx)
    for trial in range(5):
        vx, vy = rng.uniform(-2, 2, 2)
        ox_, oy_ = oracle_validate(wx, wy, vx, vy)

        anchor, term, has = C.segment_validation_runs(wx, wy, n)
        keep = np.asarray(
            C.keep_mask_for_viewpoint(
                jnp.asarray(wx), jnp.asarray(wy),
                jnp.asarray(anchor), jnp.asarray(term), jnp.asarray(has),
                jnp.ones(n, bool), vx, vy,
            )
        )
        np.testing.assert_allclose(wx[keep], ox_, atol=1e-12)
        np.testing.assert_allclose(wy[keep], oy_, atol=1e-12)


def test_grid_build_matches_oracle():
    res, smear, G = 0.02, 0.05, 256
    ox = oy = -2.0
    rng = np.random.default_rng(11)
    pts = [
        (rng.uniform(-2.2, 3.2, 60), rng.uniform(-2.2, 3.2, 60)) for _ in range(3)
    ]
    kernel = oracle_kernel(res, smear)
    ref = oracle_build_grid(pts, ox, oy, G, res, kernel)

    wx = jnp.asarray(np.concatenate([p[0] for p in pts]))
    wy = jnp.asarray(np.concatenate([p[1] for p in pts]))
    got = np.asarray(
        C.build_correlation_grid(
            wx, wy, jnp.ones(len(wx), bool), ox, oy,
            grid_size=G, res=res, k1=C.gaussian_kernel_1d(res, smear),
            dtype=jnp.float64,
        )
    )
    np.testing.assert_allclose(got, ref, atol=1e-13)


@pytest.mark.parametrize("penalize", [True, False])
@pytest.mark.parametrize("symmetric", [True, False])
def test_find_best_pose_matches_oracle(penalize, symmetric):
    res = 0.02
    G = 256
    rng = np.random.default_rng(13)
    cx, cy, ct = 0.55, -0.35, 0.3
    ox = cx - 0.5 * (G - 1) * res
    oy = cy - 0.5 * (G - 1) * res
    pts = [(rng.uniform(cx - 2, cx + 2, 150), rng.uniform(cy - 2, cy + 2, 150))]
    kernel = oracle_kernel(res, 0.05)
    cgrid = oracle_build_grid(pts, ox, oy, G, res, kernel)

    # query points: a noisy ring
    a = np.linspace(-np.pi, np.pi, 120, endpoint=False)
    px = 1.5 * np.cos(a) + rng.normal(0, 0.01, 120)
    py = 1.5 * np.sin(a) + rng.normal(0, 0.01, 120)

    args = (cx, cy, ct, ox, oy, 0.25, res * 2, 0.1745, 0.0349, res, penalize)
    ref = oracle_find_best_pose(cgrid, px, py, *args, symmetric=symmetric)

    spec = C.LatticeSpec.from_search(cx, cy, ct, 0.25, res * 2, 0.1745, 0.0349)
    qflat = jnp.concatenate(
        [C.quantize_grid(jnp.asarray(cgrid)).ravel(), jnp.zeros(1)]
    )
    got = C.find_best_pose(
        qflat, jnp.asarray(px), jnp.asarray(py), float(len(px)),
        cx, cy, ct, ox, oy,
        spec=spec, xy_size=0.25, xy_res=res * 2, ang_size=0.1745,
        ang_res=0.0349, grid_size=G, grid_res=res, penalize=penalize,
        dtype=jnp.float64, symmetric=symmetric,
    )
    got = [float(v) for v in got]
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)


def test_full_match_scan_matches_oracle():
    base_scans = [
        make_room_scan(0.1 * i, 0.05 * i, 0.05 * i, seed=20 + i) for i in range(3)
    ]
    query = make_room_scan(0.35, 0.18, 0.12, seed=30)
    # perturb the query's belief so the matcher has work to do
    true_pose = query.corrected_pose
    from yag_slam_tpu.core.transform import Transform

    query.corrected_pose = Transform.from_xyt(
        true_pose.x + 0.06, true_pose.y - 0.04, true_pose.euler[-1] + 0.03
    )

    matcher = CorrelativeScanMatcher(TEST_CFG, dtype=jnp.float64)
    res = matcher.match_scan(query, base_scans, penalty=True, do_fine=True)

    qp = query.corrected_pose
    ref_resp, ref_pose, ref_cov, _ = oracle_match_scan(
        query.points_local(),
        (qp.x, qp.y, qp.euler[-1]),
        [s.points() for s in base_scans],
        dict(TEST_CFG),
        penalty=True,
        do_fine=True,
    )

    assert np.isclose(res.response, ref_resp, rtol=1e-9)
    got_pose = (res.best_pose.x, res.best_pose.y, res.best_pose.euler[-1])
    np.testing.assert_allclose(got_pose, ref_pose, atol=1e-9)
    # TH sits behind two floor-quantization boundaries; 1-ulp kernel
    # differences (separable product vs joint exp) can flip a single cell,
    # so the theta variance gets a looser tolerance than the xy block.
    np.testing.assert_allclose(res.covariance, ref_cov, rtol=1e-4, atol=1e-12)
    # and the matcher should have moved the pose estimate toward the truth
    assert abs(res.best_pose.x - true_pose.x) < 0.03
    assert abs(res.best_pose.y - true_pose.y) < 0.03


def test_match_scan_recovers_offset():
    """End-to-end sanity: a query whose belief is offset from truth gets
    pulled back within a lattice step."""
    base = [make_room_scan(0, 0, 0, seed=40)]
    query = make_room_scan(0.1, -0.08, 0.05, seed=41)
    from yag_slam_tpu.core.transform import Transform

    query.corrected_pose = Transform.from_xyt(0.04, -0.02, 0.01)
    matcher = CorrelativeScanMatcher(TEST_CFG, dtype=jnp.float64)
    res = matcher.match_scan(query, base, penalty=False, do_fine=True)
    assert res.response > 0.5
    assert abs(res.best_pose.x - 0.1) < 0.03
    assert abs(res.best_pose.y - (-0.08)) < 0.03
    assert abs(res.best_pose.euler[-1] - 0.05) < 0.02


def test_reference_smoke_scenario():
    """The reference's only test (/root/reference/test.py:23-48): 230-beam
    constant-range scan, query displaced to (1.0, 0, 1.57)."""
    cfg = dict(TEST_CFG, range_threshold=6.0)
    base = [
        LocalizedRangeScan([3.0] * 230, -1.0, 1.0, np.deg2rad(0.5), 0, 10, 5, 0, 0, 0)
    ]
    query = LocalizedRangeScan(
        [3.0] * 230, -1.0, 1.0, np.deg2rad(0.5), 0, 10, 5, 1.0, 0, 1.57
    )
    matcher = CorrelativeScanMatcher(cfg, dtype=jnp.float64)
    res = matcher.match_scan(query, base, penalty=True, do_fine=True)
    # The 1 m displacement is outside the ±0.25 m search window, so there is
    # no overlap: response 0 and a 0/0 covariance — exactly what the
    # reference spec produces for this input (the reference test only
    # prints; /root/reference/test.py:38-43).
    assert np.isfinite(res.response)
    assert np.isfinite(
        [res.best_pose.x, res.best_pose.y, res.best_pose.euler[-1]]
    ).all()

    # Same sensor geometry with an overlapping displacement (inside the
    # +/-0.25 m window) must actually demonstrate matching: the query's
    # pose guess is pulled back onto the base's arc (a constant-range arc
    # pins translation).
    query2 = LocalizedRangeScan(
        [3.0] * 230, -1.0, 1.0, np.deg2rad(0.5), 0, 10, 5, 0.12, -0.06, 0.0
    )
    # penalty=False: the unpenalized correlation must recover the true
    # overlap (the distance penalty legitimately biases toward the window
    # center at this displacement — reference semantics)
    res2 = matcher.match_scan(query2, base, penalty=False, do_fine=True)
    assert res2.response > 0.8
    assert abs(res2.best_pose.x) < 0.03
    assert abs(res2.best_pose.y) < 0.03


def _match_with_scorer(monkeypatch, scorer, cfg, query, base):
    """Full match with every pass forced onto one lattice scorer."""
    monkeypatch.setattr(matcher_mod, "_pick_scorer",
                        lambda spec, stride: scorer)
    return CorrelativeScanMatcher(cfg).match_scan(query, base, True, True)


def test_patch_scoring_path_matches_gather_path(monkeypatch):
    """The window-gather scorer must agree with the element-gather
    scorer (same matcher, scorer forced either way)."""
    base = [make_room_scan(0.1 * i, 0.02 * i, 0.01 * i, seed=i) for i in range(4)]
    query = make_room_scan(0.42, -0.13, 0.12, seed=9)

    r_ref = _match_with_scorer(monkeypatch, "element", TEST_CFG, query, base)
    r_patch = _match_with_scorer(monkeypatch, "patch", TEST_CFG, query, base)

    assert r_patch.response == pytest.approx(r_ref.response, abs=1e-9)
    assert r_patch.best_pose.x == pytest.approx(r_ref.best_pose.x, abs=1e-9)
    assert r_patch.best_pose.y == pytest.approx(r_ref.best_pose.y, abs=1e-9)
    assert r_patch.best_pose.euler[-1] == pytest.approx(
        r_ref.best_pose.euler[-1], abs=1e-9
    )
    np.testing.assert_allclose(r_patch.covariance, r_ref.covariance,
                               rtol=1e-7, atol=1e-12)


def test_patch_path_masks_grid_high_edge(monkeypatch):
    """Regression: when the bucketed subgrid overhangs
    the full grid's high edge (S = round_up(G, 128) > G), smear spreads
    in-grid occupancy into subgrid cells with global index >= G.  The
    element path masks those reads (gx < G); the patch path must zero them
    at q2d build, or queries just past the grid edge score nonzero."""
    cfg = dict(TEST_CFG, range_threshold=2.0, resolution=0.01)
    # G = 0.5/0.01 + 1 + 2*2.0/0.01 = 451; bucket rounds to 512 > G.
    # Base offset +x so its endpoints cross the grid's high-x edge (grid
    # half extent from the query center = 2.25 m; base points reach 2.6 m).
    base = [make_room_scan(0.6, 0.0, 0.0, n_beams=240, seed=1, room=2.5)]
    query = make_room_scan(0.02, 0.01, 0.02, n_beams=240, seed=2, room=2.5)
    query.corrected_pose = query.odom_pose

    assert CorrelativeScanMatcher(cfg).grid_size == 451
    r_el = _match_with_scorer(monkeypatch, "element", cfg, query, base)
    r_pt = _match_with_scorer(monkeypatch, "patch", cfg, query, base)
    assert r_pt.response == pytest.approx(r_el.response, abs=1e-9)
    assert r_pt.best_pose.x == pytest.approx(r_el.best_pose.x, abs=1e-9)
    assert r_pt.best_pose.y == pytest.approx(r_el.best_pose.y, abs=1e-9)
    np.testing.assert_allclose(r_pt.covariance, r_el.covariance,
                               rtol=0, atol=1e-9)


def test_patch_path_full_grid_bounds_mask_semantics():
    """Deterministic pin of the high-edge overhang at the kernel
    level: with a subgrid that overhangs the full grid (S=512 > G=451,
    sox=soy=0) and nonzero cells at global indices >= G, the element path
    masks those reads (gx < G) while the raw patch path reads them.  The
    matcher's q2d masking (zero rows/cols >= G - so{x,y}) must make the
    two paths agree exactly."""
    import jax

    with jax.enable_x64(True):
        dtype = np.float64
        G, S, N = 451, 512, 1
        res = 0.01
        spec = C.LatticeSpec.from_search(0.0, 0.0, 0.0, 0.25, 0.02,
                                         0.1745, 0.0349)
        rng = np.random.default_rng(42)
        q2d = np.floor(rng.uniform(0, 100, (N, S, S))).astype(dtype)
        masked = q2d.copy()
        masked[:, G:, :] = 0.0
        masked[:, :, G:] = 0.0

        P = 64
        px = rng.uniform(0.0, 0.3, (N, P)).astype(dtype)
        py = rng.uniform(-0.2, 0.2, (N, P)).astype(dtype)
        n_pts = np.full(N, P, dtype=dtype)
        # search centered near the grid's high-x edge so candidate reads
        # cross gx = G
        cx = np.full(N, 4.2, dtype=dtype)
        cy = np.full(N, 2.25, dtype=dtype)
        ct = np.zeros(N, dtype=dtype)
        ox = oy = np.zeros(N, dtype=dtype)
        sox = soy = np.zeros(N, dtype=np.int32)

        kw = dict(spec=spec, xy_size=0.25, xy_res=0.02, ang_size=0.1745,
                  ang_res=0.0349, grid_size=G, grid_res=res, sub_size=S,
                  penalize=False, dtype=dtype)
        out_el, *_ = C.score_lattice_batched(
            q2d, px, py, n_pts, cx, cy, ct, ox, oy, sox, soy, **kw)
        out_masked, *_ = C.score_lattice_patch_batched(
            masked, px, py, n_pts, cx, cy, ct, ox, oy, sox, soy, **kw)
        out_raw, *_ = C.score_lattice_patch_batched(
            q2d, px, py, n_pts, cx, cy, ct, ox, oy, sox, soy, **kw)

        # the scenario must actually exercise reads past the grid edge
        assert not np.allclose(np.asarray(out_raw), np.asarray(out_el)), \
            "scenario failed to produce out-of-grid reads"
        np.testing.assert_allclose(
            np.asarray(out_masked), np.asarray(out_el), rtol=0, atol=1e-12)


def _arc_scan(x, y, t, arc_half_deg=5.0, dist=3.0, n_beams=360):
    """Scan seeing only a narrow arc of wall at `dist` — everything else
    out of range.  Narrow support makes response exactly 0 when the yaw
    guess is outside the angular search window."""
    angles = np.linspace(-np.pi, np.pi, n_beams, endpoint=False)
    ranges = np.full(n_beams, np.nan)
    sel = np.abs(np.degrees(angles)) <= arc_half_deg
    ranges[sel] = dist
    return LocalizedRangeScan(
        ranges, -np.pi, np.pi, 2 * np.pi / n_beams, 0.0, 30.0, 5.0, x, y, t
    )


def test_response_expansion_recovers_rotated_query():
    """Karto's response expansion (OpenKarto ScanMatcher::MatchScan: when
    the best response is 0, retry up to 3 times with the angle search
    offset widened by 20 deg each try; surfaced in the reference via the
    use_response_expansion key, /root/reference/yag_slam/helpers.py:345,
    README.md:40).  A query whose yaw guess is 0.4 rad off scores exactly
    0 in the default +/-0.1745 rad window and must be recovered only via
    the widened retries.  Expansion restores a usable
    response and pulls the yaw back toward truth; like Karto, it does not
    promise full convergence from an arbitrary initial error."""
    cfg = dict(TEST_CFG)
    base = [_arc_scan(0.0, 0.0, 0.0)]
    query = _arc_scan(0.0, 0.0, 0.5)  # true pose (0,0,0); guess 0.5 rad off
    query.corrected_pose = query.odom_pose

    # the reference exercises expansion on the unpenalized coarse loop
    # match (/root/reference/yag_slam/graph_slam.py:220)
    m_off = CorrelativeScanMatcher(dict(cfg, use_response_expansion=False))
    r_off = m_off.match_scan(query, base, penalty=False, do_fine=False)
    assert r_off.response <= 0.0, "scenario must start outside the window"

    m_on = CorrelativeScanMatcher(dict(cfg, use_response_expansion=True))
    r_on = m_on.match_scan(query, base, penalty=False, do_fine=False)
    assert r_on.response > 0.0
    # recovered yaw pulled back toward 0 (initial error 0.5)
    assert abs(r_on.best_pose.euler[-1]) < 0.3


def _karto_penalty_oracle(q2d, qx, qy, cx, cy, ct, ox, oy, sox, soy,
                          spec, xy_size, xy_res, ang_size, ang_res,
                          G, S, res, kp):
    """f64 numpy oracle of OpenKarto's C++ penalty semantics (Mapper.cpp
    ScanMatcher::CorrelateScan): response scaled by
    max(1 - 0.2*d2/dist_var, min_dist) * max(1 - 0.2*a2/ang_var, min_ang),
    offsets from the SEARCH CENTER, variances consumed directly."""
    dv, av, md, ma = kp
    nx, ny, nt = spec
    xvals = (cx - xy_size) + np.arange(nx) * xy_res
    yvals = (cy - xy_size) + np.arange(ny) * xy_res
    tvals = (ct - ang_size) + np.arange(nt) * ang_res
    out = np.zeros((nx, ny, nt))
    n = len(qx)
    for k, t in enumerate(tvals):
        c, s = np.cos(t), np.sin(t)
        rx = c * qx - s * qy
        ry = s * qx + c * qy
        ang_pen = max(1.0 - 0.2 * (t - ct) ** 2 / av, ma)
        for i, xv in enumerate(xvals):
            for j, yv in enumerate(yvals):
                gx = np.round((xv + rx - ox) / res).astype(int)
                gy = np.round((yv + ry - oy) / res).astype(int)
                sgx, sgy = gx - sox, gy - soy
                ok = ((gx >= 0) & (gx < G) & (gy >= 0) & (gy < G)
                      & (sgx >= 0) & (sgx < S) & (sgy >= 0) & (sgy < S))
                raw = q2d[sgy[ok], sgx[ok]].sum()
                dist_pen = max(
                    1.0 - 0.2 * ((xv - cx) ** 2 + (yv - cy) ** 2) / dv, md
                )
                out[i, j, k] = raw / n * dist_pen * ang_pen / 100.0
    return out


def test_karto_penalty_mode_golden():
    """The use_karto_penalties scoring mode must
    match the C++-semantics oracle cell-for-cell on every scorer path."""
    rng = np.random.default_rng(7)
    G, S, res = 201, 256, 0.02
    q2d = np.floor(rng.uniform(0, 100, (S, S)))
    P = 64
    qx = rng.uniform(-1.5, 1.5, P)
    qy = rng.uniform(-1.5, 1.5, P)
    cx, cy, ct = 0.31, -0.22, 0.15
    ox, oy = cx - 0.5 * (G - 1) * res, cy - 0.5 * (G - 1) * res
    sox = soy = 0
    kp = (0.5, 0.3, 0.5, 0.9)
    spec = C.LatticeSpec.from_search(0.0, 0.0, 0.0, 0.25, 0.04,
                                     0.1745, 0.0349)
    want = _karto_penalty_oracle(
        q2d, qx, qy, cx, cy, ct, ox, oy, sox, soy, spec,
        0.25, 0.04, 0.1745, 0.0349, G, S, res, kp,
    )

    import jax.numpy as jnp

    common = dict(
        spec=spec, xy_size=0.25, xy_res=0.04, ang_size=0.1745,
        ang_res=0.0349, grid_size=G, grid_res=res, sub_size=S,
        penalize=True, dtype=jnp.float64, karto_penalties=kp,
    )
    args_b = (
        jnp.asarray(qx)[None], jnp.asarray(qy)[None],
        jnp.asarray([float(P)]), jnp.asarray([cx]), jnp.asarray([cy]),
        jnp.asarray([ct]), jnp.asarray([ox]), jnp.asarray([oy]),
        jnp.asarray([sox]), jnp.asarray([soy]),
    )
    out_e, *_ = C.score_lattice_batched(jnp.asarray(q2d)[None], *args_b,
                                        **common)
    np.testing.assert_allclose(np.asarray(out_e)[0], want, atol=1e-12)

    out_p, *_ = C.score_lattice_patch_batched(
        jnp.asarray(q2d)[None], *args_b, **common
    )
    np.testing.assert_allclose(np.asarray(out_p)[0], want, atol=1e-12)

    # unbatched path (the with-map localization driver)
    out_s, *_ = C.score_lattice(
        jnp.concatenate([jnp.asarray(q2d).ravel(), jnp.zeros(1)]),
        jnp.asarray(qx), jnp.asarray(qy), float(P), cx, cy, ct, ox, oy,
        spec=spec, xy_size=0.25, xy_res=0.04, ang_size=0.1745,
        ang_res=0.0349, grid_size=G, grid_res=res, sub_size=S,
        penalize=True, dtype=jnp.float64, karto_penalties=kp,
    )
    np.testing.assert_allclose(np.asarray(out_s), want, atol=1e-12)

    # FINE-pass geometry: the search center moves to the coarse best pose
    # while the grid (ox, oy) stays put — OpenKarto measures the distance
    # penalty from the PASS's search center, not the grid center (the
    # batched scorers previously derived it from ox/oy)
    cx2, cy2, ct2 = cx + 0.13, cy - 0.07, ct + 0.05
    fspec = C.LatticeSpec.from_search(0.0, 0.0, 0.0, 0.04, 0.02,
                                      0.01745, 0.00349)
    want_f = _karto_penalty_oracle(
        q2d, qx, qy, cx2, cy2, ct2, ox, oy, sox, soy, fspec,
        0.04, 0.02, 0.01745, 0.00349, G, S, res, kp,
    )
    args_f = (
        jnp.asarray(qx)[None], jnp.asarray(qy)[None],
        jnp.asarray([float(P)]), jnp.asarray([cx2]), jnp.asarray([cy2]),
        jnp.asarray([ct2]), jnp.asarray([ox]), jnp.asarray([oy]),
        jnp.asarray([sox]), jnp.asarray([soy]),
    )
    out_f, *_ = C.score_lattice_batched(
        jnp.asarray(q2d)[None], *args_f, spec=fspec, xy_size=0.04, xy_res=0.02,
        ang_size=0.01745, ang_res=0.00349, grid_size=G, grid_res=res,
        sub_size=S, penalize=True, dtype=jnp.float64, karto_penalties=kp,
    )
    np.testing.assert_allclose(np.asarray(out_f)[0], want_f, atol=1e-12)
    out_fp, *_ = C.score_lattice_patch_batched(
        jnp.asarray(q2d)[None], *args_f, spec=fspec, xy_size=0.04,
        xy_res=0.02, ang_size=0.01745, ang_res=0.00349, grid_size=G,
        grid_res=res, sub_size=S, penalize=True, dtype=jnp.float64,
        karto_penalties=kp,
    )
    np.testing.assert_allclose(np.asarray(out_fp)[0], want_f, atol=1e-12)


def test_karto_penalty_mode_end_to_end():
    """A matcher constructed with use_karto_penalties=True still recovers
    the pose; with a tight angle variance, clamping at
    minimum_angle_penalty changes off-center responses versus spec mode."""
    base = [make_room_scan(0.0, 0.0, 0.0)]
    query = make_room_scan(0.12, -0.08, 0.05, seed=1)
    query.corrected_pose = query.odom_pose

    m_spec = CorrelativeScanMatcher(TEST_CFG)
    m_karto = CorrelativeScanMatcher(
        dict(TEST_CFG, use_karto_penalties=True,
             angle_variance_penalty=0.02, distance_variance_penalty=0.05),
    )
    r_spec = m_spec.match_scan(query, base, penalty=True, do_fine=True)
    query.corrected_pose = query.odom_pose
    r_karto = m_karto.match_scan(query, base, penalty=True, do_fine=True)
    for r in (r_spec, r_karto):
        assert r.response > 0.3
        assert abs(r.best_pose.x - 0.12) < 0.05
        assert abs(r.best_pose.y + 0.08) < 0.05
    # the two penalty models genuinely differ
    assert abs(r_spec.response - r_karto.response) > 1e-6


def test_match_many_expansion_batched():
    """When several jobs of a match_many batch need response expansion,
    the retries run as ONE widened dispatch over the whole empty subset
    per attempt — O(attempts) programs, not O(jobs) synchronous
    match_scan fallbacks.  Results must equal the
    per-job path's."""
    cfg = dict(TEST_CFG)
    base = [_arc_scan(0.0, 0.0, 0.0)]
    # 4 queries whose yaw guesses are outside the default window (response
    # exactly 0 -> expansion) + 2 well-aligned ones (no expansion)
    empties = [_arc_scan(0.0, 0.0, 0.4 + 0.02 * i) for i in range(4)]
    goods = [_arc_scan(0.0, 0.0, 0.02 * i) for i in range(2)]
    for q in empties + goods:
        q.corrected_pose = q.odom_pose

    m = CorrelativeScanMatcher(dict(cfg, use_response_expansion=True))
    calls = []
    orig_program = m._program

    def counting_program(*a, **kw):
        prog = orig_program(*a, **kw)

        def wrapped(*pa, **pkw):
            calls.append(a[4])  # coarse_offset of the dispatched program
            return prog(*pa, **pkw)

        return wrapped

    m._program = counting_program
    jobs = [(q, base) for q in empties + goods]
    results = m.match_many(jobs, penalty=False, do_fine=False)

    # one base dispatch + at most _EXPANSION_TRIES widened dispatches —
    # NOT one synchronous match_scan per empty job
    assert len(calls) <= 4, calls
    assert len(set(calls)) == len(calls), "each attempt dispatched once"
    for r, q in zip(results[:4], empties):
        assert r.response > 0.0  # expansion recovered the rotated queries
        assert abs(r.best_pose.euler[-1]) < 0.3
    # per-job equivalence (independent matcher, per-job path)
    m2 = CorrelativeScanMatcher(dict(cfg, use_response_expansion=True))
    for r, (q, bs) in zip(results, jobs):
        single = m2.match_scan(q, bs, penalty=False, do_fine=False)
        assert np.isclose(r.response, single.response, rtol=1e-9)
        assert np.isclose(r.best_pose.euler[-1],
                          single.best_pose.euler[-1], atol=1e-9)


def test_degenerate_fixup_survives_f32_far_from_origin():
    """The zero-response reference-exact fixup must still fire when the
    matcher runs in float32 and the trajectory sits tens of meters from
    the origin: the full-lattice tie mean is computed on device in f32,
    so the consistency check must tolerate f32 spacing at that magnitude
    (a fixed 1e-6 silently disabled the fixup beyond ~10 m)."""
    cfg = dict(TEST_CFG, use_response_expansion=False)
    X, Y = 20.0, -15.0
    base = [_arc_scan(X, Y, 0.0)]
    query = _arc_scan(X, Y, 0.5)  # outside the angular window -> response 0
    query.corrected_pose = query.odom_pose

    m = CorrelativeScanMatcher(cfg, dtype=jnp.float32)
    r = m.match_scan(query, base, penalty=False, do_fine=True)
    assert r.response <= 0.0
    # reference-exact expectation: arange means at the true centers
    res = cfg["resolution"]
    bx = float(np.arange(X - 0.25, X + 0.25, res * 2).mean())
    fx = float(np.arange(bx - res * 2, bx + res * 2, res).mean())
    assert abs(r.best_pose.x - fx) < 1e-4, (r.best_pose.x, fx)


def test_match_many_mega_matches_match_many():
    """match_many_mega (whole job list as ONE lax.scan program) must
    reproduce match_many exactly, including chunk padding (N not a
    multiple of chunk) and jobs that need response expansion."""
    cfg = dict(TEST_CFG)
    base = [_arc_scan(0.0, 0.0, 0.0)]
    queries = (
        [_arc_scan(0.0, 0.0, 0.02 * i) for i in range(3)]
        + [_arc_scan(0.0, 0.0, 0.45)]          # expansion-needing
        + [_arc_scan(0.0, 0.0, -0.03)]
    )
    for q in queries:
        q.corrected_pose = q.odom_pose
    jobs = [(q, base) for q in queries]        # N=5, chunk=2 -> pad to 6

    m1 = CorrelativeScanMatcher(cfg)
    ref = m1.match_many(jobs, penalty=False, do_fine=True)
    m2 = CorrelativeScanMatcher(cfg)
    got = m2.match_many_mega(jobs, penalty=False, do_fine=True, chunk=2)
    assert len(got) == len(ref) == 5
    for a, b in zip(ref, got):
        assert np.isclose(a.response, b.response, rtol=1e-9)
        assert np.isclose(a.best_pose.x, b.best_pose.x, atol=1e-9)
        assert np.isclose(a.best_pose.euler[-1], b.best_pose.euler[-1],
                          atol=1e-9)
        # different batch shapes change f64 reduction order; near-zero
        # off-diagonal moments wobble at ~1e-9 absolute
        np.testing.assert_allclose(a.covariance, b.covariance, rtol=1e-6,
                                   atol=1e-8)
    assert got[3].response > 0.0  # expansion recovered through mega too

"""Float64 numpy oracle for golden tests.

An independent, vectorized re-statement of the reference matcher's
semantics (spec: /root/reference/yag_slam/helpers.py — `calculate_kernel`,
`add_scan_to_grid`, `score_*_on_grid`, `find_best_pose`, `validate_points`).
Written in plain vectorized numpy, structured differently from both the
reference's numba loops and the framework's XLA programs, so that agreement
between the three is meaningful.
"""
import numpy as np


def oracle_kernel(res, smear):
    size = int(4 * np.round(smear / res) + 1)
    half = size // 2
    ii, jj = np.mgrid[-half : half + 1, -half : half + 1]
    return np.exp(-0.5 * ((ii * res) ** 2 + (jj * res) ** 2) / smear**2)


def oracle_validate(ptsx, ptsy, vpx, vpy):
    """Sequential back-facing filter; returns (kept_x, kept_y) lists."""
    msd = 0.2**2
    retx, rety = [], []
    fpx, fpy = ptsx[0], ptsy[0]
    tmpx, tmpy = [], []
    for i in range(1, len(ptsx)):
        cpx, cpy = ptsx[i], ptsy[i]
        tmpx.append(cpx)
        tmpy.append(cpy)
        if (fpx - cpx) ** 2 + (fpy - cpy) ** 2 > msd:
            a = vpy - fpy
            b = fpx - vpx
            c = fpy * vpx - fpx * vpy
            fpx, fpy = cpx, cpy
            if cpx * a + cpy * b + c > 0.0:
                retx.extend(tmpx)
                rety.extend(tmpy)
            tmpx, tmpy = [], []
    return np.array(retx), np.array(rety)


def oracle_world_to_grid(x, y, ox, oy, res):
    return np.round((x - ox) / res), np.round((y - oy) / res)


def oracle_build_grid(point_sets, ox, oy, grid_size, res, kernel):
    """point_sets: list of (x, y) world-point arrays (already validated)."""
    G = grid_size
    cgrid = np.zeros((G, G))
    half = kernel.shape[0] // 2
    for px, py in point_sets:
        gx, gy = oracle_world_to_grid(np.asarray(px), np.asarray(py), ox, oy, res)
        gx = gx.astype(np.int64)
        gy = gy.astype(np.int64)
        ok = (gx >= 0) & (gx < G) & (gy >= 0) & (gy < G)
        for x0, y0 in zip(gx[ok], gy[ok]):
            ys, ye = max(0, y0 - half), min(G, y0 + half + 1)
            xs, xe = max(0, x0 - half), min(G, x0 + half + 1)
            patch = kernel[
                ys - y0 + half : ye - y0 + half, xs - x0 + half : xe - x0 + half
            ]
            np.maximum(cgrid[ys:ye, xs:xe], patch, out=cgrid[ys:ye, xs:xe])
    return cgrid


def oracle_score_lattice(
    q, ptsx, ptsy, cx, cy, ct, ox, oy, xy_size, xy_res, ang_size, ang_res,
    grid_res, penalize, symmetric=True,
):
    """Response of every (x, y, theta) candidate against a quantized
    (floor(100 x)) full grid `q`; returns (out, xvals, yvals, tvals)."""
    G = q.shape[0]
    xvals = np.arange(-xy_size + cx, xy_size + cx, xy_res)
    yvals = np.arange(-xy_size + cy, xy_size + cy, xy_res)
    tvals = np.arange(-ang_size + ct, ang_size + ct, ang_res)
    NX, NY, NT = len(xvals), len(yvals), len(tvals)

    out = np.empty((NX, NY, NT))
    for k, t in enumerate(tvals):
        rx = ptsx * np.cos(t) - ptsy * np.sin(t)
        ry = ptsy * np.cos(t) + ptsx * np.sin(t)
        gx = np.round((xvals[:, None] + rx[None, :] - ox) / grid_res).astype(np.int64)
        gy = np.round((yvals[:, None] + ry[None, :] - oy) / grid_res).astype(np.int64)
        okx = (gx >= 0) & (gx < G)
        oky = (gy >= 0) & (gy < G)
        vals = q[np.clip(gy, 0, G - 1)[None, :, :], np.clip(gx, 0, G - 1)[:, None, :]]
        vals = np.where(okx[:, None, :] & oky[None, :, :], vals, 0.0)
        out[:, :, k] = vals.sum(-1)

    out = out / len(ptsx)
    if penalize:
        if symmetric:
            sx = ox + G * grid_res / 2
            sy = oy + G * grid_res / 2
        else:
            sx, sy = cx, cy
        dp = 1.0 - 0.2 * (
            (xvals[:, None] - sx) ** 2 + (yvals[None, :] - sy) ** 2
        ) / (0.5 * grid_res)
        ap = 1.0 - 0.2 * (tvals - ct) ** 2 / (1.0 * grid_res)
        out = out * dp[:, :, None] * ap[None, None, :]
    return out / 100.0, xvals, yvals, tvals


def oracle_find_best_pose(
    cgrid, ptsx, ptsy, cx, cy, ct, ox, oy, xy_size, xy_res, ang_size, ang_res,
    grid_res, penalize, symmetric=True,
):
    out, xvals, yvals, tvals = oracle_score_lattice(
        np.floor(cgrid * 100.0), ptsx, ptsy, cx, cy, ct, ox, oy, xy_size,
        xy_res, ang_size, ang_res, grid_res, penalize, symmetric)
    NX, NY, NT = out.shape

    m = int(np.argmax(out))
    ii, jj, kk = np.unravel_index(m, out.shape)
    response = out[ii, jj, kk]

    ti, tj, tk = np.where(out >= response - 1e-8)
    bx = xvals[ti].mean()
    by = yvals[tj].mean()
    bt = tvals[tk].mean()

    xs, xe = max(0, ii - 5), min(NX - 1, ii + 6)
    ys, ye = max(0, jj - 5), min(NY - 1, jj + 6)
    w = out[xs:xe, ys:ye, kk]
    dx = xvals[xs:xe, None] - bx
    dy = yvals[None, ys:ye] - by
    norm = w.sum()
    XX = (w * dx**2).sum()
    YY = (w * dy**2).sum()
    XY = (w * dx * dy).sum()

    ts, te = max(0, kk - 5), min(NT - 1, kk + 6)
    wt = out[ii, jj, ts:te]
    th_norm = wt.sum()
    TH = (wt * (tvals[ts:te] - bt) ** 2).sum()

    return [
        response, bx, by, bt,
        XX / norm / response, YY / norm / response, XY / norm / response,
        TH / th_norm,
    ]


def oracle_match_scan(
    query_pts_local, query_pose, base_point_sets, cfg, penalty=True, do_fine=True
):
    """Full coarse-to-fine match; mirrors
    /root/reference/yag_slam/scan_matching.py:175-222.

    base_point_sets: list of raw world-point (x, y) tuples — validation is
    applied here against the query pose.
    """
    res = cfg["resolution"]
    G = int(cfg["search_size"] / res + 1 + 2 * cfg["range_threshold"] / res)
    qx, qy, qt = query_pose
    ox = qx - 0.5 * (G - 1) * res
    oy = qy - 0.5 * (G - 1) * res
    kernel = oracle_kernel(res, cfg["smear_deviation"])
    validated = [
        oracle_validate(px, py, qx, qy) for px, py in base_point_sets
    ]
    validated = [(px, py) for px, py in validated if len(px)]
    cgrid = oracle_build_grid(validated, ox, oy, G, res, kernel)

    px, py = query_pts_local
    coarse = oracle_find_best_pose(
        cgrid, px, py, qx, qy, qt, ox, oy,
        cfg["search_size"] * 0.5, res * 2,
        cfg["coarse_search_angle_offset"] * 0.5, cfg["coarse_angle_resolution"],
        res, penalty,
    )
    if do_fine:
        fine = oracle_find_best_pose(
            cgrid, px, py, coarse[1], coarse[2], coarse[3], ox, oy,
            res * 2, res, 0.0349 * 0.5, cfg["fine_search_angle_resolution"],
            res, penalty,
        )
        response, x, y, t = fine[:4]
        th = fine[7]
    else:
        response, x, y, t = coarse[:4]
        th = 4 * cfg["coarse_angle_resolution"]
    xx, yy, xy = coarse[4], coarse[5], coarse[6]
    covar = np.array([[xx, xy, 0], [xy, yy, 0], [0, 0, th]])
    return response, (x, y, t), covar, cgrid

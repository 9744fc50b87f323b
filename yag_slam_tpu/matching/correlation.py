"""Correlation-grid scan matching: the numeric core, as batched XLA programs.

Behavioral spec: the reference's numba kernels
(/root/reference/yag_slam/helpers.py — `calculate_kernel`:87-97,
`add_scan_to_grid`:123-131, `score_grid_points_on_grid`:135-146,
`find_best_pose`:156-295, `validate_points`:298-329, `world_to_grid`:81-83).
This module reproduces their *semantics* (banker's rounding into grid cells,
int-truncated 100x scoring, tie-averaged argmax within 1e-8, windowed
covariance with the reference's half-open windows) but is architected for
an accelerator rather than translated:

- The whole (x, y, theta) candidate lattice is scored in one batched
  program (gathers + reductions) instead of a `prange` triple loop.
- The Gaussian "max smear" grid build exploits that the kernel is a product
  of two monotone 1-D factors, so max-compositing the 2-D kernel around
  every occupied cell equals two separable 1-D weighted max-dilations —
  O(K) passes over the grid instead of scattering K^2 cells per point.
- The sequential back-facing-surface filter (`validate_points`) is split:
  run segmentation depends only on inter-point distances, which are
  rigid-invariant, so it is computed once per scan on the host
  (:func:`segment_validation_runs`) and the per-match, viewpoint-dependent
  part reduces to one vectorized cross-product side test on device
  (:func:`keep_mask_for_viewpoint`).

All device functions take a `dtype` (float32 on the GPU; tests run float64
on CPU to pin down golden agreement with the float64 oracle).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Smear kernel
# ---------------------------------------------------------------------------

def kernel_half_size(res: float, smear_deviation: float) -> int:
    """Half-width of the smear kernel; full size = 4*round(smear/res)+1
    (/root/reference/yag_slam/helpers.py:88)."""
    size = int(4 * np.round(smear_deviation / res) + 1)
    return size // 2


def gaussian_kernel_1d(res: float, smear_deviation: float) -> np.ndarray:
    """1-D factor of the separable smear kernel.

    The reference's 2-D kernel is exp(-0.5*((i*res)^2+(j*res)^2)/sigma^2)
    (/root/reference/yag_slam/helpers.py:87-97), which factorizes exactly as
    k1[i]*k1[j].
    """
    h = kernel_half_size(res, smear_deviation)
    offs = (np.arange(2 * h + 1) - h) * res
    return np.exp(-0.5 * offs**2 / smear_deviation**2)


def gaussian_kernel_2d(res: float, smear_deviation: float) -> np.ndarray:
    k1 = gaussian_kernel_1d(res, smear_deviation)
    return np.outer(k1, k1)


# ---------------------------------------------------------------------------
# Point validation (back-facing surface filter)
# ---------------------------------------------------------------------------

def segment_validation_runs(px, py, n):
    """Host-side, pose-independent half of the reference's `validate_points`
    (/root/reference/yag_slam/helpers.py:298-329).

    The reference walks the beam points in order, grouping them into runs
    that end when the current point moves >0.2 m from the run's anchor; the
    run is kept iff the side test of (terminal - anchor) x (viewpoint -
    anchor) is positive.  Run boundaries depend only on pairwise point
    distances — invariant under the scan's rigid pose — so we segment once
    per scan here and leave only the side test for the device.

    Returns per-point arrays over the first `n` (compacted) points:
      anchor_idx, term_idx : int32 — run anchor/terminal point indices
      has_run              : bool  — point belongs to a flushed run
    Point 0 and any trailing unflushed run have has_run=False (the reference
    never emits them).
    """
    from yag_slam_tpu import native

    if native.available():
        return native.segment_runs(px, py, n)
    anchor = np.zeros(n, dtype=np.int32)
    term = np.zeros(n, dtype=np.int32)
    has = np.zeros(n, dtype=bool)
    if n < 2:
        return anchor, term, has
    msd = 0.2**2
    fp = 0
    run_start = 1
    for i in range(1, n):
        if (px[fp] - px[i]) ** 2 + (py[fp] - py[i]) ** 2 > msd:
            anchor[run_start : i + 1] = fp
            term[run_start : i + 1] = i
            has[run_start : i + 1] = True
            fp = i
            run_start = i + 1
    return anchor, term, has


def keep_mask_for_viewpoint(
    wx, wy, anchor_idx, term_idx, has_run, valid, vx, vy
):
    """Device-side half of `validate_points`: per-point keep decision.

    `wx, wy` are the scan's points in *world* frame (..., P); anchor/term
    index into the same point axis.  A point is kept iff its run was flushed
    and cross(term - anchor, viewpoint - anchor) > 0 — algebraically equal
    to the reference's line-side test `ss > 0`
    (/root/reference/yag_slam/helpers.py:317-324).
    """
    ax = jnp.take_along_axis(wx, anchor_idx, axis=-1)
    ay = jnp.take_along_axis(wy, anchor_idx, axis=-1)
    tx = jnp.take_along_axis(wx, term_idx, axis=-1)
    ty = jnp.take_along_axis(wy, term_idx, axis=-1)
    ss = (tx - ax) * (vy - ay) - (ty - ay) * (vx - ax)
    return has_run & valid & (ss > 0.0)


# ---------------------------------------------------------------------------
# Correlation grid build
# ---------------------------------------------------------------------------

def world_to_grid_idx(w, origin, res):
    """Banker's-rounded cell index, matching the reference's
    np.round-then-int (/root/reference/yag_slam/helpers.py:81-83 and the
    int32 cast at /root/reference/yag_slam/scan_matching.py:196-198)."""
    return jnp.round((w - origin) / res).astype(jnp.int32)


def build_correlation_grid(
    wx, wy, keep, ox, oy, *, grid_size: int, res: float, k1: np.ndarray, dtype
):
    """Build the smeared correlation grid from kept world points.

    Semantics match `add_scan_to_grid` (/root/reference/yag_slam/helpers.py:
    123-131): points whose center cell is out of bounds are dropped whole;
    in-bounds points composite the kernel by max, clipped at the borders.

    Implementation: scatter point indicators, then two separable weighted
    max-dilation passes (see module docstring).
    """
    G = grid_size
    gx = world_to_grid_idx(wx.ravel(), ox, res)
    gy = world_to_grid_idx(wy.ravel(), oy, res)
    inb = (gx >= 0) & (gx < G) & (gy >= 0) & (gy < G) & keep.ravel()
    lin = jnp.where(inb, gy * G + gx, G * G)
    occ = (
        jnp.zeros(G * G + 1, dtype=dtype)
        .at[lin]
        .max(jnp.ones_like(lin, dtype=dtype))[: G * G]
        .reshape(G, G)
    )

    k = jnp.asarray(k1, dtype=dtype)
    h = (len(k1) - 1) // 2

    def dilate_last_axis(a):
        pad = [(0, 0)] * (a.ndim - 1) + [(h, h)]
        ap = jnp.pad(a, pad)
        out = None
        for d in range(2 * h + 1):
            shifted = jax.lax.slice_in_dim(ap, d, d + a.shape[-1], axis=a.ndim - 1)
            term = k[d] * shifted
            out = term if out is None else jnp.maximum(out, term)
        return out

    cgrid = dilate_last_axis(occ)          # smear along x (columns)
    cgrid = dilate_last_axis(cgrid.T).T    # smear along y (rows)
    return cgrid


def quantize_grid(cgrid):
    """floor(100 * value): the reference scores with int-truncated 100x grid
    lookups (/root/reference/yag_slam/helpers.py:143-144).  Values are
    non-negative so trunc == floor; precomputing it once makes every lattice
    gather exact and cheap."""
    return jnp.floor(cgrid * 100.0)


# ---------------------------------------------------------------------------
# Batched subgrid build
#
# The full correlation grid is G^2 cells with G = search/res + 1 + 2*range/res
# (4051^2 = 65 MB at the reference's defaults) but occupied cells only exist
# where base-scan points land.  Because out-of-subgrid cells are provably
# zero, building and scoring against a tight subgrid that covers the
# occupied bounding box (+ smear halo) is *exact* — the host picks the
# subgrid origin (sox, soy) and a bucketed static size S per match.
# ---------------------------------------------------------------------------

def build_occupancy_padded(wx, wy, keep, ox, oy, sox, soy, *, G, S, h, res,
                           dtype):
    """Scatter occupied indicators into a halo-padded batched subgrid.

    wx, wy, keep: (N, B, P) world points + keep mask; ox, oy, sox, soy: (N,).
    Returns (N, S + 2h, S + 2h) with subgrid cell (r, c) at (r + h, c + h).
    Points outside the *full* grid are dropped (reference semantics:
    reference yag_slam/helpers.py:123-131); points outside the
    padded subgrid are more than h cells from every subgrid cell, so their
    smear cannot reach it and dropping them is exact.
    """
    N = wx.shape[0]
    W = S + 2 * h
    gx = world_to_grid_idx(wx, ox[:, None, None], res)
    gy = world_to_grid_idx(wy, oy[:, None, None], res)
    inb = (gx >= 0) & (gx < G) & (gy >= 0) & (gy < G) & keep
    sx = gx - sox[:, None, None] + h
    sy = gy - soy[:, None, None] + h
    ins = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < W)
    plane = W * W
    b_idx = jnp.arange(N, dtype=jnp.int32)[:, None, None]
    lin = jnp.where(inb & ins, b_idx * plane + sy * W + sx, N * plane)
    occ = (
        jnp.zeros(N * plane + 1, dtype=dtype)
        .at[lin.ravel()]
        .max(jnp.ones(lin.size, dtype=dtype))
    )
    return occ[: N * plane].reshape(N, W, W)


def smear_grid(occ_padded, *, h: int, S: int, taps: tuple):
    """Separable weighted max-dilation of a halo-padded occupancy batch:
    (N, S + 2h, S + 2h) -> (N, S, S), a shifted-max chain along columns,
    then along rows."""
    k = jnp.asarray(np.array(taps), dtype=occ_padded.dtype)
    acc = None
    for d in range(2 * h + 1):
        t = k[d] * jax.lax.slice_in_dim(occ_padded, d, d + S, axis=2)
        acc = t if acc is None else jnp.maximum(acc, t)
    out = None
    for d in range(2 * h + 1):
        t = k[d] * jax.lax.slice_in_dim(acc, d, d + S, axis=1)
        out = t if out is None else jnp.maximum(out, t)
    return out


def mask_past_grid(q, sox, soy, G):
    """Zero subgrid cells whose full-grid index is >= G.

    When a job's subgrid overhangs the full grid's high edge (S > G, or
    sox + S > G in a mixed-size batch), smear spreads in-grid occupancy
    into cells the reference's bounds check never reads
    (reference yag_slam/helpers.py:139-142).  The element scorer
    masks those reads per gather; the window scorer reads the grid raw, so
    the build zeroes them once.  The low edge needs no mask (sox, soy >=
    0)."""
    lane = jnp.arange(q.shape[-1], dtype=jnp.int32)
    col_ok = (lane[None, :] + sox[:, None]) < G
    row_ok = (lane[None, :] + soy[:, None]) < G
    return q * (row_ok[:, :, None] & col_ok[:, None, :]).astype(q.dtype)


def build_quantized_subgrids(wx, wy, keep, ox, oy, sox, soy, *, G, S, h, res,
                             taps, dtype):
    """The batched grid build: scatter -> separable max-smear ->
    floor(100 x) -> full-grid bounds mask.  Returns (quantized (N, S, S),
    smeared (N, S, S)); the unquantized grid only survives when a caller
    keeps it (the opt-in meta path)."""
    occ = build_occupancy_padded(wx, wy, keep, ox, oy, sox, soy,
                                 G=G, S=S, h=h, res=res, dtype=dtype)
    cgrid = smear_grid(occ, h=h, S=S, taps=taps)
    return mask_past_grid(quantize_grid(cgrid), sox, soy, G), cgrid


# ---------------------------------------------------------------------------
# Candidate-lattice scoring + best-pose reduction
# ---------------------------------------------------------------------------

class LatticeSpec(NamedTuple):
    """Static lattice dimensions (candidate counts) for one search pass."""

    nx: int
    ny: int
    nt: int

    @classmethod
    def from_search(cls, cx, cy, ct, xy_size, xy_res, ang_size, ang_res):
        # np.arange length semantics (the reference builds candidate arrays
        # with np.arange at /root/reference/yag_slam/helpers.py:177-179).
        nx = len(np.arange(-xy_size + cx, xy_size + cx, xy_res))
        ny = len(np.arange(-xy_size + cy, xy_size + cy, xy_res))
        nt = len(np.arange(-ang_size + ct, ang_size + ct, ang_res))
        return cls(nx, ny, nt)


def score_lattice(
    qgrid_flat,
    pts_x,
    pts_y,
    n_pts,
    cx,
    cy,
    ct,
    ox,
    oy,
    *,
    spec: LatticeSpec,
    xy_size: float,
    xy_res: float,
    ang_size: float,
    ang_res: float,
    grid_size: int,
    grid_res: float,
    penalize: bool,
    dtype,
    dist_var_penalty: float = 0.5,
    ang_var_penalty: float = 1.0,
    karto_penalties: tuple | None = None,
    symmetric: bool = True,
    sub_size: int | None = None,
    sox=0,
    soy=0,
):
    """Score the full candidate lattice.

    Reproduces the response formula of `find_best_pose`
    (/root/reference/yag_slam/helpers.py:191-212): per candidate pose the
    query points are rotated, offset, snapped to cells, looked up with
    int-truncated 100x scaling, summed, normalized by the query point count
    and scaled by the (possibly negative — the reference comments out the
    clamps) distance/angle penalties.

    Returns (out, xvals, yvals, tvals) with out shaped (nx, ny, nt).
    """
    NX, NY, NT = spec
    G = grid_size

    xvals = (cx - xy_size) + jnp.arange(NX, dtype=dtype) * xy_res
    yvals = (cy - xy_size) + jnp.arange(NY, dtype=dtype) * xy_res
    tvals = (ct - ang_size) + jnp.arange(NT, dtype=dtype) * ang_res

    c, s = jnp.cos(tvals), jnp.sin(tvals)
    rx = c[:, None] * pts_x[None, :] - s[:, None] * pts_y[None, :]  # (NT, P)
    ry = s[:, None] * pts_x[None, :] + c[:, None] * pts_y[None, :]

    # Cell index depends on (offset + rotated point) jointly (the reference
    # rounds the summed world coordinate), so build the two index factors on
    # their own axes: gx over (NX, NT, P), gy over (NY, NT, P).
    gx = world_to_grid_idx(xvals[:, None, None] + rx[None], ox, grid_res)
    gy = world_to_grid_idx(yvals[:, None, None] + ry[None], oy, grid_res)

    # Full-grid bounds define the reference's scoring semantics; the
    # subgrid (when smaller) merely stores the only cells that can be
    # nonzero, so gathers outside it legitimately read 0.
    S = G if sub_size is None else sub_size
    sgx = gx - sox
    sgy = gy - soy
    ok_x = (gx >= 0) & (gx < G) & (sgx >= 0) & (sgx < S)
    ok_y = (gy >= 0) & (gy < G) & (sgy >= 0) & (sgy < S)

    # (NX, NY, NT, P) linear indices; out-of-bounds -> sentinel slot holding 0.
    lin = sgy[None, :, :, :] * S + sgx[:, None, :, :]
    lin = jnp.where(ok_x[:, None] & ok_y[None, :], lin, S * S)
    vals = jnp.take(qgrid_flat, lin, mode="clip")
    raw = jnp.sum(vals, axis=-1)  # (NX, NY, NT) — integer-valued floats

    if penalize and karto_penalties is not None:
        # OpenKarto C++ semantics (see _lattice_penalty): search-center
        # offsets, direct variances, clamped minimums.
        dv, av, md, ma = karto_penalties
        sqd = (xvals[:, None] - cx) ** 2 + (yvals[None, :] - cy) ** 2
        dist_pen = jnp.maximum(1.0 - 0.2 * sqd / dv, md)
        sqa = (tvals - ct) ** 2
        ang_pen = jnp.maximum(1.0 - 0.2 * sqa / av, ma)
        penalty = dist_pen[:, :, None] * ang_pen[None, None, :]
    elif penalize:
        if symmetric:
            # Grid center in world coords; the reference uses shape*res/2,
            # half a cell past the true center (helpers.py:173-174) —
            # preserved.
            sx = ox + G * grid_res / 2.0
            sy = oy + G * grid_res / 2.0
        else:
            # `find_best_pose_non_symmetric` centers the distance penalty on
            # the search center instead (helpers.py:450-452).
            sx, sy = cx, cy
        sqd = (xvals[:, None] - sx) ** 2 + (yvals[None, :] - sy) ** 2
        dist_pen = 1.0 - 0.2 * sqd / (dist_var_penalty * grid_res)
        sqa = (tvals - ct) ** 2
        ang_pen = 1.0 - 0.2 * sqa / (ang_var_penalty * grid_res)
        penalty = dist_pen[:, :, None] * ang_pen[None, None, :]
    else:
        penalty = jnp.ones((), dtype=dtype)

    out = raw / n_pts * penalty / 100.0
    return out, xvals, yvals, tvals


def score_lattice_batched(
    qgrid2d,     # (N, S, S) quantized subgrids
    pts_x,       # (N, P)
    pts_y,
    n_pts,       # (N,)
    cx, cy, ct,  # (N,)
    ox, oy,      # (N,)
    sox, soy,    # (N,)
    *,
    spec: LatticeSpec,
    xy_size, xy_res, ang_size, ang_res,
    grid_size: int,
    grid_res: float,
    sub_size: int,
    penalize: bool,
    dtype,
    dist_var_penalty: float = 0.5,
    ang_var_penalty: float = 1.0,
    karto_penalties: tuple | None = None,
):
    """Natively batched lattice scoring.

    Same semantics as :func:`score_lattice` with a leading job axis; the
    grid lookup is ONE flat gather with globally-offset indices into the
    stacked per-job grids, and reads outside a job's subgrid or the full
    grid take an out-of-range index that the gather fills with 0.

    Returns (out, xvals, yvals, tvals) with leading job axis.
    """
    NX, NY, NT = spec
    N, S, _ = qgrid2d.shape
    assert S == sub_size, (S, sub_size)
    G = grid_size

    ar_x = jnp.arange(NX, dtype=dtype)
    xvals = (cx - xy_size)[:, None] + ar_x[None, :] * xy_res           # (N, NX)
    yvals = (cy - xy_size)[:, None] + jnp.arange(NY, dtype=dtype)[None] * xy_res
    tvals = (ct - ang_size)[:, None] + jnp.arange(NT, dtype=dtype)[None] * ang_res

    c, s = jnp.cos(tvals), jnp.sin(tvals)                               # (N, NT)
    rx = c[:, :, None] * pts_x[:, None, :] - s[:, :, None] * pts_y[:, None, :]
    ry = s[:, :, None] * pts_x[:, None, :] + c[:, :, None] * pts_y[:, None, :]

    gx = world_to_grid_idx(
        xvals[:, :, None, None] + rx[:, None, :, :], ox[:, None, None, None],
        grid_res,
    )  # (N, NX, NT, P)
    gy = world_to_grid_idx(
        yvals[:, :, None, None] + ry[:, None, :, :], oy[:, None, None, None],
        grid_res,
    )  # (N, NY, NT, P)

    sgx = gx - sox[:, None, None, None]
    sgy = gy - soy[:, None, None, None]
    ok_x = (gx >= 0) & (gx < G) & (sgx >= 0) & (sgx < S)
    ok_y = (gy >= 0) & (gy < G) & (sgy >= 0) & (sgy < S)

    base = (jnp.arange(N, dtype=jnp.int32) * (S * S))[:, None, None, None,
                                                      None]
    lin = jnp.where(
        ok_x[:, :, None] & ok_y[:, None, :],
        sgy[:, None, :, :, :] * S + sgx[:, :, None, :, :] + base,
        N * S * S,
    )  # (N, NX, NY, NT, P)
    vals = jnp.take(qgrid2d.reshape(-1), lin, mode="fill", fill_value=0)
    raw = jnp.sum(vals, axis=-1)  # (N, NX, NY, NT)

    if penalize:
        penalty = _lattice_penalty(
            xvals, yvals, tvals, ct, ox, oy, grid_size=G, grid_res=grid_res,
            dist_var_penalty=dist_var_penalty,
            ang_var_penalty=ang_var_penalty, karto=karto_penalties, cx=cx, cy=cy,
        )
    else:
        penalty = jnp.ones((), dtype=dtype)

    out = raw / n_pts[:, None, None, None] * penalty / 100.0
    return out, xvals, yvals, tvals


def _lattice_penalty(xvals, yvals, tvals, ct, ox, oy, *, grid_size, grid_res,
                     dist_var_penalty, ang_var_penalty, karto=None,
                     cx=None, cy=None):
    """Batched distance/angle penalty factor (N, NX, NY, NT).

    Default: the reference's unclamped penalty
    (/root/reference/yag_slam/helpers.py:191-212; clamps commented out
    there, so values can go negative), centered half a cell past the true
    grid center (shape*res/2 quirk, helpers.py:173-174).

    karto=(dist_var, ang_var, min_dist, min_ang): OpenKarto's C++ matcher
    semantics instead (Mapper.cpp ScanMatcher::CorrelateScan; opted into
    via ScanMatcherConfig.use_karto_penalties) — offsets from the SEARCH
    CENTER, the variance values consumed directly (no grid-res division),
    clamped at the minimum penalties."""
    G = grid_size
    if karto is not None:
        # OpenKarto measures the distance offset from the pass's SEARCH
        # CENTER (rSearchCenter) — the coarse pass centers on the
        # odometry prediction but the FINE pass centers on the coarse
        # best pose, so the caller must pass the pass's (cx, cy); the
        # grid origin is NOT a valid substitute for the fine pass.
        assert cx is not None and cy is not None, (
            "karto penalties need the pass's search center"
        )
        dv, av, md, ma = karto
        sx = jnp.asarray(cx)
        sy = jnp.asarray(cy)
        sqd = (xvals[:, :, None] - sx[:, None, None]) ** 2 + (
            yvals[:, None, :] - sy[:, None, None]
        ) ** 2
        dist_pen = jnp.maximum(1.0 - 0.2 * sqd / dv, md)
        sqa = (tvals - ct[:, None]) ** 2
        ang_pen = jnp.maximum(1.0 - 0.2 * sqa / av, ma)
        return dist_pen[:, :, :, None] * ang_pen[:, None, None, :]
    sx = ox + G * grid_res / 2.0
    sy = oy + G * grid_res / 2.0
    sqd = (xvals[:, :, None] - sx[:, None, None]) ** 2 + (
        yvals[:, None, :] - sy[:, None, None]
    ) ** 2
    dist_pen = 1.0 - 0.2 * sqd / (dist_var_penalty * grid_res)
    sqa = (tvals - ct[:, None]) ** 2
    ang_pen = 1.0 - 0.2 * sqa / (ang_var_penalty * grid_res)
    return dist_pen[:, :, :, None] * ang_pen[:, None, None, :]


def score_lattice_patch_batched(
    qgrid2d,     # (N, S, S) quantized subgrids
    pts_x,       # (N, P)
    pts_y,
    n_pts,       # (N,)
    cx, cy, ct,  # (N,)
    ox, oy,      # (N,)
    sox, soy,    # (N,)
    *,
    spec: LatticeSpec,
    xy_size, xy_res, ang_size, ang_res,
    grid_size: int,
    grid_res: float,
    sub_size: int,
    penalize: bool,
    dtype,
    dist_var_penalty: float = 0.5,
    ang_var_penalty: float = 1.0,
    karto_penalties: tuple | None = None,
):
    """Lattice scoring via per-point window gathers.

    Same response formula as :func:`score_lattice_batched`, restructured
    around contiguous reads: instead of one (N,NX,NY,NT,P) element gather
    this gathers ONE contiguous (WINY, WINX) window per (job, theta,
    point) — the grid cells a point can touch across the whole xy lattice
    — then reduces over points and subsamples the lattice stride.

    Exactness notes:

    - The gather path rounds the world coordinate independently per
      lattice column; this path rounds once per point at the lattice
      origin and walks cells by the exact integer stride
      (xy_res/grid_res, required integral).  The two agree except when
      an exact half-cell coordinate makes `round((x + i*xy_res)/res)`
      land on the other side of banker's rounding than
      `round(x/res) + i*stride` — a measure-zero event on real data,
      but when it fires the two paths disagree by a full cell (one
      column of point reads shifts), not an ulp.  There is no
      counterpart bias; the reference itself recomputes in float64
      where the same boundary sits elsewhere.
    - Reads below/past the *subgrid* contribute exactly 0 via zero
      padding (cells outside the subgrid are provably zero).
      PRECONDITION: cells whose *full-grid* index is >= grid_size must
      already be zero in `qgrid2d` — smear can populate them when the
      subgrid overhangs the grid's high edge, and unlike the element
      path this function has no per-read (gx < G) mask.  The matcher
      zeroes them at q2d build.
    - Memory: the window gather produces a logical
      (N, NT, P, WINY, WINX) intermediate that XLA fuses into the
      point-sum reduction; peak memory relies on that fusion.  If a backend/shape combo
      ever breaks the fusion the fix is chunking the point axis
      (lax.map over P blocks), not a smaller window.
    """
    NX, NY, NT = spec
    N, S, _ = qgrid2d.shape
    G = grid_size
    stride = int(round(xy_res / grid_res))
    assert abs(stride * grid_res - xy_res) < 1e-12 * max(1.0, abs(xy_res)), (
        xy_res, grid_res)
    WINX = stride * (NX - 1) + 1
    WINY = stride * (NY - 1) + 1
    PADT = max(WINY, WINX)          # top/left margin (negative base cells)
    PADB = 2 * max(WINY, WINX)      # bottom/right zeros (overflow + clamp)

    ar_x = jnp.arange(NX, dtype=dtype)
    xvals = (cx - xy_size)[:, None] + ar_x[None, :] * xy_res
    yvals = (cy - xy_size)[:, None] + jnp.arange(NY, dtype=dtype)[None] * xy_res
    tvals = (ct - ang_size)[:, None] + jnp.arange(NT, dtype=dtype)[None] * ang_res

    c, s = jnp.cos(tvals), jnp.sin(tvals)                       # (N, NT)
    rx = c[:, :, None] * pts_x[:, None, :] - s[:, :, None] * pts_y[:, None, :]
    ry = s[:, :, None] * pts_x[:, None, :] + c[:, :, None] * pts_y[:, None, :]

    gx0 = world_to_grid_idx(
        xvals[:, 0, None, None] + rx, ox[:, None, None], grid_res
    )  # (N, NT, P) — cell at lattice origin; column i reads gx0 + stride*i
    gy0 = world_to_grid_idx(
        yvals[:, 0, None, None] + ry, oy[:, None, None], grid_res
    )
    sgx0 = gx0 - sox[:, None, None]
    sgy0 = gy0 - soy[:, None, None]

    rows = S + PADT + PADB
    gpad = jnp.zeros((N, rows, rows), dtype=qgrid2d.dtype)
    gpad = jax.lax.dynamic_update_slice(gpad, qgrid2d, (0, PADT, PADT))

    # Window starts; fully-out-of-range points are pointed at the zero
    # region (mode="clip" then keeps them there).  Clip first so padded
    # _FAR lanes (whose cell index saturates int32) can't overflow the
    # `+ PADT` arithmetic.
    sgy0 = jnp.clip(sgy0, -PADT - 1, S + 1)
    sgx0 = jnp.clip(sgx0, -PADT - 1, S + 1)
    ry_start = jnp.where(sgy0 < -PADT, rows, sgy0 + PADT)
    rx_start = jnp.where(sgx0 < -PADT, rows, sgx0 + PADT)
    nn = jnp.broadcast_to(
        jnp.arange(N, dtype=jnp.int32)[:, None, None], ry_start.shape
    )
    starts = jnp.stack(
        [nn, ry_start.astype(jnp.int32), rx_start.astype(jnp.int32)], axis=-1
    ).reshape(-1, 3)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1, 2), collapsed_slice_dims=(0,), start_index_map=(0, 1, 2)
    )
    patches = jax.lax.gather(
        gpad, starts, dn, slice_sizes=(1, WINY, WINX), mode="clip"
    ).reshape(N, NT, -1, WINY, WINX)
    ps = jnp.sum(patches, axis=2)                 # (N, NT, WINY, WINX)
    raw = ps[:, :, ::stride, ::stride]            # (N, NT, NY, NX)
    raw = raw.transpose(0, 3, 2, 1)               # (N, NX, NY, NT)

    if penalize:
        penalty = _lattice_penalty(
            xvals, yvals, tvals, ct, ox, oy, grid_size=G, grid_res=grid_res,
            dist_var_penalty=dist_var_penalty, ang_var_penalty=ang_var_penalty,
            karto=karto_penalties, cx=cx, cy=cy,
        )
    else:
        penalty = jnp.ones((), dtype=dtype)

    out = raw.astype(dtype) / n_pts[:, None, None, None] * penalty / 100.0
    return out, xvals, yvals, tvals


def reduce_best_pose(out, xvals, yvals, tvals):
    """Argmax + tie-averaging + windowed covariance, semantics of
    /root/reference/yag_slam/helpers.py:214-295.

    - first-maximum argmax in C order over (x, y, theta);
    - best pose = mean of all candidates within 1e-8 of the max response;
    - xy second moments over a [i-5, min(n-1, i+6)) x [j-5, ...) window at
      the argmax theta slice, normalized by window response mass and by the
      response (the reference's half-open, end-clipped windows are quirks we
      preserve);
    - theta second moment over the same style of window along theta at the
      argmax (i, j).

    Returns (response, bx, by, bt, XX, YY, XY, TH) — same 8-tuple as the
    reference kernel.
    """
    NX, NY, NT = out.shape
    flat = out.ravel()
    m = jnp.argmax(flat)
    ii = m // (NY * NT)
    jj = (m % (NY * NT)) // NT
    kk = m % NT
    # max-reduce, NOT flat[m]: semantically identical (the argmax element
    # is the max; `out` is NaN-free by construction), but the dynamic
    # gather at the argmax index miscompiled on XLA:CPU inside the large
    # fused f32 match program (observed: flat[m] fed a tie-comparison that
    # came back empty -> 0/0 -> NaN response), while the plain reduction
    # is robust and cheaper.
    response = jnp.max(flat)

    ties = out >= response - 1e-8
    nties = jnp.sum(ties)
    bx = jnp.sum(jnp.where(ties, xvals[:, None, None], 0.0)) / nties
    by = jnp.sum(jnp.where(ties, yvals[None, :, None], 0.0)) / nties
    bt = jnp.sum(jnp.where(ties, tvals[None, None, :], 0.0)) / nties

    ar_i = jnp.arange(NX)
    ar_j = jnp.arange(NY)
    ar_k = jnp.arange(NT)

    mask_i = (ar_i >= jnp.maximum(0, ii - 5)) & (ar_i < jnp.minimum(NX - 1, ii + 6))
    mask_j = (ar_j >= jnp.maximum(0, jj - 5)) & (ar_j < jnp.minimum(NY - 1, jj + 6))
    mask_ij = mask_i[:, None] & mask_j[None, :]

    slice_k = jnp.take(out, kk, axis=2)  # (NX, NY) responses at argmax theta
    norm = jnp.sum(jnp.where(mask_ij, slice_k, 0.0))
    dx = xvals[:, None] - bx
    dy = yvals[None, :] - by
    XX = jnp.sum(jnp.where(mask_ij, slice_k * dx**2, 0.0))
    YY = jnp.sum(jnp.where(mask_ij, slice_k * dy**2, 0.0))
    XY = jnp.sum(jnp.where(mask_ij, slice_k * dx * dy, 0.0))

    mask_k = (ar_k >= jnp.maximum(0, kk - 5)) & (ar_k < jnp.minimum(NT - 1, kk + 6))
    slice_ij = out[ii, jj, :]
    th_norm = jnp.sum(jnp.where(mask_k, slice_ij, 0.0))
    TH = jnp.sum(jnp.where(mask_k, slice_ij * (tvals - bt) ** 2, 0.0))

    return (
        response,
        bx,
        by,
        bt,
        XX / norm / response,
        YY / norm / response,
        XY / norm / response,
        TH / th_norm,
    )


def find_best_pose(
    qgrid_flat, pts_x, pts_y, n_pts, cx, cy, ct, ox, oy, *,
    spec, xy_size, xy_res, ang_size, ang_res, grid_size, grid_res,
    penalize, dtype, symmetric=True, sub_size=None, sox=0, soy=0,
    karto_penalties=None,
):
    """One full search pass: lattice scoring + best-pose reduction.

    Device analog of /root/reference/yag_slam/helpers.py:156-295
    (symmetric=True: penalty centered on the grid center) and :434-573
    (symmetric=False: penalty centered on the search center).
    """
    out, xv, yv, tv = score_lattice(
        qgrid_flat, pts_x, pts_y, n_pts, cx, cy, ct, ox, oy,
        spec=spec, xy_size=xy_size, xy_res=xy_res, ang_size=ang_size,
        ang_res=ang_res, grid_size=grid_size, grid_res=grid_res,
        penalize=penalize, dtype=dtype, symmetric=symmetric,
        sub_size=sub_size, sox=sox, soy=soy,
        karto_penalties=karto_penalties,
    )
    return reduce_best_pose(out, xv, yv, tv)

"""Correlative scan matcher driver.

Public surface mirrors what the reference exposes through both of its
matchers (`Scan2DMatcherCpp` / `Scan2DMatcherPy`,
/root/reference/yag_slam/scan_matching.py:32-224): construction from a
config dict (+ `loop=` preset), `match_scan(query, base_scans, penalty,
do_fine) -> ScanMatcherResult(response, covariance, best_pose, meta)`, and
the scan-set variants used for submap alignment.

Architecture (deliberately different from the reference's per-call C++
marshalling):

- a **device-resident scan library** holds every scan's matcher view
  (compacted beam endpoints + validation-run structure) in preallocated
  (K, P) arrays, uploaded once per scan.  A match dispatch carries only
  slot indices, poses and the search center — kilobytes — and gathers the
  views on device.  This keeps host->device traffic independent of how
  many matches reference a scan (the sliding window re-reads each scan
  ~buffer-length times; loop closures far more);
- the host computes a tight, bucketed **subgrid** around the occupied
  bounding box each match.  Cells outside it are provably zero, so
  building and scoring against the subgrid is exact while shrinking the
  reference's G^2 grid (65 MB at default config) to the occupied extent;
- grid build + Gaussian max-smear + coarse + fine search run as one
  jitted batch-first program: `match_scan` is the N=1 case, `match_many`
  scores independent job batches per dispatch (the loop-closure / offline
  throughput path).
"""
from __future__ import annotations

import functools
import math
from collections import namedtuple

import numpy as np
import jax
import jax.numpy as jnp

from yag_slam_tpu.core.config import ScanMatcherConfig, make_config
from yag_slam_tpu.core.transform import Transform
from yag_slam_tpu.matching import correlation as C

ScanMatcherResult = namedtuple(
    "ScanMatcherResult", ["response", "covariance", "best_pose", "meta"]
)

# Far-away sentinel for padded/invalid point lanes: maps out of any grid, so
# the lane contributes exactly 0 to every score (the reference has no padded
# lanes; masked-out == absent).
_FAR = 1.0e9

# The fine pass's angular extent is a literal in the reference
# (/root/reference/yag_slam/scan_matching.py:210-212).
_FINE_ANGLE_SIZE = 0.0349 * 0.5

# Response expansion (README.md:40: retry with widened angle search when the
# response is 0); widening step chosen as 20 deg per retry, 3 retries, after
# OpenKarto's response-expansion schedule.
_EXPANSION_STEP = math.radians(20.0)
_EXPANSION_TRIES = 3

_VIEW_KEYS = ("lx", "ly", "anchor", "term", "has_run")

# Subgrid side buckets.  Each distinct S compiles its own program (cached),
# so buckets bound the number of programs; they are fine-grained because
# every grid stage scales with S^2 (the jump 1024 -> 2048 alone is 4x work
# for a 1025-cell span).
_SUB_BUCKETS = (512, 768, 1024, 1280, 1536, 1792, 2048, 2560, 3072, 4096,
                8192)

# Widest window (cells per side) the window-gather scorer takes: it reads
# (stride*(n-1)+1)^2 contiguous cells per (theta, point) where the element
# scorer reads n^2 scattered ones.
_PATCH_MAX_WINDOW = 64


def _pick_scorer(spec, stride):
    """Lattice scorer for one search pass, from its static shape:
    "element" (one gather per (pose, point), correlation.
    score_lattice_batched) or "patch" (one contiguous window gather per
    (theta, point), correlation.score_lattice_patch_batched).

    Measured on an H100 at 700 W (whole match programs, 16 jobs;
    PERF.md):
    strided coarse passes with 29- and 49-cell windows ran faster as
    window gathers (8.1 vs 9.0 ms, 9.5 vs 12.5 ms), the loop pass's
    79-cell window slower (9.1 vs 8.4 ms); the stride-1 fine pass reads as
    many cells either way and measured a tie, so it keeps the element
    path."""
    window = stride * (max(spec.nx, spec.ny) - 1) + 1
    if stride > 1 and window <= _PATCH_MAX_WINDOW:
        return "patch"
    return "element"


def sanitize_covariance(covar, cfg):
    """Guard against invalid match covariances.

    The reference's covariance formula normalizes second moments by a
    window-response sum that can legitimately go *negative* (the
    distance penalty is unclamped — the clamp is commented out at
    /root/reference/yag_slam/helpers.py:204,208 — so corner candidates
    score negative).  Near the sign boundary, backend-level float
    differences flip individual variances negative, and one indefinite
    information matrix corrupts the entire pose-graph solve.  When the
    covariance is non-finite or not positive definite we fall back to a
    conservative "know nothing inside the search window" prior, the
    same spirit as Karto's response-failure covariance.
    """
    xy_var = (0.5 * cfg.search_size) ** 2
    th_var = (0.5 * cfg.coarse_search_angle_offset) ** 2
    fallback_needed = not np.isfinite(covar).all()
    if not fallback_needed:
        xx, yy, xy, th = covar[0, 0], covar[1, 1], covar[0, 1], covar[2, 2]
        fallback_needed = (
            xx <= 0.0 or yy <= 0.0 or th <= 0.0 or xx * yy - xy * xy <= 0.0
        )
    if fallback_needed:
        return np.diag([xy_var, xy_var, th_var])
    return covar


def _next_bucket(n: int, quantum: int = 128) -> int:
    b = quantum
    while b < n:
        b *= 2
    return b


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def scan_matcher_view(scan, cap: int):
    """Cached, pose-independent host view of a scan: compacted local beam
    endpoints + validation-run structure (see
    correlation.segment_validation_runs)."""
    key = ("matcher_view", cap)
    if key not in scan._points_cache:
        lx, ly, n = scan.local_points_padded(cap)
        a, t, h = C.segment_validation_runs(lx, ly, n)
        anchor = np.zeros(cap, dtype=np.int32)
        term = np.zeros(cap, dtype=np.int32)
        has = np.zeros(cap, dtype=bool)
        anchor[:n], term[:n], has[:n] = a, t, h
        scan._points_cache[key] = dict(
            lx=lx, ly=ly, anchor=anchor, term=term, has_run=has, n=n
        )
    return scan._points_cache[key]


def _donated(argnums):
    # buffer donation is a no-op warning on the CPU backend (tests pin
    # jax_platforms=cpu); donate everywhere else
    return () if jax.default_backend() == "cpu" else argnums


@functools.lru_cache(maxsize=1)
def _library_insert_fn():
    # batched: `slots` (k,) int32, each rows[k] stacked along axis 0 — one
    # dispatch uploads any number of scans
    return jax.jit(
        lambda fields, rows, slots: {
            k: fields[k].at[slots].set(rows[k]) for k in fields
        },
        donate_argnums=_donated((0,)),
    )


def _library_insert(fields, rows, slots):
    return _library_insert_fn()(fields, rows, slots)


@functools.lru_cache(maxsize=1)
def _library_grow_fn():
    return jax.jit(
        lambda fields, new_cap_zeros: {
            k: new_cap_zeros[k].at[: fields[k].shape[0]].set(fields[k])
            for k in fields
        },
        donate_argnums=_donated((1,)),
    )


def _library_grow(fields, new_cap_zeros):
    return _library_grow_fn()(fields, new_cap_zeros)


class DeviceScanLibrary:
    """Device-resident store of scan matcher views: (K, P) arrays per
    field, index-addressed by match programs.

    Uploads are DEFERRED: `ensure` assigns slots immediately (host
    bookkeeping only) and queues the rows; the next read of `.fields`
    flushes every queued scan in ONE batched device dispatch, so a block
    of pushes costs one upload dispatch, not one per scan."""

    def __init__(self, dtype, initial_cap=128):
        self.dtype = dtype
        self.initial_cap = initial_cap
        self._fields = None
        self.P = 0
        self.K_cap = 0
        # slots are keyed by the identity of the scan's (shared) points
        # cache, so LocalizedRangeScan.copy() — e.g. loop-closure temp
        # scans — aliases the original's slot instead of re-uploading
        self._slots = {}
        self._scans = []  # strong refs keep identity keys unique
        self._pending = []  # (slot, scan) queued for the next flush

    @property
    def fields(self):
        """Device field dict, with any queued uploads flushed first (one
        batched dispatch)."""
        self.flush()
        return self._fields

    def _field_zeros(self, K, P):
        return dict(
            lx=jnp.zeros((K, P), dtype=self.dtype),
            ly=jnp.zeros((K, P), dtype=self.dtype),
            anchor=jnp.zeros((K, P), dtype=jnp.int32),
            term=jnp.zeros((K, P), dtype=jnp.int32),
            has_run=jnp.zeros((K, P), dtype=bool),
            n=jnp.zeros((K,), dtype=jnp.int32),
        )

    def _rebuild(self, P):
        """Point capacity changed: re-queue every stored scan at the new
        width (rare — P only grows on bigger sensors); the next flush
        re-uploads them all in one dispatch."""
        self.P = P
        self._fields = self._field_zeros(self.K_cap, P)
        self._pending = [
            (self._slots[id(s._points_cache)], s) for s in self._scans
        ]

    def _rows(self, scan):
        v = scan_matcher_view(scan, self.P)
        np_dtype = np.dtype(self.dtype)
        return dict(
            lx=v["lx"].astype(np_dtype),
            ly=v["ly"].astype(np_dtype),
            anchor=v["anchor"],
            term=v["term"],
            has_run=v["has_run"],
            n=np.int32(v["n"]),
        )

    def flush(self):
        """Upload every queued scan in one batched dispatch.  The batch
        is padded to a power-of-two count by repeating the last entry
        (duplicate scatter indices write identical rows, so the result is
        well-defined) — each distinct count is its own compiled insert
        program."""
        if not self._pending:
            return
        pending = self._pending
        self._pending = []
        k_pad = 1
        while k_pad < len(pending):
            k_pad *= 2
        pending = pending + [pending[-1]] * (k_pad - len(pending))
        rows = [self._rows(s) for _, s in pending]
        slots = np.asarray([sl for sl, _ in pending], dtype=np.int32)
        stacked = {
            k: np.stack([r[k] for r in rows]) for k in rows[0]
        }
        self._fields = _library_insert(self._fields, stacked, slots)

    def ensure(self, scans, P):
        """Make sure every scan has a slot at point-capacity P (rows are
        queued; the actual upload happens at the next `.fields` read);
        returns slot indices aligned with `scans`."""
        if self._fields is None:
            self.P = P
            self.K_cap = self.initial_cap
            self._fields = self._field_zeros(self.K_cap, P)
        elif P > self.P:
            # pending rows would be re-queued by _rebuild anyway (every
            # stored scan is) — drop them instead of uploading stale-width
            self._pending = []
            self._rebuild(P)

        out = []
        for s in scans:
            slot = self._slots.get(id(s._points_cache))
            if slot is None:
                slot = len(self._scans)
                if slot >= self.K_cap:
                    self.flush()  # grow donates the old fields
                    new_cap = self.K_cap * 2
                    self._fields = _library_grow(
                        self._fields, self._field_zeros(new_cap, self.P)
                    )
                    self.K_cap = new_cap
                self._slots[id(s._points_cache)] = slot
                self._scans.append(s)
                self._pending.append((slot, s))
            out.append(slot)
        return np.asarray(out, dtype=np.int32)


class _MatchHandle:
    """In-flight match dispatched by match_scan_async: `.result()` blocks
    on the device outputs (and runs response-expansion retries if the
    coarse response came back empty)."""

    __slots__ = ("_m", "_outs", "_args", "_P", "_B", "_penalty", "_do_fine",
                 "_S", "_res")

    def __init__(self, matcher, outs, args, P, B, penalty, do_fine, S):
        self._m = matcher
        self._outs = outs
        self._args = args
        self._P = P
        self._B = B
        self._penalty = penalty
        self._do_fine = do_fine
        self._S = S
        self._res = None

    def result(self):
        if self._res is None:
            self._res = self._m._finish(
                self._outs, self._args, self._P, self._B, self._penalty,
                self._do_fine, self._S,
            )
            self._outs = self._args = None
        return self._res


class _EmptyBatchHandle:
    """Trivial handle for an empty match_many_async batch."""

    __slots__ = ()

    def result(self):
        return []


class _MatchManyHandle:
    """In-flight batch dispatched by match_many_async: `.result()` blocks
    on the packed device output and assembles per-job results.  Jobs whose
    coarse response came back empty are retried TOGETHER — one widened
    dispatch over the whole empty subset per expansion attempt (the
    per-job match_scan fallback serialized a loop-closure burst in a
    low-overlap area into N sequential round trips)."""

    __slots__ = ("_m", "_outs", "_jobs", "_args", "_P", "_B", "_penalty",
                 "_do_fine", "_S", "_res")

    def __init__(self, matcher, outs, jobs, args, P, B, penalty, do_fine, S):
        self._m = matcher
        self._outs = outs
        self._jobs = jobs
        self._args = args
        self._P = P
        self._B = B
        self._penalty = penalty
        self._do_fine = do_fine
        self._S = S
        self._res = None

    def result(self):
        if self._res is None:
            m = self._m
            packed = np.asarray(self._outs[0])
            coarse, fine = packed[:, 0], packed[:, 1]
            # coarse-response trigger, as in match_scan
            need = [
                j for j in range(len(self._jobs))
                if float(coarse[j][0]) <= 0.0
                and m.config.use_response_expansion
            ]
            retried = (
                m._expansion_retries_many(
                    self._args, need, self._P, self._B, self._penalty,
                    self._do_fine, self._S,
                )
                if need
                else {}
            )
            centers = self._args[4]
            results = []
            for j in range(len(self._jobs)):
                c, f, off = retried.get(
                    j, (coarse[j], fine[j],
                        m.config.coarse_search_angle_offset)
                )
                results.append(m._assemble(c, f, self._do_fine, None,
                                           center=centers[j],
                                           coarse_offset=off))
            self._res = results
            self._outs = self._jobs = self._args = None
        return self._res


class CorrelativeScanMatcher:
    """Correlative scan matcher (coarse-to-fine, with response
    expansion) as batched device programs.

    DOCUMENTED DIVERGENCE: the reference always ships
    `meta={'grid', 'kernel'}` in every result
    (/root/reference/yag_slam/scan_matching.py:216-217) because its grid
    already lives in host memory.  Here the correlation grid is
    device-resident; shipping it per match is a 16-260 MB device->host
    transfer that would dominate the online latency this matcher exists to
    minimize, so `meta` is None unless the matcher is constructed with
    `return_meta=True` (then it carries the same {'grid', 'kernel'} dict).
    Nothing in the reference's own pipeline consumes `meta` — it is a
    debugging affordance, and the opt-in preserves it as exactly that."""

    def __init__(
        self,
        config_dict=None,
        loop: bool = False,
        *,
        config: ScanMatcherConfig | None = None,
        point_capacity: int | None = None,
        base_capacity: int | None = None,
        dtype=jnp.float32,
        return_meta: bool = False,
        sanitize_covariance: bool = True,
    ):
        self.config = config if config is not None else make_config(config_dict, loop)
        cfg = self.config
        # Grid side length, same formula as the reference
        # (/root/reference/yag_slam/scan_matching.py:183).
        self.grid_size = int(
            cfg.search_size / cfg.resolution
            + 1
            + 2 * cfg.range_threshold / cfg.resolution
        )
        self.dtype = dtype
        self.return_meta = return_meta
        self.sanitize_covariance = sanitize_covariance
        self._point_cap = point_capacity
        self._base_cap = base_capacity
        self._k1 = C.gaussian_kernel_1d(cfg.resolution, cfg.smear_deviation)
        self._half = (len(self._k1) - 1) // 2
        self._programs = {}
        self.library = DeviceScanLibrary(dtype)

    # -- capacity management ------------------------------------------------
    def _ensure_point_cap(self, scans) -> int:
        need = max(s.num_valid_beams for s in scans)
        if self._point_cap is None or self._point_cap < need:
            self._point_cap = _next_bucket(need)
        return self._point_cap

    def _base_bucket(self, n: int) -> int:
        if self._base_cap is not None:
            if n > self._base_cap:
                raise ValueError(f"{n} base scans > base_capacity {self._base_cap}")
            return self._base_cap
        b = 1
        while b < n:
            b *= 2
        return b

    # -- subgrid selection ----------------------------------------------------
    def _max_sub(self):
        return _round_up(self.grid_size, 128)

    @staticmethod
    def _scan_world_bbox(s, P):
        """World-frame bbox of a scan's kept points at its current
        corrected pose.  Cached per (pose, P) on the scan's shared points
        cache — poses only change on graph optimization, so the sliding
        window re-reads each scan's bbox ~buffer-length times per upload
        (the per-match bbox recompute was measurable on the online
        path)."""
        p = s.corrected_pose
        t = p.euler[-1]
        key = ("wbbox", P, p.x, p.y, t)
        cache = s._points_cache
        hit = cache.get(key)
        if hit is None:
            v = scan_matcher_view(s, P)
            c, sn = np.cos(t), np.sin(t)
            wx = p.x + c * v["lx"] - sn * v["ly"]
            wy = p.y + sn * v["lx"] + c * v["ly"]
            hit = (wx.min(), wx.max(), wy.min(), wy.max())
            # one live pose per scan: drop stale bbox entries
            for k in [k for k in cache if k[0] == "wbbox" and k != key]:
                del cache[k]
            cache[key] = hit
        return hit

    def _subgrid_for(self, base_scans, center_x, center_y, P,
                     margin_cells: int = 0):
        """Host-side: tight occupied-bbox subgrid (origin + size bucket).

        Exact: every base point inside the full grid lands inside the
        subgrid (+ smear halo), so all other cells are zero.
        `margin_cells` widens the box on every side — used by the chained
        online pipeline, whose host-side pose estimates can lag the
        device truth by a bounded number of cells.
        """
        cfg = self.config
        res = cfg.resolution
        G = self.grid_size
        h = self._half
        ox = center_x - 0.5 * (G - 1) * res
        oy = center_y - 0.5 * (G - 1) * res

        minx = miny = np.inf
        maxx = maxy = -np.inf
        for s in base_scans:
            x0, x1, y0, y1 = self._scan_world_bbox(s, P)
            minx = min(minx, x0)
            maxx = max(maxx, x1)
            miny = min(miny, y0)
            maxy = max(maxy, y1)

        mc = int(margin_cells)
        gminx = int(np.clip(np.floor((minx - ox) / res) - 1 - mc, 0, G - 1))
        gmaxx = int(np.clip(np.ceil((maxx - ox) / res) + 1 + mc, 0, G - 1))
        gminy = int(np.clip(np.floor((miny - oy) / res) - 1 - mc, 0, G - 1))
        gmaxy = int(np.clip(np.ceil((maxy - oy) / res) + 1 + mc, 0, G - 1))
        span = max(gmaxx - gminx, gmaxy - gminy) + 1 + 2 * h + 4

        s_max = self._max_sub()
        S = s_max
        for b in _SUB_BUCKETS:
            if b >= span and b < s_max:
                S = b
                break
        if S >= G:
            return 0, 0, S
        sox = int(np.clip(gminx - h - 2, 0, G - S))
        soy = int(np.clip(gminy - h - 2, 0, G - S))
        return sox, soy, S

    # -- compiled programs ------------------------------------------------------
    def _program(self, P, B, penalty, do_fine, coarse_offset, S,
                 q_from_library=True):
        key = (P, B, penalty, do_fine, round(coarse_offset, 12), S,
               q_from_library)
        prog = self._programs.get(key)
        if prog is None:
            core = self._make_core(P, B, penalty, do_fine, coarse_offset, S,
                                   q_from_library)
            prog = jax.jit(core)
            self._programs[key] = prog
        return prog

    def _make_core(self, P, B, penalty, do_fine, coarse_offset, S,
                   q_from_library=True):
        cfg = self.config
        G = self.grid_size
        res = cfg.resolution
        dtype = self.dtype
        k1 = self._k1
        h = self._half
        return_grid = self.return_meta

        coarse_spec = C.LatticeSpec.from_search(
            0.0, 0.0, 0.0, cfg.search_size * 0.5, res * 2,
            coarse_offset * 0.5, cfg.coarse_angle_resolution,
        )
        fine_spec = C.LatticeSpec.from_search(
            0.0, 0.0, 0.0, res * 2, res,
            _FINE_ANGLE_SIZE, cfg.fine_search_angle_resolution,
        )
        # coarse stride = (res*2)/res = 2, fine stride = 1 — static
        coarse_scorer = _pick_scorer(coarse_spec, 2)
        fine_scorer = _pick_scorer(fine_spec, 1)

        def core(lib, idx, mask, pose, q_ref, center, vp, sub):
            # lib: device library fields; idx (N, B) slots; q_ref is either
            # (N,) query slots or an explicit (q_lx, q_ly, n_q) triple.
            base_lx = lib["lx"][idx]      # (N, B, P)
            base_ly = lib["ly"][idx]
            anchor = lib["anchor"][idx]
            term = lib["term"][idx]
            has_run = lib["has_run"][idx]
            if q_from_library:
                qlx = lib["lx"][q_ref]    # (N, P)
                qly = lib["ly"][q_ref]
                n_q = lib["n"][q_ref]
            else:
                qlx, qly, n_q = q_ref

            cx, cy, ct = center[:, 0], center[:, 1], center[:, 2]
            ox = cx - 0.5 * (G - 1) * res
            oy = cy - 0.5 * (G - 1) * res

            pc = jnp.cos(pose[..., 2:3])
            ps = jnp.sin(pose[..., 2:3])
            wx = pose[..., 0:1] + pc * base_lx - ps * base_ly
            wy = pose[..., 1:2] + ps * base_lx + pc * base_ly

            keep = C.keep_mask_for_viewpoint(
                wx, wy, anchor, term, has_run, mask[..., None],
                vp[:, 0][:, None, None], vp[:, 1][:, None, None],
            )
            sox = sub[:, 0]
            soy = sub[:, 1]
            q2d, cgrid = C.build_quantized_subgrids(
                wx, wy, keep, ox, oy, sox, soy, G=G, S=S, h=h, res=res,
                taps=tuple(float(v) for v in k1), dtype=dtype,
            )
            N = wx.shape[0]
            lane = jnp.arange(P)
            qx = jnp.where(lane[None, :] < n_q[:, None], qlx, _FAR)
            qy = jnp.where(lane[None, :] < n_q[:, None], qly, _FAR)
            n_pts = n_q.astype(dtype)

            common = dict(grid_size=G, grid_res=res, penalize=penalty,
                          dtype=dtype, sub_size=S,
                          karto_penalties=cfg.karto_penalty_tuple())

            def score(scorer, *args, spec, **kw):
                fn = (C.score_lattice_patch_batched if scorer == "patch"
                      else C.score_lattice_batched)
                return fn(q2d, *args, spec=spec, **kw)

            out_c, xv, yv, tv = score(
                coarse_scorer, qx, qy, n_pts, cx, cy, ct, ox, oy, sox, soy,
                spec=coarse_spec, xy_size=cfg.search_size * 0.5,
                xy_res=res * 2, ang_size=coarse_offset * 0.5,
                ang_res=cfg.coarse_angle_resolution, **common,
            )
            coarse = jnp.stack(
                jax.vmap(C.reduce_best_pose)(out_c, xv, yv, tv), axis=1
            )
            if do_fine:
                out_f, xv, yv, tv = score(
                    fine_scorer, qx, qy, n_pts, coarse[:, 1], coarse[:, 2],
                    coarse[:, 3], ox, oy, sox, soy,
                    spec=fine_spec, xy_size=res * 2, xy_res=res,
                    ang_size=_FINE_ANGLE_SIZE,
                    ang_res=cfg.fine_search_angle_resolution, **common,
                )
                fine = jnp.stack(
                    jax.vmap(C.reduce_best_pose)(out_f, xv, yv, tv), axis=1
                )
            else:
                fine = coarse
            # one packed output array => ONE device->host transfer per
            # dispatch
            outs = (jnp.stack([coarse, fine], axis=1),)  # (N, 2, 8)
            if return_grid:
                outs = outs + (cgrid,)
            return outs

        return core

    def batched_core(self, P, B, penalty, do_fine, S, coarse_offset=None):
        """The raw (unjitted) batch-first match function — for composition
        under shard_map/pjit (see yag_slam_tpu.parallel.loop_search)."""
        if coarse_offset is None:
            coarse_offset = self.config.coarse_search_angle_offset
        return self._make_core(P, B, penalty, do_fine, coarse_offset, S,
                               q_from_library=True)

    # -- job assembly -----------------------------------------------------------
    def _assemble_jobs(self, jobs, P, B, n_pad=None):
        """Host-side per-job metadata (library slots + poses + subgrids) —
        a few KB per dispatch; the heavy views live on device."""
        N = n_pad or len(jobs)
        np_dtype = np.dtype(self.dtype)
        idx = np.zeros((N, B), dtype=np.int32)
        mask = np.zeros((N, B), dtype=bool)
        pose = np.zeros((N, B, 3), dtype=np_dtype)
        q_idx = np.zeros(N, dtype=np.int32)
        center = np.zeros((N, 3), dtype=np_dtype)
        sub = np.zeros((N, 2), dtype=np.int32)
        S = 0
        for j, (query, base_scans) in enumerate(jobs):
            slots = self.library.ensure(list(base_scans) + [query], P)
            idx[j, : len(base_scans)] = slots[:-1]
            q_idx[j] = slots[-1]
            mask[j, : len(base_scans)] = True
            for i, s in enumerate(base_scans):
                p = s.corrected_pose
                pose[j, i] = (p.x, p.y, p.euler[-1])
            p = query.corrected_pose
            center[j] = (p.x, p.y, p.euler[-1])
            sox, soy, S_j = self._subgrid_for(base_scans, p.x, p.y, P)
            sub[j] = (sox, soy)
            S = max(S, S_j)
        return idx, mask, pose, q_idx, center, sub, S

    # -- public API -----------------------------------------------------------
    def match_scan(self, query, base_scans, penalty=True, do_fine=True):
        """Match `query` against `base_scans`; same contract as the
        reference matchers (/root/reference/yag_slam/scan_matching.py:40-42,
        175-222): returns ScanMatcherResult with the covariance assembled
        from the coarse xy moments and the fine theta moment."""
        return self.match_scan_async(query, base_scans, penalty,
                                     do_fine).result()

    def match_scan_async(self, query, base_scans, penalty=True, do_fine=True):
        """Dispatch one match without blocking on the device.

        jax dispatch is asynchronous: this assembles the job, enqueues the
        compiled program and returns a handle immediately, so an online
        pipeline can overlap match N's device time + readback with match
        N+1's host-side assembly (`handle.result()` blocks and applies
        response expansion if the coarse response came back empty)."""
        if not base_scans:
            raise ValueError("match_scan needs at least one base scan")
        P = self._ensure_point_cap(list(base_scans) + [query])
        B = self._base_bucket(len(base_scans))
        idx, mask, pose, q_idx, center, sub, S = self._assemble_jobs(
            [(query, base_scans)], P, B
        )
        args = (idx, mask, pose, q_idx, center, center[:, :2], sub)
        prog = self._program(P, B, bool(penalty), bool(do_fine),
                             self.config.coarse_search_angle_offset, S)
        outs = prog(self.library.fields, *args)
        outs[0].copy_to_host_async()  # overlap readback with what follows
        return _MatchHandle(self, outs, args, P, B, penalty, do_fine, S)

    def _expansion_retries(self, args, P, B, penalty, do_fine, S):
        """Synchronous response-expansion retries after an empty coarse
        response (Karto's MatchScan widens the angle window while the
        search finds no signal; README.md:40).  Returns the last attempt's
        (coarse, fine, outs, coarse_offset_used)."""
        cfg = self.config
        coarse = fine = outs = None
        coarse_offset = cfg.coarse_search_angle_offset
        for attempt in range(_EXPANSION_TRIES):
            coarse_offset = (
                cfg.coarse_search_angle_offset + (attempt + 1) * _EXPANSION_STEP
            )
            prog = self._program(P, B, bool(penalty), bool(do_fine),
                                 coarse_offset, S)
            outs = prog(self.library.fields, *args)
            packed = np.asarray(outs[0][0])
            coarse, fine = packed[0], packed[1]
            if float(coarse[0]) > 0.0:
                break
        return coarse, fine, outs, coarse_offset

    def _expansion_retries_many(self, args, rows, P, B, penalty, do_fine, S):
        """Batched response-expansion retries: ONE widened dispatch over
        ALL empty-response rows per attempt (instead of one synchronous
        match_scan per job).  Per-row semantics match the per-job path:
        a row adopts the first attempt whose coarse response is positive,
        or the last attempt's result.  Rows are padded to a power-of-two
        bucket so repeat bursts reuse compiled programs.

        Returns {row: (coarse, fine)} for every requested row."""
        cfg = self.config
        rows_a = np.asarray(rows, dtype=np.int64)
        n = len(rows_a)
        n_pad = 1
        while n_pad < n:
            n_pad *= 2
        pad_rows = np.concatenate(
            [rows_a, np.repeat(rows_a[:1], n_pad - n)]
        )
        sub_args = tuple(a[pad_rows] for a in args)
        out = {}
        remaining = set(range(n))
        for attempt in range(_EXPANSION_TRIES):
            coarse_offset = (
                cfg.coarse_search_angle_offset
                + (attempt + 1) * _EXPANSION_STEP
            )
            prog = self._program(P, B, bool(penalty), bool(do_fine),
                                 coarse_offset, S)
            outs = prog(self.library.fields, *sub_args)
            packed = np.asarray(outs[0])
            last = attempt == _EXPANSION_TRIES - 1
            for k in list(remaining):
                coarse, fine = packed[k, 0], packed[k, 1]
                if float(coarse[0]) > 0.0 or last:
                    out[int(rows_a[k])] = (coarse, fine, coarse_offset)
                    remaining.discard(k)
            if not remaining:
                break
        return out

    def _finish(self, outs, args, P, B, penalty, do_fine, S):
        """Blocking tail of a dispatched match: fetch the reductions and
        run expansion retries if the coarse response came back empty.
        Expansion triggers on the *coarse* correlation response, as in
        Karto's MatchScan (the fine response can legitimately be <= 0
        through the unclamped penalty even after a good recovery)."""
        packed = np.asarray(outs[0][0])
        coarse, fine = packed[0], packed[1]
        coarse_offset = self.config.coarse_search_angle_offset
        if float(coarse[0]) <= 0.0 and self.config.use_response_expansion:
            c2, f2, o2, coarse_offset = self._expansion_retries(
                args, P, B, penalty, do_fine, S
            )
            if c2 is not None:
                coarse, fine, outs = c2, f2, o2
        return self._assemble(coarse, fine, do_fine, outs,
                              center=args[4][0], coarse_offset=coarse_offset)

    def match_many(self, jobs, penalty=True, do_fine=True):
        """Score independent (query, base_scans) jobs in one dispatch.

        The throughput path: used for fanned-out loop-closure candidate
        matching (the reference loops chains one C++ call at a time,
        /root/reference/yag_slam/graph_slam.py:217-236) and for offline
        batch workloads.  Jobs needing response expansion are retried as
        one widened sub-batch per attempt (O(attempts) programs total,
        not O(jobs); see _expansion_retries_many).
        """
        return self.match_many_async(jobs, penalty, do_fine).result()

    def match_many_async(self, jobs, penalty=True, do_fine=True):
        """Dispatch a batch of independent jobs without blocking.

        Returns a handle whose .result() yields the list of
        ScanMatcherResult (symmetric with match_scan_async — an empty
        batch yields a trivial handle whose result is []).
        Like match_scan_async, this lets a pipeline overlap batch N's
        device time + readback with batch N+1's host-side assembly and
        dispatch."""
        if not jobs:
            return _EmptyBatchHandle()
        all_scans = [q for q, _ in jobs] + [s for _, bs in jobs for s in bs]
        P = self._ensure_point_cap(all_scans)
        B = self._base_bucket(max(len(bs) for _, bs in jobs))
        idx, mask, pose, q_idx, center, sub, S = self._assemble_jobs(
            jobs, P, B
        )

        prog = self._program(
            P, B, bool(penalty), bool(do_fine),
            self.config.coarse_search_angle_offset, S,
        )
        args = (idx, mask, pose, q_idx, center, center[:, :2], sub)
        outs = prog(self.library.fields, *args)
        outs[0].copy_to_host_async()
        return _MatchManyHandle(self, outs, jobs, args, P, B, penalty,
                                do_fine, S)

    @staticmethod
    def _arange_mean(start, stop, step):
        """Mean of np.arange(start, stop, step) — the reference builds its
        candidate lattices with np.arange at the float search center
        (/root/reference/yag_slam/helpers.py:177-179), whose LENGTH can
        differ by one from the center-0 static lattice when (stop-start)/
        step rounds across an integer (e.g. the fine pass's exact 4.0 and
        the 10.0 angle ratios)."""
        vals = np.arange(start, stop, step)
        return float(vals.mean()) if len(vals) else start

    def _degenerate_fixup(self, coarse, fine, do_fine, center_xyt,
                          coarse_offset):
        """Reference-exact best pose for zero-response matches.

        A zero-response match ties the ENTIRE lattice, so the reported
        best pose is the lattice mean — and the reference's np.arange
        lattice at the true float center systematically includes one more
        boundary candidate than the compiled static lattice whenever the
        extent/step ratio is an exact integer (fine xy: 4.0; both angle
        passes: 10.0).  That half-step offset compounds across a
        trajectory (the A/B harness measured it directly).  When the
        device result IS the full-lattice tie mean, recompute it on host
        with np.arange at the actual centers; partial ties (e.g. a
        negative-penalty lattice with a few exact-zero cells) are left
        untouched — the consistency check below rejects them."""
        cfg = self.config
        res = cfg.resolution
        cx, cy, ct = (float(v) for v in center_xyt[:3])
        s = 0.5 * cfg.search_size
        so = 0.5 * coarse_offset
        # full-lattice tie <=> the device mean equals the static lattice
        # mean (center + the compiled center-0 offsets' mean).  The
        # device mean is computed and stored in the matcher dtype — in
        # f32, representation spacing at |x| ~ tens of meters is ~2e-6
        # and the mean of ~1e3 candidates accumulates several ulps, so
        # the tolerance must scale with dtype and magnitude (a fixed
        # 1e-6 silently disabled the fixup away from the origin) while
        # staying well below a quarter lattice step, the scale that
        # separates a full tie from a partial one.
        dt = np.dtype(self.dtype).type

        def _tol(v, step):
            return min(0.25 * step,
                       max(1e-6, 256.0 * float(np.spacing(dt(abs(v) + 1.0)))))

        stat_x = cx + float(np.arange(-s, s, res * 2).mean())
        stat_y = cy + float(np.arange(-s, s, res * 2).mean())
        stat_t = ct + float(
            np.arange(-so, so, cfg.coarse_angle_resolution).mean()
        )
        if not (
            abs(float(coarse[1]) - stat_x) < _tol(stat_x, res * 2)
            and abs(float(coarse[2]) - stat_y) < _tol(stat_y, res * 2)
            and abs(float(coarse[3]) - stat_t)
            < _tol(stat_t, cfg.coarse_angle_resolution)
        ):
            return coarse, fine
        bx = self._arange_mean(cx - s, cx + s, res * 2)
        by = self._arange_mean(cy - s, cy + s, res * 2)
        bt = self._arange_mean(ct - so, ct + so, cfg.coarse_angle_resolution)
        coarse = np.array(coarse, dtype=np.float64)
        coarse[1:4] = (bx, by, bt)
        if do_fine:
            fr = cfg.fine_search_angle_resolution
            fine = np.array(fine, dtype=np.float64)
            fine[1:4] = (
                self._arange_mean(bx - res * 2, bx + res * 2, res),
                self._arange_mean(by - res * 2, by + res * 2, res),
                self._arange_mean(bt - _FINE_ANGLE_SIZE,
                                  bt + _FINE_ANGLE_SIZE, fr),
            )
        else:
            fine = coarse
        return coarse, fine

    def match_many_mega(self, jobs, penalty=True, do_fine=True, chunk=16):
        """Score an arbitrarily long job list as ONE compiled program.

        A `lax.scan` over fixed-size chunks of the batched core: one
        dispatch + one packed readback TOTAL regardless of len(jobs) —
        the offline / loop-closure-burst throughput path.  Results are
        identical to :meth:`match_many`; jobs needing response expansion
        are retried afterwards as widened sub-batches (O(attempts)
        additional programs)."""
        if not jobs:
            return []
        all_scans = [q for q, _ in jobs] + [s for _, bs in jobs for s in bs]
        P = self._ensure_point_cap(all_scans)
        B = self._base_bucket(max(len(bs) for _, bs in jobs))
        N = len(jobs)
        n_ch = (N + chunk - 1) // chunk
        N_pad = n_ch * chunk
        idx, mask, pose, q_idx, center, sub, S = self._assemble_jobs(
            jobs, P, B, n_pad=N_pad
        )
        # padded rows re-dispatch job 0's metadata (cheap, ignored below)
        if N_pad > N:
            for a in (idx, mask, pose, q_idx, center, sub):
                a[N:] = a[:1]
        args = (idx, mask, pose, q_idx, center, center[:, :2], sub)

        key = ("mega", P, B, bool(penalty), bool(do_fine), S, chunk)
        prog = self._programs.get(key)
        if prog is None:
            core = self._make_core(
                P, B, bool(penalty), bool(do_fine),
                self.config.coarse_search_angle_offset, S,
            )

            def mega(lib, *chunked):
                def body(carry, xs):
                    return carry, core(lib, *xs)[0]

                _, packs = jax.lax.scan(body, 0, chunked)
                return packs  # (n_ch, chunk, 2, 8)

            prog = jax.jit(mega)
            self._programs[key] = prog

        chunked = tuple(
            np.ascontiguousarray(a).reshape((n_ch, chunk) + a.shape[1:])
            for a in args
        )
        packed = np.asarray(
            prog(self.library.fields, *chunked)
        ).reshape(N_pad, 2, 8)
        coarse_r, fine_r = packed[:, 0], packed[:, 1]
        need = [
            j for j in range(N)
            if float(coarse_r[j][0]) <= 0.0
            and self.config.use_response_expansion
        ]
        retried = (
            self._expansion_retries_many(args, need, P, B, penalty,
                                         do_fine, S)
            if need
            else {}
        )
        results = []
        for j in range(N):
            c, f, off = retried.get(
                j, (coarse_r[j], fine_r[j],
                    self.config.coarse_search_angle_offset)
            )
            results.append(self._assemble(c, f, do_fine, None,
                                          center=center[j],
                                          coarse_offset=off))
        return results

    def _assemble(self, coarse, fine, do_fine, outs, center=None,
                  coarse_offset=None):
        cfg = self.config
        final_resp = float(fine[0] if do_fine else coarse[0])
        if center is not None and final_resp <= 0.0:
            if coarse_offset is None:
                coarse_offset = cfg.coarse_search_angle_offset
            coarse, fine = self._degenerate_fixup(
                coarse, fine, do_fine, center, coarse_offset
            )
        if do_fine:
            response, x, y, t = (float(v) for v in fine[:4])
            th = float(fine[7])
        else:
            response, x, y, t = (float(v) for v in coarse[:4])
            th = 4.0 * cfg.coarse_angle_resolution
        # xy covariance always from the coarse pass, theta from fine —
        # reference quirk preserved
        # (/root/reference/yag_slam/scan_matching.py:204-218).
        xx, yy, xy = float(coarse[4]), float(coarse[5]), float(coarse[6])
        covar = np.array([[xx, xy, 0.0], [xy, yy, 0.0], [0.0, 0.0, th]])
        if self.sanitize_covariance:
            covar = self._sanitize_covariance(covar)
        meta = None
        if self.return_meta and outs is not None and len(outs) > 1:
            meta = {"grid": np.asarray(outs[1][0]),
                    "kernel": np.outer(self._k1, self._k1)}
        return ScanMatcherResult(
            response, covar, Transform.from_position_euler(x, y, 0, 0, 0, t), meta
        )

    def _sanitize_covariance(self, covar):
        return sanitize_covariance(covar, self.config)

    # -- scan-set (submap) matching ------------------------------------------
    def _match_explicit_query(self, base_scans, q_lx, q_ly, n_q, center_xyt,
                              viewpoint_xy, penalty, do_fine, P):
        """One match with explicit query points (not library-resident) —
        the scan-set paths."""
        B = self._base_bucket(len(base_scans))
        idx, mask, pose, _, _, sub, S = self._assemble_jobs(
            [(base_scans[0], base_scans)], P, B
        )
        np_dtype = np.dtype(self.dtype)
        center = np.asarray(center_xyt, dtype=np_dtype)[None]
        sox, soy, S = self._subgrid_for(
            base_scans, float(center_xyt[0]), float(center_xyt[1]), P
        )
        sub = np.array([[sox, soy]], dtype=np.int32)
        vp = np.asarray(viewpoint_xy, dtype=np_dtype)[None]
        q_ref = (
            q_lx[None].astype(np_dtype),
            q_ly[None].astype(np_dtype),
            np.asarray([n_q], dtype=np.int32),
        )
        prog = self._program(
            P, B, bool(penalty), bool(do_fine),
            self.config.coarse_search_angle_offset, S, q_from_library=False,
        )
        outs = prog(self.library.fields, idx, mask, pose, q_ref, center, vp,
                    sub)
        packed = np.asarray(outs[0][0])
        return self._assemble(packed[0], packed[1], do_fine, outs,
                              center=center[0])

    def match_scan_sets(self, query_scans, base_scans, penalty=True, do_fine=True):
        """Rigidly match a set of query scans against base scans — the
        reference's submap-alignment path
        (/root/reference/yag_slam/scan_matching.py:56-122).  The grid is
        centered on the query set's mean position; the result carries a
        list of corrected poses, one per query scan."""
        if not query_scans or not base_scans:
            raise ValueError("match_scan_sets needs query and base scans")
        ox_real = float(np.mean([q.corrected_pose.x for q in query_scans]))
        oy_real = float(np.mean([q.corrected_pose.y for q in query_scans]))
        oxy = Transform.from_position_euler(ox_real, oy_real, 0, 0, 0, 0)

        # The reference validates base points against the *last* query
        # scan's pose (leftover loop variable,
        # /root/reference/yag_slam/scan_matching.py:72-80) — preserved.
        viewpoint = query_scans[-1].corrected_pose

        qx_list, qy_list = [], []
        for q in query_scans:
            px, py = q.points()
            qx_list.append(px - ox_real)
            qy_list.append(py - oy_real)
        qx = np.concatenate(qx_list)
        qy = np.concatenate(qy_list)

        P = max(self._ensure_point_cap(base_scans), _next_bucket(len(qx)))
        self._point_cap = P
        q_lx = np.full(P, _FAR)
        q_ly = np.full(P, _FAR)
        q_lx[: len(qx)] = qx
        q_ly[: len(qy)] = qy

        result = self._match_explicit_query(
            base_scans, q_lx, q_ly, len(qx),
            (ox_real, oy_real, 0.0), (viewpoint.x, viewpoint.y),
            penalty, do_fine, P,
        )
        diff = result.best_pose - oxy
        return ScanMatcherResult(
            result.response, result.covariance,
            [diff + q.corrected_pose for q in query_scans], result.meta,
        )

    def match_scan_sets_with_map(self, cgrid, ox, oy, query_scans,
                                 penalty=True, do_fine=True):
        """Match a set of query scans against a *precomputed* correlation
        grid (e.g. from a saved map via
        occupancy_grid_map_to_correlation_grid) — the reference's
        localize-against-map path, which is unrunnable as shipped (NameError
        on `find_best_pose_non_symmetric`,
        /root/reference/yag_slam/scan_matching.py:154 vs imports :24-26); we
        implement it working, with its literal search parameters (coarse
        ±0.25 m @ 0.01, ±0.1 rad @ 0.01, grid res 0.05, unpenalized)."""
        if not query_scans:
            raise ValueError("match_scan_sets_with_map needs query scans")
        cfg = self.config
        res = cfg.resolution
        ox_real = float(np.mean([q.corrected_pose.x for q in query_scans]))
        oy_real = float(np.mean([q.corrected_pose.y for q in query_scans]))
        oxy = Transform.from_position_euler(ox_real, oy_real, 0, 0, 0, 0)

        qx_list, qy_list = [], []
        for q in query_scans:
            px, py = q.points()
            qx_list.append(px - ox_real)
            qy_list.append(py - oy_real)
        qx = np.concatenate(qx_list)
        qy = np.concatenate(qy_list)
        P = _next_bucket(len(qx))
        np_dtype = np.dtype(self.dtype)
        q_lx = np.full(P, _FAR, dtype=np_dtype)
        q_ly = np.full(P, _FAR, dtype=np_dtype)
        q_lx[: len(qx)] = qx
        q_ly[: len(qy)] = qy

        H, W = cgrid.shape
        key = ("with_map", H, W, P, bool(penalty), bool(do_fine))
        prog = self._programs.get(key)
        if prog is None:
            coarse_spec = C.LatticeSpec.from_search(0.0, 0.0, 0.0, 0.25, 0.01,
                                                    0.1, 0.01)
            fine_spec = C.LatticeSpec.from_search(
                0.0, 0.0, 0.0, res * 2, res, _FINE_ANGLE_SIZE,
                cfg.fine_search_angle_resolution,
            )
            G = max(H, W)
            dtype = self.dtype

            def fn(grid, px, py, n_q, center):
                padded = jnp.zeros((G, G), dtype=dtype).at[:H, :W].set(grid)
                qflat = jnp.concatenate(
                    [C.quantize_grid(padded).ravel(), jnp.zeros(1, dtype=dtype)]
                )
                cx, cy, ct = center[0], center[1], center[2]
                n_pts = n_q.astype(dtype)
                coarse = C.find_best_pose(
                    qflat, px, py, n_pts, cx, cy, ct, center[3], center[4],
                    spec=coarse_spec, xy_size=0.25, xy_res=0.01,
                    ang_size=0.1, ang_res=0.01, grid_size=G, grid_res=0.05,
                    penalize=False, dtype=dtype, symmetric=False,
                )
                if do_fine:
                    fine = C.find_best_pose(
                        qflat, px, py, n_pts, coarse[1], coarse[2], coarse[3],
                        center[3], center[4], spec=fine_spec, xy_size=res * 2,
                        xy_res=res, ang_size=_FINE_ANGLE_SIZE,
                        ang_res=cfg.fine_search_angle_resolution, grid_size=G,
                        grid_res=res, penalize=penalty, dtype=dtype,
                        symmetric=False,
                    )
                else:
                    fine = coarse
                return jnp.stack(coarse), jnp.stack(fine)

            prog = jax.jit(fn)
            self._programs[key] = prog

        center = np.array([ox_real, oy_real, 0.0, ox, oy], dtype=np_dtype)
        outs = prog(jnp.asarray(cgrid, dtype=self.dtype), q_lx, q_ly,
                    np.int32(len(qx)), center)
        coarse, fine = np.asarray(outs[0]), np.asarray(outs[1])
        result = self._assemble(coarse, fine, do_fine, None)
        diff = result.best_pose - oxy
        return ScanMatcherResult(
            result.response, result.covariance,
            [q.corrected_pose + diff for q in query_scans], result.meta,
        )


# API-parity alias (the reference aliases `Scan2DMatcher = Scan2DMatcherPy`,
# /root/reference/yag_slam/scan_matching.py:224).
Scan2DMatcher = CorrelativeScanMatcher

"""Device-chained online sequential matching.

The reference's online loop is strictly sequential: scan k's corrected
pose feeds scan k+1's search center, so it blocks on every match
(reference yag_slam/graph_slam.py:316-327): each match pays a
dispatch, the device time and a readback before the next can start.

This pipeline keeps the pose-correction feedback ON DEVICE.  A
device-resident ``(K, 3)`` corrected-pose array is aligned with the
matcher's scan-library slots; each chained step

1. composes the previous query's device pose with the host-supplied
   odometry prior to get the search center (``se2_compose`` on device),
2. gathers the base window's poses from the device array,
3. runs the normal fused match program (grid build + coarse + fine), and
4. writes the fine best pose back into the pose array at the query slot,

so consecutive matches chain device-to-device with NO host round trip.
The host only *dispatches* and fetches packed results in blocks of
``sync_every`` — one transfer amortized over many matches.  Whether that
beats the blocking loop on a locally attached card is not measured yet.

Host-side subgrid placement uses an odometry-composed pose estimate that
can lag the device truth by the accumulated match corrections since the
last sync.  Widening the subgrid by the WORST-CASE drift (sync_every
full lattice extents = 216 cells at defaults) pushes the subgrid bucket
to S=2048 — 4x the cell work of the blocking loop's buckets.  Actual
per-step corrections are the odometry noise, ~50x smaller.  So the
subgrid is widened by ONE step's worst case (cheap), and the sync
VERIFIES — with every device-exact pose in hand — that
each match's base occupancy (+ smear halo) at the exact poses fit the
subgrid it was scored against.  A violated match (and everything chained
after it, which consumed its pose) is redone as a bounded synchronous
forward sweep — no re-dispatch recursion (O(batch) worst case and ~never
taken).

Response expansion (the reference retries with a widened angle search
when the response is 0, README.md:40) cannot branch on device; the sync
step detects an empty coarse response and enters the same synchronous
forward sweep (match_scan applies expansion), with the retry centered on
the previous scan's device-exact pose composed with the odometry delta —
the reference's own prediction (graph_slam.py:316-327) — not the stale
pre-sync host estimate.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from yag_slam_tpu.core.transform import (
    Transform, se2_compose, se2_relative,
)


class OnlineMatchPipeline:
    """Chained sequential matching against a sliding window of the last
    ``window`` scans (the reference's running-scans buffer,
    /root/reference/yag_slam/graph_slam.py:336-337).

    Usage::

        pipe = OnlineMatchPipeline(matcher, window=10, sync_every=8)
        pipe.seed(corrected_scans)          # pre-corrected history
        for scan in stream:
            pipe.push(scan)                 # non-blocking dispatch
        results = pipe.flush()              # fetch + apply poses

    ``push`` applies the host-side odometry estimate to
    ``scan.corrected_pose`` immediately (needed for subgrid placement);
    the device-exact corrected pose lands on the scan at the next sync.
    Results are returned in push order by ``flush``/``drain`` as
    ScanMatcherResult, identical (up to f32 pose composition) to calling
    ``matcher.match_scan(scan, window)`` step by step.
    """

    def __init__(self, matcher, window: int = 10, sync_every: int = 8,
                 penalty: bool = True, do_fine: bool = True,
                 block_dispatch: bool = False, lag_blocks: int = 0):
        self.m = matcher
        self.window = int(window)
        self.sync_every = int(sync_every)
        self.penalty = bool(penalty)
        self.do_fine = bool(do_fine)
        # lag_blocks > 0 = readback coalescing: each
        # sync drains all but the newest `lag_blocks` dispatched groups,
        # so a group's device->host transfer (started at dispatch via
        # copy_to_host_async) overlaps the NEXT group's dispatch+compute
        # instead of stalling the pusher for a readback.  Small blocks +
        # lag give a low-latency online mode: results arrive at most
        # sync_every*(lag_blocks+1) pushes after their scan.  The device
        # pose chain is unaffected — only the host-visible fetch is
        # deferred.
        self.lag_blocks = int(lag_blocks)
        # block_dispatch=True batches sync_every chained steps into ONE
        # device program (a lax.scan over the step core): 1 dispatch + 1
        # readback per sync_every matches instead of sync_every dispatches
        # + 1 readback.  Results are identical; matching of scan k starts
        # only once the block fills, so per-scan latency rises by up to
        # sync_every scan periods.
        self.block_dispatch = bool(block_dispatch)
        self._base = []          # current sliding window (host scans)
        # dispatched-but-unfetched groups: (steps, packed_dev) where steps
        # is a list of per-step (scan, base_list, sub_used, prior) and
        # packed_dev is (1, 2, 8) [streaming] or (K, 1, 2, 8) [block]
        self._inflight = []
        self._n_inflight = 0     # total steps across groups
        self._pending = []       # block mode: host-prepped steps awaiting dispatch
        self._results = []       # completed ScanMatcherResult, push order
        self._poses = None       # device (K_cap, 3) corrected poses
        self._est = None         # host (3,) estimate of last pushed pose
        self._last_odom = None   # host (3,) odom pose of last pushed scan
        self._S = 0              # sticky subgrid bucket
        self._progs = {}
        # observability: how often the sync-time validation/expansion
        # fell back to the synchronous sweep (and for how many matches)
        self.stats = {"synced": 0, "redo_sweeps": 0, "redo_matches": 0}
        # Subgrid slack for host-estimate drift: ONE step's worst-case
        # correction (coarse half-search + fine extent), not sync_every of
        # them (the worst-case-cumulative margin blew
        # the subgrid bucket to 4x the blocking loop's cell work).  Typical
        # drift is ~the odometry noise; larger drift is caught by the
        # sync-time exact-pose validation and the match redone.
        cfg = matcher.config
        per_step = 0.5 * cfg.search_size + 2.0 * cfg.resolution
        self._margin_cells = int(np.ceil(per_step / cfg.resolution)) + 4

    # -- device pose array ---------------------------------------------------
    def _ensure_poses(self):
        lib = self.m.library
        np_dtype = np.dtype(self.m.dtype)
        if self._poses is None:
            self._poses = jnp.zeros((lib.K_cap, 3), dtype=np_dtype)
        elif self._poses.shape[0] < lib.K_cap:
            self._poses = jnp.zeros(
                (lib.K_cap, 3), dtype=np_dtype
            ).at[: self._poses.shape[0]].set(self._poses)

    def _set_poses(self, slots, vals):
        self._ensure_poses()
        self._poses = self._poses.at[np.asarray(slots)].set(
            np.asarray(vals, dtype=np.dtype(self.m.dtype))
        )

    @staticmethod
    def _xyt(pose: Transform):
        return np.array([pose.x, pose.y, pose.euler[-1]])

    # -- program --------------------------------------------------------------
    def _make_step(self, P, B, S):
        core = self.m._make_core(
            P, B, self.penalty, self.do_fine,
            self.m.config.coarse_search_angle_offset, S,
            q_from_library=True,
        )

        def step(lib, poses, idx, mask, q_idx, prev_idx, prior, sub):
            center = se2_compose(poses[prev_idx], prior)      # (1, 3)
            pose_b = poses[idx]                               # (1, B, 3)
            outs = core(lib, idx, mask, pose_b, q_idx, center,
                        center[:, :2], sub)
            packed = outs[0]                                  # (1, 2, 8)
            fine_xyt = packed[:, 1, 1:4].astype(poses.dtype)
            poses2 = poses.at[q_idx].set(fine_xyt)
            return poses2, packed

        return step

    def _program(self, P, B, S):
        key = (P, B, S)
        prog = self._progs.get(key)
        if prog is None:
            prog = jax.jit(self._make_step(P, B, S), donate_argnums=(1,))
            self._progs[key] = prog
        return prog

    def _block_program(self, P, B, S, K):
        """K chained steps as ONE program: lax.scan carries the device
        pose array through the per-step core, so a whole sync window runs
        on one dispatch + one readback (the step bodies are identical, so
        XLA compiles the scan body once regardless of K).  Partial blocks
        at flush are padded to the canonical K with valid=False steps
        (all-masked grid, pose write suppressed) so every flush cadence
        reuses ONE compiled program instead of compiling per tail size."""
        key = (P, B, S, "block", K)
        prog = self._progs.get(key)
        if prog is None:
            step = self._make_step(P, B, S)

            def block(lib, poses, idx, mask, q_idx, prev_idx, prior, sub,
                      valid):
                # all step args stacked (K, ...) along axis 0
                def body(carry, xs):
                    *step_xs, v = xs
                    poses2, packed = step(lib, carry, *step_xs)
                    poses2 = jnp.where(v, poses2, carry)
                    return poses2, packed

                poses2, packs = jax.lax.scan(
                    body, poses,
                    (idx, mask, q_idx, prev_idx, prior, sub, valid),
                )
                return poses2, packs                          # (K, 1, 2, 8)

            prog = jax.jit(block, donate_argnums=(1,))
            self._progs[key] = prog
        return prog

    # -- public API -----------------------------------------------------------
    def seed(self, scans):
        """Install pre-corrected scans as the initial window (their
        corrected_pose is trusted as-is).  Resets the stream: any
        un-flushed pushes (buffered or dispatched) are discarded — call
        flush() first if their results matter."""
        self._pending = []
        self._inflight = []
        self._n_inflight = 0
        m = self.m
        P = m._ensure_point_cap(scans)
        slots = m.library.ensure(scans, P)
        self._set_poses(slots, [self._xyt(s.corrected_pose) for s in scans])
        self._base = list(scans)[-self.window:]
        last = self._base[-1]
        self._est = self._xyt(last.corrected_pose)
        self._last_odom = self._xyt(last.odom_pose)

    def _clip_sub(self, sox, soy, S):
        G = self.m.grid_size
        if S >= G:
            return 0, 0
        return (int(np.clip(sox, 0, G - S)), int(np.clip(soy, 0, G - S)))

    def push(self, scan):
        """Enqueue the chained match of `scan` against the current
        window.  Non-blocking; auto-syncs every `sync_every` pushes.
        Streaming mode dispatches each step immediately; block mode
        buffers host-side and dispatches sync_every steps as one
        program."""
        if not self._base:
            raise RuntimeError("seed() the pipeline before push()")
        m = self.m
        base = list(self._base)
        odom = self._xyt(scan.odom_pose)
        prior = se2_relative(odom, self._last_odom)
        self._last_odom = odom
        est = se2_compose(self._est, prior)
        self._est = est
        # host estimate on the scan: subgrid placement for later pushes
        # reads it; the device-exact pose replaces it at sync
        scan.corrected_pose = Transform.from_xyt(*est)

        P = m._ensure_point_cap(base + [scan])
        B = m._base_bucket(len(base))
        slots = m.library.ensure(base + [scan], P)

        idx = np.zeros((1, B), dtype=np.int32)
        mask = np.zeros((1, B), dtype=bool)
        idx[0, : len(base)] = slots[:-1]
        mask[0, : len(base)] = True
        q_idx = np.asarray([slots[-1]], dtype=np.int32)
        prev_idx = np.asarray([slots[len(base) - 1]], dtype=np.int32)
        sox, soy, S_j = m._subgrid_for(
            base, float(est[0]), float(est[1]), P,
            margin_cells=self._margin_cells,
        )
        # sticky subgrid bucket: growth recompiles (rare), never shrink
        # mid-stream (each S is its own compiled program)
        self._S = min(max(self._S, S_j), m._max_sub())
        step = dict(scan=scan, base=base, idx=idx, mask=mask, q_idx=q_idx,
                    prev_idx=prev_idx, prior=prior, sox=sox, soy=soy)
        self._base = (self._base + [scan])[-self.window:]

        if self.block_dispatch:
            self._pending.append(step)
            if len(self._pending) >= self.sync_every:
                self._dispatch_block()
                self._sync(keep=self.lag_blocks)
            return

        np_dtype = np.dtype(m.dtype)
        self._ensure_poses()
        sox, soy = self._clip_sub(sox, soy, self._S)
        sub = np.asarray([[sox, soy]], dtype=np.int32)
        prog = self._program(P, B, self._S)
        self._poses, packed = prog(
            m.library.fields, self._poses, idx, mask, q_idx, prev_idx,
            np.asarray(prior, dtype=np_dtype)[None], sub,
        )
        packed.copy_to_host_async()
        self._inflight.append(
            ([(scan, base, (sox, soy, self._S), prior)], packed)
        )
        self._n_inflight += 1
        if self._n_inflight >= self.sync_every + self.lag_blocks:
            self._sync(keep=self.lag_blocks)

    def _dispatch_block(self):
        """Block mode: run the buffered steps as one chained program."""
        steps = self._pending
        if not steps:
            return
        self._pending = []
        m = self.m
        K = len(steps)
        P = m._point_cap
        # the base bucket can differ across buffered steps while the
        # window is still filling; pad to the block's max (idx 0 +
        # mask False slots are exact no-ops in the core)
        B = max(st["idx"].shape[1] for st in steps)
        S = self._S
        np_dtype = np.dtype(m.dtype)
        self._ensure_poses()

        def pad_b(a, fill):
            pad = B - a.shape[1]
            if pad == 0:
                return a
            return np.pad(a, ((0, 0), (0, pad)), constant_values=fill)

        idx = np.stack([pad_b(st["idx"], 0) for st in steps])
        mask = np.stack([pad_b(st["mask"], False) for st in steps])
        q_idx = np.stack([st["q_idx"] for st in steps])
        prev_idx = np.stack([st["prev_idx"] for st in steps])
        prior = np.stack(
            [np.asarray(st["prior"], dtype=np_dtype)[None] for st in steps]
        )
        subs = [self._clip_sub(st["sox"], st["soy"], S) for st in steps]
        sub = np.asarray(subs, dtype=np.int32)[:, None, :]     # (K, 1, 2)

        # pad flush-time partial blocks up to the canonical program size
        # (valid=False steps: all-masked grid, pose write suppressed) so
        # every tail size reuses the one compiled K=sync_every program.
        # Padded rows sit at the END of the block, and a padded block is
        # only ever the last dispatched group of a sync, so _sync's
        # step/row zip (which truncates at the real step count) stays
        # aligned.
        K_pad = max(self.sync_every, K)
        valid = np.zeros(K_pad, dtype=bool)
        valid[:K] = True
        if K_pad > K:
            reps = K_pad - K
            idx = np.concatenate([idx, np.repeat(idx[-1:], reps, 0)])
            mask = np.concatenate(
                [mask, np.zeros((reps,) + mask.shape[1:], dtype=bool)]
            )
            q_idx = np.concatenate([q_idx, np.repeat(q_idx[-1:], reps, 0)])
            prev_idx = np.concatenate(
                [prev_idx, np.repeat(prev_idx[-1:], reps, 0)]
            )
            prior = np.concatenate([prior, np.repeat(prior[-1:], reps, 0)])
            sub = np.concatenate([sub, np.repeat(sub[-1:], reps, 0)])

        prog = self._block_program(P, B, S, K_pad)
        self._poses, packs = prog(
            m.library.fields, self._poses, idx, mask, q_idx, prev_idx,
            prior, sub, valid,
        )
        # start the device->host transfer now; with lag_blocks the fetch
        # happens a block later, by when the copy has already landed
        packs.copy_to_host_async()
        entry = [
            (st["scan"], st["base"], (sx, sy, S), st["prior"])
            for st, (sx, sy) in zip(steps, subs)
        ]
        self._inflight.append((entry, packs))                  # (K_pad, 1, 2, 8)
        self._n_inflight += K

    def drain(self):
        """Return (and clear) results completed so far without forcing a
        sync of in-flight work."""
        out = self._results
        self._results = []
        return out

    def flush(self):
        """Sync all in-flight matches, apply poses, return all pending
        results in push order."""
        self._sync()
        return self.drain()

    # -- sync -----------------------------------------------------------------
    def _subgrid_valid(self, base, center_xyt, sub_used):
        """With device-exact poses applied to `base`, was the subgrid this
        match was scored against sufficient?  Sufficient = every base
        point inside the full grid, plus its smear halo, lands inside the
        subgrid — then every in-subgrid cell is exact and every
        out-of-subgrid read is truly zero, so the score equals the
        blocking loop's (matcher._subgrid_for exactness argument)."""
        m = self.m
        sox, soy, S = sub_used
        G = m.grid_size
        if S >= G:
            return True
        cfg = m.config
        res = cfg.resolution
        h = m._half
        ox = float(center_xyt[0]) - 0.5 * (G - 1) * res
        oy = float(center_xyt[1]) - 0.5 * (G - 1) * res
        minx = miny = np.inf
        maxx = maxy = -np.inf
        for s in base:
            x0, x1, y0, y1 = m._scan_world_bbox(s, m._point_cap)
            minx = min(minx, x0)
            maxx = max(maxx, x1)
            miny = min(miny, y0)
            maxy = max(maxy, y1)
        # conservative cell bounds (banker's rounding is within the +/-1)
        gminx = int(np.floor((minx - ox) / res)) - 1
        gmaxx = int(np.ceil((maxx - ox) / res)) + 1
        gminy = int(np.floor((miny - oy) / res)) - 1
        gmaxy = int(np.ceil((maxy - oy) / res)) + 1
        # points outside the full grid are dropped on device; only cells
        # in [0, G) must be covered (+ smear halo h)
        return (
            max(gminx - h, 0) >= sox
            and min(gmaxx + h, G - 1) <= sox + S - 1
            and max(gminy - h, 0) >= soy
            and min(gmaxy + h, G - 1) <= soy + S - 1
        )

    def _sync(self, keep=0):
        # block mode: a flush (keep=0) can arrive with a partial block
        # still host-buffered — dispatch it first (its own K-sized
        # program); lagged syncs never force the partial block out
        if self._pending and keep == 0:
            self._dispatch_block()
        if len(self._inflight) <= keep:
            return
        cut = len(self._inflight) - keep
        groups = self._inflight[:cut]
        kept = self._inflight[cut:]
        self._inflight = kept
        self._n_inflight = sum(len(steps) for steps, _ in kept)
        if len(groups) == 1:
            host = np.asarray(groups[0][1]).reshape(-1, 2, 8)
        else:
            # ONE transfer: concat the groups' packed outputs on device
            host = np.asarray(jnp.concatenate(
                [p.reshape(-1, 2, 8) for (_, p) in groups], axis=0
            ))
        inflight = [st for (steps, _) in groups for st in steps]
        m = self.m
        redo_from = None
        for k, ((scan, base, sub_used, prior), row) in enumerate(
                zip(inflight, host)):
            coarse, fine = row[0], row[1]
            # device-exact chain center for this step: previous scan's
            # exact pose (applied in the previous iteration / sync)
            # composed with the odometry prior
            center = se2_compose(self._xyt(base[-1].corrected_pose), prior)
            needs_expansion = (
                float(coarse[0]) <= 0.0 and m.config.use_response_expansion
            )
            if needs_expansion or not self._subgrid_valid(
                    base, center, sub_used):
                redo_from = k
                break
            res = m._assemble(coarse, fine, self.do_fine, None,
                              center=center)
            scan.corrected_pose = res.best_pose
            self._results.append(res)
        self.stats["synced"] += len(inflight)
        if redo_from is not None and kept:
            # the still-lagged groups chained off the poisoned pose on
            # device: fold their steps into the sweep and drop their
            # dispatched results unread
            inflight = inflight + [st for (steps, _) in kept for st in steps]
            self._inflight = []
            self._n_inflight = 0
            kept = []
        if redo_from is not None:
            self.stats["redo_sweeps"] += 1
            self.stats["redo_matches"] += len(inflight) - redo_from
            # Bounded synchronous forward sweep over the remaining steps:
            # each retry is centered on the previous scan's device-exact
            # pose composed with the odometry delta (the reference's own
            # prediction, graph_slam.py:316-327), and
            # match_scan applies response expansion internally.  One
            # match_scan per remaining step — no re-dispatch recursion.
            slots, vals = [], []
            for scan, base, _, _ in inflight[redo_from:]:
                prev = base[-1]
                scan.corrected_pose = prev.corrected_pose + (
                    scan.odom_pose - prev.odom_pose
                )
                res = m.match_scan(scan, base, self.penalty, self.do_fine)
                scan.corrected_pose = res.best_pose
                self._results.append(res)
                slots.append(m.library.ensure([scan], m._point_cap)[0])
                vals.append(self._xyt(res.best_pose))
            self._set_poses(slots, vals)
        # reset host drift estimate: device-exact pose of the last synced
        # scan, advanced by odometry to the last PUSHED scan (identity
        # when nothing is still lagged in flight)
        last_scan = inflight[-1][0]
        exact = self._xyt(last_scan.corrected_pose)
        self._est = se2_compose(
            exact, se2_relative(self._last_odom,
                                self._xyt(last_scan.odom_pose))
        )

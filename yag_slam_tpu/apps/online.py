"""ROS-free online mapping front-end.

Replicates the behavior of the reference's ROS1 node
(/root/reference/ros1/slam_node_ros1) as a plain library: motion gating,
scan-queue worker decoupling, periodic map rendering with the node's value
remap + despeckling, map->odom transform reporting, checkpoint service,
and base-map splice bootstrap — but framework-agnostic (a thin ROS shim
can publish/subscribe around it; nothing here imports ROS).
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np

from yag_slam_tpu.core.scan import LocalizedRangeScan
from yag_slam_tpu.core.transform import Transform
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu.mapping.occupancy import create_occupancy_grid
from yag_slam_tpu.slam.graph_slam import GraphSlam
from yag_slam_tpu.splicing.splice import map_to_graphslam

# Defaults from the reference node's parameter table
# (/root/reference/ros1/slam_node_ros1:150-170).
DEFAULT_SEQ_CONFIG = {
    "angle_variance_penalty": 0.349,
    "distance_variance_penalty": 0.3,
    "coarse_search_angle_offset": 0.349,
    "coarse_angle_resolution": 0.0349,
    "fine_search_angle_resolution": 0.00349,
    "use_response_expansion": True,
    "range_threshold": 20,
    "minimum_angle_penalty": 0.9,
    "search_size": 0.3,
    "resolution": 0.01,
    "smear_deviation": 0.07,
}
DEFAULT_LOOP_CONFIG = dict(
    DEFAULT_SEQ_CONFIG,
    search_size=4.0,
    resolution=0.05,
    smear_deviation=0.03,
)


def render_ros_style_map(slam, resolution=0.05, range_threshold=12.0,
                         despeckle_min_size=5):
    """Occupancy image remapped to ROS occupancy values (occupied 0->100,
    unknown 200->-1, free 255->0) with small-component despeckling —
    /root/reference/ros1/slam_node_ros1:187-212."""
    from scipy import ndimage

    grid = slam.make_occupancy_grid(resolution=resolution,
                                    range_threshold=range_threshold)
    im = grid.image.copy()

    # despeckle: drop tiny occupied connected components
    occ = im == 0
    labels, n = ndimage.label(occ)
    if n:
        sizes = ndimage.sum(occ, labels, index=np.arange(1, n + 1))
        small = np.isin(labels, np.nonzero(sizes < despeckle_min_size)[0] + 1)
        im[small] = 255

    out = im.astype(np.int16)
    out[im == 0] = 100
    out[im == 200] = -1
    out[im == 255] = 0
    return out, grid


class OnlineMapper:
    """Synchronous online-mapping core (one thread; see
    :class:`ThreadedOnlineMapper` for the reference node's queue/worker
    arrangement)."""

    def __init__(
        self,
        seq_config=None,
        loop_config=None,
        *,
        min_distance=0.5,
        min_rotation=0.5,
        range_threshold=20.0,
        range_threshold_for_map=12.0,
        map_resolution=0.05,
        scan_buffer_len=10,
        loop_search_min_chain_size=10,
        loop_search_distance=4.0,
        min_response_coarse=0.6,
        min_response_fine=0.7,
        base_map=None,          # (image, resolution, origin) to splice into
        initial_pose=None,      # (x, y, theta) when localizing in base map
        map_callback=None,      # called with (ros_style_image, grid)
        map_every_n_scans=5,
        dtype=None,
        seq_matcher=None,       # matcher-contract overrides (e.g. the
        loop_matcher=None,      # reference A/B matcher, apps/ab_compare)
    ):
        self.min_distance = min_distance
        self.min_rotation = min_rotation
        self.range_threshold = range_threshold
        self.range_threshold_for_map = range_threshold_for_map
        self.map_resolution = map_resolution
        self.map_callback = map_callback
        self.map_every_n_scans = map_every_n_scans

        if base_map is not None:
            # reference node forces looser thresholds + tiny chains when
            # localizing against a base map
            # (/root/reference/ros1/slam_node_ros1:99-104)
            loop_search_min_chain_size = 2
            min_response_coarse = 0.25
            min_response_fine = 0.35

        matcher_kwargs = {} if dtype is None else {"dtype": dtype}
        seq = seq_matcher or CorrelativeScanMatcher(
            dict(DEFAULT_SEQ_CONFIG, **(seq_config or {})), **matcher_kwargs
        )
        loop = loop_matcher or CorrelativeScanMatcher(
            dict(DEFAULT_LOOP_CONFIG, **(loop_config or {})), loop=True,
            **matcher_kwargs,
        )
        self.slam = GraphSlam(
            seq, loop,
            scan_buffer_len=scan_buffer_len,
            loop_search_dist=loop_search_distance,
            loop_search_min_chain_size=loop_search_min_chain_size,
            min_response_coarse=min_response_coarse,
            min_response_fine=min_response_fine,
        )

        self._base_scans = []
        self.initial_pose = initial_pose
        if base_map is not None:
            image, resolution, origin = base_map
            self.slam = map_to_graphslam(self.slam, image, resolution, origin,
                                         density=5)
            # rebuild optimizer indices, as the reference node does
            # (/root/reference/ros1/slam_node_ros1:147-148)
            self.slam = GraphSlam.deserialize(self.slam.serialize())
            self._base_scans = [v.obj for v in self.slam.graph.vertices]

        self._last_pose = None
        self._scan_counter = 0

    # -- gating ----------------------------------------------------------------
    def _should_integrate(self, pose_xyt):
        if self._last_pose is None:
            self._last_pose = pose_xyt
            return True
        p, l = pose_xyt, self._last_pose
        # wrap the yaw difference: crossing +/-pi is a tiny rotation, not
        # a 2*pi one that would force integration
        dyaw = (p[2] - l[2] + np.pi) % (2.0 * np.pi) - np.pi
        if ((p[0] - l[0]) ** 2 + (p[1] - l[1]) ** 2 < self.min_distance**2
                and abs(dyaw) < self.min_rotation):
            return False
        self._last_pose = pose_xyt
        return True

    # -- main entry -------------------------------------------------------------
    def _prepare_scan(
        self, ranges, angle_min, angle_max, angle_increment, range_min,
        range_max, odom_pose, invert=False,
    ):
        """Motion-gate + build the LocalizedRangeScan; None if the scan
        should not be integrated."""
        pose = (
            (odom_pose.x, odom_pose.y, odom_pose.euler[-1])
            if isinstance(odom_pose, Transform)
            else tuple(float(v) for v in odom_pose)
        )
        if not self._should_integrate(pose):
            return None

        r = np.asarray(ranges, dtype=np.float64)
        if invert:
            r = r[::-1]
        # NOTE: a pending initial_pose override is applied at INGESTION
        # time (_ingest_prepared), to exactly one scan — stamping it here
        # would mark every scan prepared while the override was pending
        # (the offline --stream path prepares the whole log up front).
        return LocalizedRangeScan(
            r, angle_min, angle_max, angle_increment, range_min, range_max,
            self.range_threshold, pose[0], pose[1], pose[2],
        )

    def _after_scan(self, closed):
        self._scan_counter += 1
        if self.map_callback and (
            self._scan_counter % self.map_every_n_scans == 0 or closed
        ):
            self.map_callback(*self.render_map())

    def add_scan(
        self, ranges, angle_min, angle_max, angle_increment, range_min,
        range_max, odom_pose, invert=False,
    ):
        """Feed one scan (odom_pose = (x, y, theta) of the sensor in the
        odom frame).  Returns (integrated, match_result, closed)."""
        scan = self._prepare_scan(
            ranges, angle_min, angle_max, angle_increment, range_min,
            range_max, odom_pose, invert,
        )
        if scan is None:
            return False, None, None
        res, closed = self._ingest_prepared(scan)
        self._after_scan(closed)
        return True, res, closed

    def _ingest_prepared(self, scan):
        """Ingest ONE prepared scan: apply a pending initial_pose override
        (to exactly this scan), splice-bootstrap against a loaded base map
        when applicable, else the normal process_scan path."""
        pending_init = self.initial_pose is not None
        if pending_init:
            scan.odom_pose = Transform.from_xyt(*self.initial_pose)
            scan.corrected_pose = Transform.from_xyt(*self.initial_pose)
            self.initial_pose = None

        if (not self.slam.running_scans and self._base_scans
                and pending_init):
            # splice bootstrap: localize the first live scan against the
            # injected base map (/root/reference/ros1/slam_node_ros1:240-253)
            scan.num = max(v.obj.num for v in self.slam.graph.vertices) + 1
            nearby = self.slam.search.crude_radius_search(scan.odom_pose, 5)
            res = self.slam.seq_matcher.match_scan(
                scan, [v.obj for v in nearby], do_fine=True
            )
            scan.corrected_pose = res.best_pose
            self.slam.add_vertex(scan)
            self.slam.link_scans(scan, nearby[0].obj, None, res.covariance)
            self.slam.running_scans.append(scan)
            closed = True
        else:
            res, closed = self.slam.process_scan(scan)
        return res, closed

    def add_scans_batch(self, prepared_scans):
        """Process several already-prepared scans through the streamed
        SLAM path (GraphSlam.process_scan_stream) — the backpressure
        branch of the threaded mapper.  Returns the list of
        (match_result, closed)."""
        return self.add_scans_batch_stream(prepared_scans)

    def add_scans_batch_stream(self, prepared_scans, sync_every=8):
        """Streamed bulk ingestion of already-prepared scans (offline
        mapper --stream, threaded backpressure batching).

        Bootstrap states the streamed path cannot express are handled per
        scan first: a pending initial_pose override applies
        to exactly one scan, and a fresh localization mapper (base map
        loaded, no running scans) must splice its first scan — streaming
        either would assign duplicate node ids / stamp every scan."""
        out = []
        scans = list(prepared_scans)
        while scans and (
            self.initial_pose is not None
            or (self._base_scans and not self.slam.running_scans)
        ):
            res, closed = self._ingest_prepared(scans.pop(0))
            out.append((res, closed))
            self._after_scan(closed)
        if scans:
            tail = self.slam.process_scan_stream(scans,
                                                 sync_every=sync_every)
            for _, closed in tail:
                self._after_scan(closed)
            out.extend(tail)
        return out

    # -- outputs ---------------------------------------------------------------
    def map_to_odom(self):
        """map->odom correction transform from the last corrected pose
        (/root/reference/ros1/slam_node_ros1:287-290)."""
        if not self.slam.running_scans:
            return Transform()
        ls = self.slam.running_scans[-1]
        odom_to_map = ls.odom_pose + ls.corrected_pose.inverse()
        return odom_to_map.inverse()

    def render_map(self):
        return render_ros_style_map(
            self.slam, self.map_resolution, self.range_threshold_for_map
        )

    def save_graph(self, path="/tmp/map.graph"):
        self.slam.to_file(path)
        return path


class ThreadedOnlineMapper(OnlineMapper):
    """Queue/worker arrangement like the reference node's three threads
    (/root/reference/ros1/slam_node_ros1:112-118,223-269): callers enqueue
    scans without blocking on matching; map rendering runs on its own
    thread."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        map_cb = self.map_callback
        self.map_callback = None  # invoked on the map thread instead
        self._user_map_callback = map_cb
        self._queue = queue.Queue()
        self._map_queue = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._map_thread = threading.Thread(target=self._map_run, daemon=True)
        self._worker.start()
        self._map_thread.start()

    def enqueue_scan(self, *args, **kwargs):
        self._queue.put((args, kwargs))
        if self._queue.qsize() > 1:
            print(f"{time.time()}: scan queue depth {self._queue.qsize()}")

    def _run(self):
        counter = 0
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            batch = [item]
            # backpressure adaptation: if the robot outruns per-scan
            # processing, drain the backlog (bounded) and run it as ONE
            # streamed block (GraphSlam.process_scan_stream — device-
            # chained matching, loop closure at sync boundaries); at
            # queue depth 1 the per-scan path keeps latency minimal
            # don't batch while a bootstrap state is pending (first scan /
            # initial_pose override); add_scans_batch_stream also guards
            # these itself — this keeps the backlog drain simple
            can_batch = (
                bool(self.slam.running_scans) and self.initial_pose is None
            )
            if can_batch:
                while len(batch) < 16:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
            if len(batch) == 1 or not can_batch:
                n_done = 0
                closed_any = False
                for args, kwargs in batch:
                    integrated, _, closed = self.add_scan(*args, **kwargs)
                    n_done += bool(integrated)
                    closed_any |= bool(closed)
                    self._queue.task_done()
            else:
                scans = []
                for args, kwargs in batch:
                    s = self._prepare_scan(*args, **kwargs)
                    if s is not None:
                        scans.append(s)
                out = self.add_scans_batch(scans) if scans else []
                for _ in batch:
                    self._queue.task_done()
                n_done = len(scans)
                closed_any = any(bool(c) for _, c in out)
            if n_done:
                counter += n_done
                if (counter >= self.map_every_n_scans or closed_any) and \
                        self._map_queue.qsize() == 0:
                    self._map_queue.put(True)
                    counter = 0

    def _map_run(self):
        while not self._stop.is_set():
            try:
                self._map_queue.get(timeout=0.2)
            except queue.Empty:
                continue
            if self._user_map_callback and self.slam.graph.vertices:
                self._user_map_callback(*self.render_map())
            self._map_queue.task_done()

    def drain(self, timeout=60.0):
        """Block until all enqueued scans are processed (tracked via
        task_done, not queue emptiness — the worker removes a backlog
        batch from the queue before processing it)."""
        deadline = time.time() + timeout
        while self._queue.unfinished_tasks and time.time() < deadline:
            time.sleep(0.05)
        return self._queue.unfinished_tasks == 0

    def close(self):
        self._stop.set()
        self._worker.join(timeout=2)
        self._map_thread.join(timeout=2)

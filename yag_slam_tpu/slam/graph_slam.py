"""Online graph-SLAM orchestration.

State machine and contracts follow the reference orchestrator
(/root/reference/yag_slam/graph_slam.py:42-342): per scan — dead-reckon a
pose guess from odometry, sequentially match against the running-scan
buffer, add vertex + odometry/sequential edges, search for loop-closure
chains, coarse+fine match accepted chains, and trigger global SPA on a
closure.  All data-dependent control flow (chain discovery, accept/reject,
first-closure break) stays on the host — exactly where the reference keeps
it — while every matcher/solve call underneath is a batched device program.

Deliberate divergences from reference quirks (SURVEY §7), both documented
at their sites below:
- the fine-response gate during loop closure actually rejects (the
  reference only rejects when `verbose` is set — a guard-ordering bug at
  /root/reference/yag_slam/graph_slam.py:238-240);
- the chain distance gate compares squared distance against the *squared*
  search radius (the reference compares dist² ≤ dist, shrinking the
  effective radius to √dist: /root/reference/yag_slam/graph_slam.py:291).
Both switches are available as constructor flags for bug-compatible runs.
"""
from __future__ import annotations

import time
import zlib

import numpy as np

from yag_slam_tpu.core.config import default_config, default_config_loop
from yag_slam_tpu.core.transform import Pose2, Transform
from yag_slam_tpu.graphopt.graph import (
    Edge,
    Graph,
    LinkLabel,
    RadiusHashSearch,
    Vertex,
    do_breadth_first_traversal,
    scans_dist_squared,
)
from yag_slam_tpu.graphopt.spa import SPA2d
from yag_slam_tpu.matching.matcher import CorrelativeScanMatcher
from yag_slam_tpu.slam import msgpack_lite
from yag_slam_tpu.slam.serde import _deserialize, _serialize


def make_near_scan_visitor(distance):
    """Predicate factory for the near-scan graph traversal
    (/root/reference/yag_slam/graph_slam.py:32-39)."""
    distsq = distance**2

    def near_scan_visitor(first_node, current_node):
        return scans_dist_squared(first_node.obj, current_node.obj) < distsq

    return near_scan_visitor


class GraphSlam:
    """Online 2D graph SLAM (sequential matching + loop closure + SPA)."""

    def __init__(
        self,
        seq_matcher,
        loop_matcher,
        scan_buffer_len=10,
        loop_search_dist=3,
        loop_search_min_chain_size=10,
        min_response_coarse=0.35,
        min_response_fine=0.45,
        verbose=False,
        *,
        bug_compatible_fine_gate=False,
        bug_compatible_chain_gate=False,
        opt=None,
    ):
        self.seq_matcher = seq_matcher
        self.loop_matcher = loop_matcher

        self.scan_buffer_len = scan_buffer_len
        self.graph = Graph()

        self.loop_search_dist = loop_search_dist
        self.loop_search_min_chain_size = loop_search_min_chain_size
        self.near_scan_visitor = make_near_scan_visitor(loop_search_dist)

        self.running_scans = []
        # optimizer override: any SPA2d-contract solver drops in — e.g.
        # parallel.dist_spa.DistributedSPA for a mesh-sharded global solve
        # alongside a ShardedLoopMatcher (the fully sharded stack)
        self.opt = opt if opt is not None else SPA2d()

        self.search = RadiusHashSearch([], res=self.loop_search_dist)
        self.min_response_coarse = min_response_coarse
        self.min_response_fine = min_response_fine

        self.verbose = verbose
        self.bug_compatible_fine_gate = bug_compatible_fine_gate
        self.bug_compatible_chain_gate = bug_compatible_chain_gate

        # observability counters (the reference has only prints; SURVEY §5)
        self.stats = {
            "scans_processed": 0,
            "loop_closures": 0,
            "loop_chains_tried": 0,
            "opt_runs": 0,
            "opt_time_total": 0.0,
            "match_time_total": 0.0,
        }

    # -- factories -----------------------------------------------------------
    @classmethod
    def default(cls, **kwargs):
        """Build with default sequential + loop matcher configs (the
        reference's classmethod passes raw dicts where matcher objects are
        required — a bug we fix by constructing real matchers;
        /root/reference/yag_slam/graph_slam.py:73-75)."""
        return cls(
            CorrelativeScanMatcher(default_config),
            CorrelativeScanMatcher(default_config_loop, loop=True),
            **kwargs,
        )

    # -- serialization -------------------------------------------------------
    def serialize(self):
        out = {}
        out["scans"] = [_serialize(v.obj) for v in self.graph.vertices]
        out["edges"] = [
            [e.source.obj.num, e.target.obj.num, _serialize(e.info)]
            for e in self.graph.edges
        ]
        out["running_scans"] = [s.num for s in self.running_scans]
        out["seq_matcher_config"] = _serialize(self.seq_matcher.config)
        out["loop_matcher_config"] = (
            _serialize(self.loop_matcher.config) if self.loop_matcher else None
        )
        out["scan_buffer_len"] = self.scan_buffer_len
        out["loop_search_dist"] = self.loop_search_dist
        out["loop_search_min_chain_size"] = self.loop_search_min_chain_size
        out["min_response_coarse"] = self.min_response_coarse
        out["min_response_fine"] = self.min_response_fine
        return out

    def binarize(self):
        return zlib.compress(msgpack_lite.packb(self.serialize()))

    @classmethod
    def unbinarize(cls, blob):
        return cls.deserialize(msgpack_lite.unpackb(zlib.decompress(blob)))

    def to_file(self, path):
        with open(path, "wb") as ff:
            ff.write(self.binarize())

    @classmethod
    def from_file(cls, path):
        with open(path, "rb") as ff:
            return cls.unbinarize(ff.read())

    @classmethod
    def deserialize(cls, d):
        loop_matcher = (
            CorrelativeScanMatcher(
                {k: v for k, v in d["loop_matcher_config"].items() if k != "___name"}
            )
            if d["loop_matcher_config"]
            else None
        )
        obj = cls(
            CorrelativeScanMatcher(
                {k: v for k, v in d["seq_matcher_config"].items() if k != "___name"}
            ),
            loop_matcher,
            d["scan_buffer_len"],
            d["loop_search_dist"],
            d["loop_search_min_chain_size"],
            d["min_response_coarse"],
            d["min_response_fine"],
        )
        for s in d["scans"]:
            obj.add_vertex(_deserialize(s))

        vs = obj.graph.vertices
        for from_num, to_num, info in d["edges"]:
            new_edge = Edge(vs[from_num], vs[to_num], _deserialize(info))
            obj.graph.add_edge(new_edge)
            diff = new_edge.info.mean
            obj.opt.add_constraint(
                from_num,
                to_num,
                diff.x,
                diff.y,
                diff.euler[-1],
                np.linalg.inv(np.array(new_edge.info.covariance)).tolist(),
            )

        obj.running_scans = [vs[i].obj for i in d["running_scans"]]
        return obj

    # -- small utilities (reference surface parity) ---------------------------
    def _print_config(self):
        from yag_slam_tpu.core.config import print_config

        print_config(self.seq_matcher.config)

    @staticmethod
    def _ranges_from_scan(scan, flip_ranges):
        ranges = scan["ranges"] if isinstance(scan, dict) else scan.ranges
        if flip_ranges:
            ranges = ranges[::-1]
        return ranges

    def link_to_near_chains(self):
        raise NotImplementedError("might be needed for a more cohesive graph")

    # -- graph construction --------------------------------------------------
    def add_vertex(self, scan):
        vertex = Vertex(scan)
        self.graph.add_vertex(vertex)
        p = vertex.obj.corrected_pose
        self.opt.add_node(p.x, p.y, p.euler[-1], vertex.obj.num)
        self.search.add_new_element(vertex)

    def add_edges(self, scan, covariance):
        last_scan = self.running_scans[-1]
        self.link_scans(last_scan, scan, scan.corrected_pose, covariance)
        if self.loop_matcher:
            self.link_to_closest_scan_in_chain(
                scan, self.running_scans, scan.corrected_pose, covariance
            )

    def link_scans(self, from_scan, to_scan, mean, covariance, supl=None):
        to_vert = self.graph.vertices[to_scan.num]
        from_vert = self.graph.vertices[from_scan.num]
        for edge in from_vert.edges:
            if edge.target is to_vert:
                return  # already linked
        diff = to_scan.corrected_pose - from_scan.corrected_pose
        new_edge = Edge(from_vert, to_vert, LinkLabel(diff, covariance))
        self.graph.add_edge(new_edge)

        # the optimizer takes the information matrix
        # (reference inverts here too: graph_slam.py:177-178)
        self.opt.add_constraint(
            from_scan.num,
            to_scan.num,
            diff.x,
            diff.y,
            diff.euler[-1],
            np.linalg.inv(np.array(covariance)).tolist(),
        )

    def link_to_closest_scan_in_chain(self, scan, chain, mean, covariance, supl=None):
        closest = min(chain, key=lambda c: scans_dist_squared(c, scan))
        self.link_scans(closest, scan, mean, covariance, supl)

    # -- loop closure ----------------------------------------------------------
    def find_possible_loop_closure_chains(self, scan):
        """Candidate chains: consecutive-numbered old scans within the loop
        search radius, excluding scans already near-linked to the query
        (/root/reference/yag_slam/graph_slam.py:274-304)."""
        vert = self.graph.vertices[scan.num]
        near_linked = set(do_breadth_first_traversal(vert, self.near_scan_visitor))
        chains = []

        candidates = self.search.crude_radius_search(
            scan.corrected_pose, self.loop_search_dist
        )
        candidates.sort(key=lambda v: v.obj.num)

        dist_gate = (
            self.loop_search_dist
            if self.bug_compatible_chain_gate
            else self.loop_search_dist**2
        )

        current_chain = []
        # pairwise walk: the final candidate (the query itself, which always
        # has the highest num) is only ever seen as v2, matching the
        # reference's zip iteration (graph_slam.py:285)
        for v1, v2 in zip(candidates, candidates[1:]):
            other_scan = v1.obj
            if other_scan is scan or other_scan in near_linked:
                current_chain = []
                continue

            if scans_dist_squared(scan, other_scan) <= dist_gate:
                current_chain.append(other_scan)

            if len(current_chain) >= self.loop_search_min_chain_size:
                chains.append(current_chain)
                current_chain = []

            if (v2.obj.num - v1.obj.num) > 1:
                current_chain = []

        if current_chain:
            chains.append(current_chain)

        return chains

    def try_to_close_loop(self, scan):
        closed = False
        if not self.loop_matcher:
            return closed

        chains = self.find_possible_loop_closure_chains(scan)
        if chains and self.verbose:
            print(f"Found {len(chains)} chains for loop closure")

        # Coarse-match every candidate chain in ONE batched device dispatch
        # (the reference issues one C++ call per chain,
        # /root/reference/yag_slam/graph_slam.py:217-220); results are
        # independent, so first-accept semantics are preserved by walking
        # them in order below.
        if len(chains) > 1:
            coarse_results = self.loop_matcher.match_many(
                [(scan, chain) for chain in chains], penalty=False,
                do_fine=False,
            )
        elif chains:
            coarse_results = [
                self.loop_matcher.match_scan(scan, chains[0], False, False)
            ]
        else:
            coarse_results = []

        # Gate on coarse response, then fine-match the surviving chains in
        # one batched dispatch too.  First-accept semantics are unchanged:
        # results are walked in chain order and only the first passing
        # closure is linked (the reference computes the fine match lazily
        # per chain, /root/reference/yag_slam/graph_slam.py:233-254).
        survivors = []
        for chain, res_coarse in zip(chains, coarse_results):
            self.stats["loop_chains_tried"] += 1
            if res_coarse.response < self.min_response_coarse:
                if self.verbose:
                    print(
                        "Loop closure coarse response too low: "
                        f"{res_coarse.response} < {self.min_response_coarse}"
                    )
                continue

            if res_coarse.covariance[0][0] > 3.0 or res_coarse.covariance[1][1] > 3.0:
                print("WARN: coarse covariance too high during loop closure")

            tmpscan = scan.copy()
            tmpscan.corrected_pose = res_coarse.best_pose
            survivors.append((chain, res_coarse, tmpscan))

        if len(survivors) > 1:
            fine_results = self.seq_matcher.match_many(
                [(tmp, chain) for chain, _, tmp in survivors],
                penalty=False, do_fine=True,
            )
        elif survivors:
            chain, _, tmp = survivors[0]
            fine_results = [self.seq_matcher.match_scan(tmp, chain, False, True)]
        else:
            fine_results = []

        for (chain, res_coarse, tmpscan), res in zip(survivors, fine_results):
            if res.response < self.min_response_fine:
                if self.verbose:
                    print(f"Loop closure fine response too low: {res.response}")
                # Divergence from the reference: this gate always fires by
                # default (the reference only rejects when verbose is on —
                # guard-ordering bug at
                # /root/reference/yag_slam/graph_slam.py:238-240).
                if self.verbose or not self.bug_compatible_fine_gate:
                    continue

            scan.corrected_pose = res.best_pose
            self.link_to_closest_scan_in_chain(
                scan, chain, res.best_pose, res.covariance,
                supl={"coarse": res_coarse, "fine": res},
            )
            closed = True
            break

        if closed:
            if self.verbose:
                print("successful loop closure")
            self.stats["loop_closures"] += 1
            self.run_opt()

        return closed

    def run_opt(self):
        begin = time.time()
        self.opt.compute(100, 1.0e-4, True, 1.0e-9, 50)
        elapsed = time.time() - begin
        self.stats["opt_runs"] += 1
        self.stats["opt_time_total"] += elapsed
        if self.verbose:
            print(f"opt took {elapsed} seconds")

        for node, vtx in zip(self.opt.nodes, self.graph.vertices):
            vtx.obj.corrected_pose = Transform.from_pose2d(
                Pose2(node.x, node.y, node.yaw)
            )

        # incremental re-key (elements crossing a cell boundary only)
        # instead of the reference's full rebuild
        # (/root/reference/yag_slam/graph_slam.py:272)
        self.search.update_all()

    # -- main entry ------------------------------------------------------------
    def process_scan(self, scan):
        """Ingest one scan; returns (match_result, closed_loop) — (None,
        None) for the first scan (/root/reference/yag_slam/graph_slam.py:
        306-339)."""
        query = scan
        self.stats["scans_processed"] += 1

        if len(self.running_scans) == 0:
            query.num = 0
            self.running_scans.append(query)
            self.add_vertex(query)
            return None, None

        last_scan = self.running_scans[-1]
        query.num = last_scan.num + 1

        # dead-reckoned initial guess from odometry
        odom_diff = query.odom_pose - last_scan.odom_pose
        query.corrected_pose = last_scan.corrected_pose + odom_diff

        t0 = time.time()
        res = self.seq_matcher.match_scan(query, self.running_scans, True, True)
        self.stats["match_time_total"] += time.time() - t0
        query.corrected_pose = res.best_pose

        closed = self._post_match(query, res)
        return res, closed

    def _post_match(self, query, res):
        """Bookkeeping after a sequential match (the tail of
        process_scan): vertex + edges, loop closure, window update."""
        self.add_vertex(query)
        self.add_edges(query, res.covariance)

        closed = self.try_to_close_loop(query)

        self.running_scans.append(query)
        self.running_scans = self.running_scans[-self.scan_buffer_len:]
        return closed

    def process_scan_stream(self, scans, sync_every=8, block_dispatch=True):
        """Streaming bulk ingestion: sequential matching through the
        device-chained pipeline (matching/pipeline.py — with
        block_dispatch, one device program + one readback per
        `sync_every` scans), graph bookkeeping and loop closure at each
        sync boundary.

        Semantically equal to calling :meth:`process_scan` per scan: when
        a loop closure fires mid-block, the remaining matches of that
        block were computed against pre-optimization poses, so they are
        redone through the blocking path — exactly what the sequential
        loop would have produced — and the pipeline's device pose state
        is re-seeded from the optimized window.  Returns a list of
        (match_result, closed) aligned with `scans` ((None, None) for the
        very first scan of a fresh map)."""
        from yag_slam_tpu.matching.pipeline import OnlineMatchPipeline

        out = []
        pipe = None
        buf = []

        def flush_block():
            t0 = time.time()
            results = pipe.flush()
            self.stats["match_time_total"] += time.time() - t0
            redo_from = None
            for i, (scan, res) in enumerate(zip(buf, results)):
                self.stats["scans_processed"] += 1
                closed = self._post_match(scan, res)
                out.append((res, closed))
                if closed:
                    redo_from = i + 1
                    break
            if redo_from is not None:
                for scan in buf[redo_from:]:
                    last = self.running_scans[-1]
                    scan.corrected_pose = last.corrected_pose + (
                        scan.odom_pose - last.odom_pose
                    )
                    t0 = time.time()
                    res = self.seq_matcher.match_scan(
                        scan, self.running_scans, True, True
                    )
                    self.stats["match_time_total"] += time.time() - t0
                    scan.corrected_pose = res.best_pose
                    self.stats["scans_processed"] += 1
                    closed = self._post_match(scan, res)
                    out.append((res, closed))
                # re-align the pipeline's device poses with the
                # optimized window
                pipe.seed(self.running_scans)
            del buf[:]

        for scan in scans:
            if len(self.running_scans) == 0:
                scan.num = 0
                self.running_scans.append(scan)
                self.add_vertex(scan)
                self.stats["scans_processed"] += 1
                out.append((None, None))
                continue
            if pipe is None:
                pipe = OnlineMatchPipeline(
                    self.seq_matcher, window=self.scan_buffer_len,
                    sync_every=sync_every, block_dispatch=block_dispatch,
                )
                pipe.seed(self.running_scans)
            prev = buf[-1] if buf else self.running_scans[-1]
            scan.num = prev.num + 1
            pipe.push(scan)
            buf.append(scan)
            if len(buf) >= sync_every:
                flush_block()
        if pipe is not None and buf:
            flush_block()
        return out

    # -- mapping ---------------------------------------------------------------
    def make_occupancy_grid(self, resolution=0.05, range_threshold=12):
        from yag_slam_tpu.mapping.occupancy import create_occupancy_grid

        return create_occupancy_grid(
            [v.obj for v in self.graph.vertices], resolution, range_threshold
        )

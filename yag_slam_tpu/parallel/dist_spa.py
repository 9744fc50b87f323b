"""Distributed sparse pose adjustment.

The global SPA normal equations are a sum of independent per-edge
contributions: H = Σ_e J_e^T Ω_e J_e, b = Σ_e J_e^T Ω_e r_e.  Sharding the
edge list over a mesh axis makes every reduction a collective:

- **"cg" (default)** — matrix-free block-Jacobi-preconditioned CG: per LM
  iteration the rhs b, the block-diagonal preconditioner and every CG
  Hessian-vector product are assembled from the *local* edge shard and
  `psum`-reduced over the mesh.  Per-device memory is O(E/n_devices + N·3) —
  no (3N, 3N) object ever exists (asserted by
  tests/test_parallel.py::test_dist_spa_no_dense_hessian) — so the graph
  size is bounded by pose storage, not by a dense factorization.  This is
  the Schur-free distributed solve the scaling story needs: one psum per
  CG iteration, poses replicated, edges sharded.
- **"dense"** — psum the dense (3N, 3N) normal equations and factorize
  replicated.  Kept for small graphs and as a cross-check; per-device
  memory is O(N^2).

The reference has no distributed anything (SURVEY §2.3) — this is the
"long-trajectory" scaling story for multi-device lifelong mapping.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from yag_slam_tpu.graphopt.spa import (
    _lm_run_cg_impl,
    _wrap,
    build_normal_equations,
)


def _edge_cost_local(poses, eidx, means, infos, emask, axis):
    from yag_slam_tpu.graphopt.spa import edge_residuals

    r = edge_residuals(poses, eidx, means)
    per_edge = jnp.einsum("ei,eij,ej->e", r, infos, r)
    return jax.lax.psum(jnp.sum(jnp.where(emask, per_edge, 0.0)), axis)


def make_distributed_lm_run_cg(mesh, n_cap, max_iters, cg_iters, axis="dp",
                               mixed=True):
    """Build the sharded matrix-free LM program: edges sharded over `axis`,
    poses replicated, psum-reduced rhs/preconditioner/HVPs (see
    graphopt.spa._lm_candidate_cg).  mixed=True (default) runs the f32
    inner CG + f64 refinement step (graphopt.spa._lm_candidate_cg_mixed):
    the per-CG-iteration psum moves f32 bytes and the HVPs run at the f32
    rate, with one f64 psum per refinement step."""

    body = partial(
        _lm_run_cg_impl,
        n_cap=n_cap, max_iters=max_iters, cg_iters=cg_iters, axis_name=axis,
        mixed=mixed,
    )
    sharded = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(), P(), P(),
                  P()),
        out_specs=(P(), P(), P()),
    )
    return jax.jit(sharded)


def make_distributed_lm_run(mesh, n_cap, max_iters, axis="dp"):
    """The dense-replicated variant: psum the (3N, 3N) normal equations,
    factorize on every device.  O(N^2) per-device memory — small graphs /
    cross-checks only; the "cg" path is the scalable one."""

    def body_fn(poses, eidx, means, infos, emask, free_mask, lam0, tol):
        cost0 = _edge_cost_local(poses, eidx, means, infos, emask, axis)

        def cond(carry):
            _, _, _, it, done = carry
            return jnp.logical_and(jnp.logical_not(done), it < max_iters)

        def body(carry):
            p, cost, lam, it, _ = carry
            H_l, b_l = build_normal_equations(
                p, eidx, means, infos, emask, free_mask, n_cap=n_cap
            )
            H = jax.lax.psum(H_l, axis)
            b = jax.lax.psum(b_l, axis)
            d = jnp.diag(H)
            delta = jnp.linalg.solve(H + jnp.diag(lam * d), -b)
            delta = delta.reshape(n_cap, 3) * free_mask[:, None].astype(p.dtype)
            cand = p + delta
            cand = cand.at[:, 2].set(_wrap(cand[:, 2]))
            new_cost = _edge_cost_local(cand, eidx, means, infos, emask, axis)
            accept = jnp.isfinite(new_cost) & (new_cost <= cost)
            decrease = cost - new_cost
            p = jnp.where(accept, cand, p)
            new_lam = jnp.where(
                accept, jnp.maximum(lam * 0.5, 1.0e-12), lam * 4.0
            )
            done = (accept & (decrease < tol * jnp.maximum(new_cost, 1.0))) | (
                jnp.logical_not(accept) & (new_lam > 1.0e8)
            )
            cost = jnp.where(accept, new_cost, cost)
            return (p, cost, new_lam, it + 1, done)

        p, cost, _, iters, _ = jax.lax.while_loop(
            cond, body, (poses, cost0, lam0, jnp.int32(0), jnp.bool_(False))
        )
        return p, cost, iters

    sharded = shard_map(
        body_fn,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(), P(), P()),
        out_specs=(P(), P(), P()),
    )
    return jax.jit(sharded)


class DistributedSPA:
    """SPA2d-shaped solver whose normal-equation assembly shards edges over
    a device mesh.  Same add_node/add_constraint/compute contract as
    graphopt.spa.SPA2d.

    solver="cg" (default): matrix-free psum-reduced PCG, O(E/n + N) per
    device.  solver="dense": replicated dense factorization, small graphs
    only.
    """

    def __init__(self, mesh, axis="dp", dtype=None, solver="cg", mixed=True):
        from yag_slam_tpu.graphopt.spa import PoseGraphSolver

        self.mesh = mesh
        self.axis = axis
        self.solver = solver
        self.mixed = mixed  # f32 inner CG + f64 refinement (cg path)
        self._solver = PoseGraphSolver(dtype=dtype)
        self._programs = {}

    def add_node(self, x, y, yaw, node_id):
        self._solver.add_node(x, y, yaw, node_id)

    def add_constraint(self, from_id, to_id, dx, dy, dyaw, info):
        self._solver.add_constraint(from_id, to_id, dx, dy, dyaw, info)

    @property
    def nodes(self):
        from yag_slam_tpu.graphopt.spa import _NodeView

        return [_NodeView(x, y, yaw) for x, y, yaw in self._solver.poses]

    def compute(self, niter=100, s_lambda=1.0e-4, use_csparse=True,
                init_tol=1.0e-9, max_cg_iters=50, verbose=False,
                conv_tol=1.0e-4):
        from yag_slam_tpu.graphopt.spa import _cap

        s = self._solver
        n = len(s.poses)
        e = len(s.edge_idx)
        if n < 2 or e == 0:
            return 0.0
        n_dev = self.mesh.shape[self.axis]
        n_cap = _cap(n)
        e_cap = _cap(max(e, n_dev))
        e_cap = ((e_cap + n_dev - 1) // n_dev) * n_dev

        poses = np.zeros((n_cap, 3))
        poses[:n] = np.asarray(s.poses)
        eidx = np.zeros((e_cap, 2), dtype=np.int32)
        eidx[:e] = np.asarray(s.edge_idx, dtype=np.int32)
        means = np.zeros((e_cap, 3))
        means[:e] = np.asarray(s.edge_means)
        infos = np.zeros((e_cap, 3, 3))
        infos[:e] = np.stack(s.edge_infos)
        emask = np.zeros(e_cap, dtype=bool)
        emask[:e] = True
        free = np.zeros(n_cap, dtype=bool)
        free[1:n] = True

        key = (self.solver, n_cap, e_cap, niter, max_cg_iters, self.mixed)
        prog = self._programs.get(key)
        if prog is None:
            if self.solver == "cg":
                prog = make_distributed_lm_run_cg(
                    self.mesh, n_cap, niter, max_cg_iters, self.axis,
                    mixed=self.mixed,
                )
            else:
                prog = make_distributed_lm_run(
                    self.mesh, n_cap, niter, self.axis
                )
            self._programs[key] = prog

        # f64 poses and costs on device, as in PoseGraphSolver.optimize: the
        # mixed steps run f32 inner CG with f64 refinement
        with jax.enable_x64(True):
            dtype = s.dtype or jnp.float64
            # explicit shardings so inputs land directly on their shards (and
            # so host numpy values work under multi-process jax.distributed,
            # where jit cannot infer a global placement for them)
            from jax.sharding import NamedSharding

            rep = NamedSharding(self.mesh, P())
            shd = NamedSharding(self.mesh, P(self.axis))
            common = (
                jax.device_put(jnp.asarray(poses, dtype=dtype), rep),
                jax.device_put(jnp.asarray(eidx), shd),
                jax.device_put(jnp.asarray(means, dtype=dtype), shd),
                jax.device_put(jnp.asarray(infos, dtype=dtype), shd),
                jax.device_put(jnp.asarray(emask), shd),
                jax.device_put(jnp.asarray(free), rep),
                jax.device_put(jnp.asarray(s_lambda, dtype=dtype), rep),
            )
            if self.solver == "cg":
                final, cost, iters = prog(
                    *common,
                    jax.device_put(jnp.asarray(conv_tol, dtype=dtype), rep),
                    jax.device_put(jnp.asarray(init_tol, dtype=dtype), rep),
                )
            else:
                final, cost, iters = prog(
                    *common, jax.device_put(jnp.asarray(init_tol, dtype=dtype), rep)
                )
        out = np.asarray(final[:n], dtype=np.float64)
        for i in range(n):
            s.poses[i] = [float(out[i, 0]), float(out[i, 1]), float(out[i, 2])]
        if verbose:
            print(f"[dist-spa] {int(iters)} iters, chi2 {float(cost):.6g}")
        return float(cost)

"""Sparse pose adjustment: array-native SE(2) graph optimization.

The reference delegates this to the external C++ `sba_cpp.SPA2d`
(Konolige-style SPA; call sites /root/reference/yag_slam/graph_slam.py:23,
65,125-126,147,177-178,265,269-270).  Here the solver is a
Levenberg–Marquardt loop over batched SE(2) edge residuals: residuals,
analytic Jacobians and the normal-equations assembly are one jitted XLA
program (gathers + scatter-adds over the edge list), the damped system is
solved with a dense factorization on device, and the host only runs the
accept/reject damping logic.  Shapes are bucketed (capacity doubling) so the
online loop reuses compiled programs as the graph grows.

Conventions match the reference's usage:
- constraint mean = `to_pose - from_pose` in tiny_tf convention, i.e. the
  pose of `to` expressed in `from`'s frame
  (/root/reference/yag_slam/graph_slam.py:169);
- constraints carry an *information* matrix (callers invert the stored
  covariance: /root/reference/yag_slam/graph_slam.py:177-178);
- the first node added is the gauge (held fixed), as in SPA;
- `compute(niter, s_lambda, use_csparse, init_tol, max_cg_iters)` mirrors
  the reference's `opt.compute(100, 1.0e-4, True, 1.0e-9, 50)` call
  (/root/reference/yag_slam/graph_slam.py:265).
"""
from __future__ import annotations

from functools import partial, wraps

import numpy as np
import jax
import jax.numpy as jnp


def _wrap(theta):
    return theta - 2.0 * jnp.pi * jnp.floor((theta + jnp.pi) / (2.0 * jnp.pi))


def edge_residuals(poses, eidx, means):
    """Batched SE(2) edge residuals r_e = t2v(T_i^-1 T_j) - mean (E, 3)."""
    pi = poses[eidx[:, 0]]
    pj = poses[eidx[:, 1]]
    c, s = jnp.cos(pi[:, 2]), jnp.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    lt = pj[:, 2] - pi[:, 2]
    return jnp.stack(
        [lx - means[:, 0], ly - means[:, 1], _wrap(lt - means[:, 2])], axis=-1
    )


def edge_jacobians(poses, eidx):
    """Analytic Jacobians (E,3,3) of the residual wrt node i and node j."""
    pi = poses[eidx[:, 0]]
    pj = poses[eidx[:, 1]]
    c, s = jnp.cos(pi[:, 2]), jnp.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    Ji = jnp.stack(
        [
            jnp.stack([-c, -s, ly], axis=-1),
            jnp.stack([s, -c, -lx], axis=-1),
            jnp.stack([z, z, -o], axis=-1),
        ],
        axis=-2,
    )
    Jj = jnp.stack(
        [
            jnp.stack([c, s, z], axis=-1),
            jnp.stack([-s, c, z], axis=-1),
            jnp.stack([z, z, o], axis=-1),
        ],
        axis=-2,
    )
    return Ji, Jj


@partial(jax.jit, static_argnames=("n_cap",))
def graph_cost(poses, eidx, means, infos, emask, *, n_cap):
    r = edge_residuals(poses, eidx, means)
    per_edge = jnp.einsum("ei,eij,ej->e", r, infos, r)
    return jnp.sum(jnp.where(emask, per_edge, 0.0))


@partial(jax.jit, static_argnames=("n_cap",))
def build_normal_equations(poses, eidx, means, infos, emask, free_mask, *, n_cap):
    """Assemble H = J^T Ω J and b = J^T Ω r over the edge list.

    Returns H (3N,3N), b (3N,), with rows/cols of fixed or padded nodes
    replaced by identity/zero so they solve to a zero update.
    """
    N = n_cap
    r = edge_residuals(poses, eidx, means)
    Ji, Jj = edge_jacobians(poses, eidx)
    W = jnp.where(emask[:, None, None], infos, 0.0)

    JiW = jnp.einsum("eki,ekl->eil", Ji, W)  # Ji^T W  (E,3,3)
    JjW = jnp.einsum("eki,ekl->eil", Jj, W)

    Hii = jnp.einsum("eil,elj->eij", JiW, Ji)
    Hij = jnp.einsum("eil,elj->eij", JiW, Jj)
    Hjj = jnp.einsum("eil,elj->eij", JjW, Jj)
    bi = jnp.einsum("eil,el->ei", JiW, r)
    bj = jnp.einsum("eil,el->ei", JjW, r)

    i = eidx[:, 0]
    j = eidx[:, 1]
    Hb = jnp.zeros((N, N, 3, 3), dtype=poses.dtype)
    Hb = Hb.at[i, i].add(Hii)
    Hb = Hb.at[i, j].add(Hij)
    Hb = Hb.at[j, i].add(jnp.swapaxes(Hij, -1, -2))
    Hb = Hb.at[j, j].add(Hjj)
    b = jnp.zeros((N, 3), dtype=poses.dtype)
    b = b.at[i].add(bi)
    b = b.at[j].add(bj)

    # Gauge + padding: zero rows/cols, identity diagonal, zero rhs.
    fm = free_mask.astype(poses.dtype)
    Hb = Hb * fm[:, None, None, None] * fm[None, :, None, None]
    eye = jnp.eye(3, dtype=poses.dtype)
    Hb = Hb + jnp.einsum("n,ij->nij", 1.0 - fm, eye)[:, None] * jnp.eye(
        N, dtype=poses.dtype
    )[:, :, None, None]
    b = b * fm[:, None]

    H = Hb.transpose(0, 2, 1, 3).reshape(3 * N, 3 * N)
    return H, b.reshape(3 * N)


def _lm_candidate(poses, eidx, means, infos, emask, free_mask, lam, *, n_cap):
    """One damped step: solve (H + λ·diag(H))Δ = -b, return candidate poses
    and their cost.  (Standalone variant; the LM loop below reuses H, b
    across rejected steps instead of calling this.)"""
    H, b = build_normal_equations(
        poses, eidx, means, infos, emask, free_mask, n_cap=n_cap
    )
    cand = _damped_solve(H, b, poses, free_mask, lam)
    cost = graph_cost(cand, eidx, means, infos, emask, n_cap=n_cap)
    return cand, cost


lm_candidate = jax.jit(_lm_candidate, static_argnames=("n_cap",))


def _damped_solve(H, b, poses, free_mask, lam):
    """Solve (H + λ·diag(H))Δ = -b by Cholesky and apply the update.

    A non-PD damped system makes `cholesky` return NaNs, which poisons the
    candidate cost → the LM loop rejects the step and raises λ, so no
    explicit PD check is needed."""
    n_cap = poses.shape[0]
    d = jnp.diag(H)
    Haug = H + jnp.diag(lam * d)
    L = jnp.linalg.cholesky(Haug)
    delta = jax.scipy.linalg.cho_solve((L, True), -b).reshape(n_cap, 3)
    delta = delta * free_mask[:, None].astype(poses.dtype)
    cand = poses + delta
    return cand.at[:, 2].set(_wrap(cand[:, 2]))


@partial(jax.jit, static_argnames=("n_cap", "max_iters"))
def lm_run(poses, eidx, means, infos, emask, free_mask, lam0, ctol, *,
           n_cap, max_iters):
    """The full Levenberg–Marquardt loop as ONE device program.

    The reference's C++ solver iterates inside one native call
    (/root/reference/yag_slam/graph_slam.py:265); a host-driven loop here
    would pay a dispatch and a readback per iteration, so the
    accept/reject damping logic runs in a lax.while_loop on device and the
    host gets back only the final poses/cost/iteration count.

    Convergence: stop after an accepted step whose cost decrease is below
    `ctol` relative (+1e-15 absolute floor so exactly-consistent graphs
    terminate) — the same shape of test the C++ SPA uses rather than
    burning the full iteration budget.  Normal equations are assembled
    only when a step is accepted; rejected steps only re-factorize with a
    larger λ.
    """
    cost0 = graph_cost(poses, eidx, means, infos, emask, n_cap=n_cap)
    H0, b0 = build_normal_equations(
        poses, eidx, means, infos, emask, free_mask, n_cap=n_cap
    )

    def rebuild(p):
        return build_normal_equations(
            p, eidx, means, infos, emask, free_mask, n_cap=n_cap
        )

    def cond(carry):
        _, _, _, _, _, it, done = carry
        return jnp.logical_and(jnp.logical_not(done), it < max_iters)

    def body(carry):
        p, cost, H, b, lam, it, _ = carry
        cand = _damped_solve(H, b, p, free_mask, lam)
        new_cost = graph_cost(cand, eidx, means, infos, emask, n_cap=n_cap)
        accept = jnp.isfinite(new_cost) & (new_cost <= cost)
        decrease = cost - new_cost
        new_lam = jnp.where(
            accept, jnp.maximum(lam * (1.0 / 3.0), 1.0e-12), lam * 4.0
        )
        done = (accept & (decrease <= ctol * new_cost + 1.0e-15)) | (
            jnp.logical_not(accept) & (new_lam > 1.0e8)
        )
        p = jnp.where(accept, cand, p)
        cost = jnp.where(accept, new_cost, cost)
        H, b = jax.lax.cond(
            accept & jnp.logical_not(done), rebuild, lambda _: (H, b), p
        )
        return (p, cost, H, b, new_lam, it + 1, done)

    p, cost, _, _, _, iters, _ = jax.lax.while_loop(
        cond, body,
        (poses, cost0, H0, b0, lam0, jnp.int32(0), jnp.bool_(False)),
    )
    return p, cost, iters


def _edge_blocks(poses, eidx, means, infos, emask):
    """Per-edge residuals, Jacobians and masked weights (shared by the
    matrix-free path)."""
    r = edge_residuals(poses, eidx, means)
    Ji, Jj = edge_jacobians(poses, eidx)
    W = jnp.where(emask[:, None, None], infos, 0.0)
    return r, Ji, Jj, W


# ---------------------------------------------------------------------------
# Mixed-precision device steps.
#
# The pose-chain normal equations are ill-conditioned (cond ~ N^2), so a
# plain f32 Newton step is too inexact, while f64 arithmetic runs at a
# fraction of the f32 rate on most accelerators.  Classic iterative
# refinement splits the difference: factorize/iterate in f32, compute the
# residual of the damped system MATRIX-FREE in f64 (O(E) edge einsums, and
# no dense f64 object ever exists), and re-solve the correction in f32.
# Each refined step is f64-accurate once cond(Haug) * eps_f32 < 1, which
# Marquardt damping helps enforce; the LM accept/reject logic on the f64
# cost tolerates the remaining inexactness.  The f32 products are traced
# under matmul precision "highest" so that no backend may run them in a
# reduced-precision format (TF32 on NVIDIA GPUs keeps ~3 decimal digits).
# The distributed CG path (parallel/dist_spa.py) inherits the f32 inner
# iteration via the same code path (axis_name psums run in f32).
# ---------------------------------------------------------------------------


def _damped_system_f64(poses, eidx, means, infos, emask, free_mask, lam,
                       reduce=lambda x: x, blocks=None):
    """Damped normal equations in the poses' dtype, matrix-free: returns
    (b_neg (N,3), avp, diag (N,3), D (N,3,3)) with gauge/padding handled
    as in the dense assembly (identity rows scaled by (1 + lam)).
    `reduce` psums edge-shard partials under shard_map; `blocks` lets the
    caller reuse precomputed `_edge_blocks` output."""
    dtype = poses.dtype
    n_cap = poses.shape[0]
    r, Ji, Jj, W = (blocks if blocks is not None
                    else _edge_blocks(poses, eidx, means, infos, emask))
    fm = free_mask.astype(dtype)
    JiWr = jnp.einsum("eji,ejl,el->ei", Ji, W, r)
    JjWr = jnp.einsum("eji,ejl,el->ei", Jj, W, r)
    b = jnp.zeros((n_cap, 3), dtype=dtype)
    b = b.at[eidx[:, 0]].add(JiWr)
    b = b.at[eidx[:, 1]].add(JjWr)
    b_neg = -reduce(b) * fm[:, None]
    D = _hessian_diag_blocks(Ji, Jj, W, eidx, free_mask, n_cap, dtype,
                             reduce=reduce)
    diag = jnp.diagonal(D, axis1=-2, axis2=-1)  # (N, 3) = diag(H)
    hvp = _make_hvp(Ji, Jj, W, eidx, free_mask, n_cap, dtype, reduce=reduce)

    def avp(v):
        # identity rows for fixed/padded nodes also get the + lam*diag
        # term (diag = 1 there), matching Haug = H + lam*diag(H) exactly
        return hvp(v) + lam * diag * v

    return b_neg, avp, diag, D


def _f32_highest(fn):
    """Trace `fn` with matmul precision "highest" (see the section note)."""
    @wraps(fn)
    def traced(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return traced


@_f32_highest
def _lm_candidate_mixed(poses, eidx, means, infos, emask, free_mask, lam,
                        *, n_cap, refine_iters=2):
    """One damped LM step: f32 Cholesky factorization + f64 matrix-free
    iterative refinement.  Returns (candidate poses, f64 cost)."""
    f32 = jnp.float32
    # f32 dense system for the factorization only
    H32, _ = build_normal_equations(
        poses.astype(f32), eidx, means.astype(f32), infos.astype(f32),
        emask, free_mask, n_cap=n_cap,
    )
    d32 = jnp.diag(H32)
    L32 = jnp.linalg.cholesky(H32 + jnp.diag(lam.astype(f32) * d32))

    b_neg, avp, _, _ = _damped_system_f64(
        poses, eidx, means, infos, emask, free_mask, lam
    )

    def solve32(rhs64):
        delta = jax.scipy.linalg.cho_solve(
            (L32, True), rhs64.reshape(-1).astype(f32)
        )
        return delta.astype(poses.dtype).reshape(n_cap, 3)

    x = solve32(b_neg)
    for _ in range(refine_iters):
        resid = b_neg - avp(x)
        x = x + solve32(resid)

    fm = free_mask.astype(poses.dtype)
    cand = poses + x * fm[:, None]
    cand = cand.at[:, 2].set(_wrap(cand[:, 2]))
    cost = graph_cost(cand, eidx, means, infos, emask, n_cap=n_cap)
    return cand, cost


@partial(jax.jit, static_argnames=("n_cap", "max_iters", "refine_iters"))
def lm_run_mixed(poses, eidx, means, infos, emask, free_mask, lam0, ctol, *,
                 n_cap, max_iters, refine_iters=2):
    """Full LM loop with mixed-precision dense steps as ONE device
    program (same accept/convergence logic as lm_run)."""
    cost0 = graph_cost(poses, eidx, means, infos, emask, n_cap=n_cap)

    def cond(carry):
        _, _, _, it, done = carry
        return jnp.logical_and(jnp.logical_not(done), it < max_iters)

    def body(carry):
        p, cost, lam, it, _ = carry
        cand, new_cost = _lm_candidate_mixed(
            p, eidx, means, infos, emask, free_mask, lam,
            n_cap=n_cap, refine_iters=refine_iters,
        )
        accept = jnp.isfinite(new_cost) & (new_cost <= cost)
        decrease = cost - new_cost
        p = jnp.where(accept, cand, p)
        new_lam = jnp.where(
            accept, jnp.maximum(lam * (1.0 / 3.0), 1.0e-12), lam * 4.0
        )
        done = (accept & (decrease <= ctol * new_cost + 1.0e-15)) | (
            jnp.logical_not(accept) & (new_lam > 1.0e8)
        )
        cost = jnp.where(accept, new_cost, cost)
        return (p, cost, new_lam, it + 1, done)

    p, cost, _, iters, _ = jax.lax.while_loop(
        cond, body, (poses, cost0, lam0, jnp.int32(0), jnp.bool_(False))
    )
    return p, cost, iters


def _hessian_diag_blocks(Ji, Jj, W, eidx, free_mask, n_cap, dtype,
                         reduce=lambda x: x):
    """Block-diagonal of H as (N, 3, 3) — the PCG preconditioner and the
    Marquardt damping diagonal.  `reduce` sums edge-shard partials across
    the mesh (identity on a single device); gauge handling is applied
    *after* the reduction so identity rows are not multiplied by the
    device count."""
    Dii = jnp.einsum("eki,ekl,elj->eij", Ji, W, Ji)
    Djj = jnp.einsum("eki,ekl,elj->eij", Jj, W, Jj)
    D = jnp.zeros((n_cap, 3, 3), dtype=dtype)
    D = D.at[eidx[:, 0]].add(Dii)
    D = D.at[eidx[:, 1]].add(Djj)
    D = reduce(D)
    fm = free_mask.astype(dtype)
    eye = jnp.eye(3, dtype=dtype)
    return D * fm[:, None, None] + (1.0 - fm)[:, None, None] * eye


def _make_hvp(Ji, Jj, W, eidx, free_mask, n_cap, dtype,
              reduce=lambda x: x):
    """Matrix-free H @ v over the (possibly sharded) edge list (v: (N, 3))."""
    i = eidx[:, 0]
    j = eidx[:, 1]
    fm = free_mask.astype(dtype)

    def hvp(v):
        # fixed/padded nodes act as identity rows (consistent with the
        # dense assembly's gauge handling); their rhs is zero so any
        # nonsingular scaling works.  The identity term is added after
        # the cross-device reduction.
        vf = v * fm[:, None]
        Jiv = jnp.einsum("eij,ej->ei", Ji, vf[i])
        Jjv = jnp.einsum("eij,ej->ei", Jj, vf[j])
        Wr = jnp.einsum("eij,ej->ei", W, Jiv + Jjv)
        JiWr = jnp.einsum("eji,ej->ei", Ji, Wr)
        JjWr = jnp.einsum("eji,ej->ei", Jj, Wr)
        out = jnp.zeros((n_cap, 3), dtype=dtype)
        out = out.at[i].add(JiWr)
        out = out.at[j].add(JjWr)
        return reduce(out) * fm[:, None] + (1.0 - fm)[:, None] * v

    return hvp


def _inv3x3(m):
    """Batched closed-form 3x3 inverse, any float dtype."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    Ii = a * e - b * d
    det = a * A + b * B + c * C
    adj = jnp.stack(
        [jnp.stack([A, D, G], axis=-1),
         jnp.stack([B, E, H], axis=-1),
         jnp.stack([C, F, Ii], axis=-1)], axis=-2,
    )
    return adj / det[..., None, None]


def _lm_candidate_cg(poses, eidx, means, infos, emask, free_mask, lam,
                     cg_rtol, *, n_cap, cg_iters, axis_name=None):
    """Damped step via block-Jacobi-preconditioned conjugate gradients —
    the matrix-free path for graphs where a dense 3Nx3N factorization no
    longer makes sense.

    With `axis_name` set (inside shard_map), the edge arrays are the local
    shard and every edge reduction (rhs, preconditioner diagonal, HVP,
    cost) is psum-reduced over the mesh axis: per-device memory is
    O(E/n_devices + N) and one collective runs per CG iteration —
    no (3N, 3N) object ever exists (see parallel/dist_spa.py and
    tests/test_parallel.py::test_dist_spa_no_dense_hessian)."""
    dtype = poses.dtype
    r, Ji, Jj, W = _edge_blocks(poses, eidx, means, infos, emask)
    fm = free_mask.astype(dtype)

    def _reduce(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    b = jnp.zeros((n_cap, 3), dtype=dtype)
    JiWr = jnp.einsum("eji,ejl,el->ei", Ji, W, r)
    JjWr = jnp.einsum("eji,ejl,el->ei", Jj, W, r)
    b = b.at[eidx[:, 0]].add(JiWr)
    b = b.at[eidx[:, 1]].add(JjWr)
    b = -_reduce(b) * fm[:, None]

    D = _hessian_diag_blocks(Ji, Jj, W, eidx, free_mask, n_cap, dtype,
                             reduce=_reduce)
    hvp = _make_hvp(Ji, Jj, W, eidx, free_mask, n_cap, dtype,
                    reduce=_reduce)
    # Marquardt damping on the block diagonal
    damped_diag = D + lam * D * jnp.eye(3, dtype=dtype)[None]

    def avp(v):
        base = hvp(v)
        extra = lam * jnp.einsum(
            "nij,nj->ni", D * jnp.eye(3, dtype=dtype)[None], v
        )
        return base + extra * fm[:, None]

    # closed-form 3x3 block inverse (adjugate/determinant): batched tiny
    # inverses are cheaper in closed form than through a batched LU
    Minv = _inv3x3(damped_diag + 1e-12 * jnp.eye(3, dtype=dtype)[None])

    def precond(v):
        return jnp.einsum("nij,nj->ni", Minv, v)

    def dot(a, bb):
        return jnp.sum(a * bb)

    x = jnp.zeros_like(b)
    res = b - avp(x)
    z = precond(res)
    p = z
    rz = dot(res, z)
    rr0 = dot(res, res)

    def body(carry):
        x, res, p, rz, it = carry
        Ap = avp(p)
        alpha = rz / jnp.maximum(dot(p, Ap), 1e-30)
        x = x + alpha * p
        res = res - alpha * Ap
        z = precond(res)
        rz_new = dot(res, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, res, p, rz_new, it + 1)

    def cond(carry):
        _, res, _, _, it = carry
        # relative residual stop (the C++ SPA's initTol plays this role)
        return jnp.logical_and(
            it < cg_iters,
            dot(res, res) > jnp.maximum(cg_rtol * cg_rtol * rr0, 1e-30),
        )

    x, _, _, _, _ = jax.lax.while_loop(cond, body, (x, res, p, rz, 0))

    delta = x * fm[:, None]
    cand = poses + delta
    cand = cand.at[:, 2].set(_wrap(cand[:, 2]))
    rr = edge_residuals(cand, eidx, means)
    per_edge = jnp.einsum("ei,eij,ej->e", rr, infos, rr)
    cost = _reduce(jnp.sum(jnp.where(emask, per_edge, 0.0)))
    return cand, cost


@_f32_highest
def _lm_candidate_cg_mixed(poses, eidx, means, infos, emask, free_mask, lam,
                           cg_rtol, *, n_cap, cg_iters, refine_iters=2,
                           axis_name=None):
    """Damped LM step via f32 block-Jacobi PCG + f64 matrix-free iterative
    refinement — the mixed-precision sibling of `_lm_candidate_cg` (same
    gauge conventions, same lam*diag(H) damping as the dense paths).

    The inner CG runs entirely in f32, and under `axis_name` its
    per-iteration psum moves half the bytes of an f64 one.  The outer loop
    recomputes the damped-system residual matrix-free in f64 (O(E); one
    f64 psum per refinement step) and re-solves the correction in f32, so
    each refined step is f64-accurate while the FLOPs stay f32."""
    dtype = poses.dtype
    f32 = jnp.float32

    def _red(x):
        return jax.lax.psum(x, axis_name) if axis_name else x

    fm = free_mask.astype(dtype)
    blocks = _edge_blocks(poses, eidx, means, infos, emask)
    r, Ji, Jj, W = blocks

    # f64 rhs, damping diagonal and matrix-free damped operator (shared
    # assembly with the dense-mixed path)
    b_neg, avp64, diag, D = _damped_system_f64(
        poses, eidx, means, infos, emask, free_mask, lam,
        reduce=_red, blocks=blocks,
    )

    # f32 inner operator + block-Jacobi preconditioner
    fm32 = free_mask.astype(f32)
    lam32 = lam.astype(f32)
    diag32 = diag.astype(f32)
    hvp32 = _make_hvp(Ji.astype(f32), Jj.astype(f32), W.astype(f32), eidx,
                      free_mask, n_cap, f32, reduce=_red)

    def avp32(v):
        return hvp32(v) + lam32 * diag32 * v

    eye = jnp.eye(3, dtype=dtype)[None]
    M = D + lam * D * eye  # damped block diagonal (lam*diag on-diagonal)
    Minv32 = _inv3x3(M.astype(f32) + 1e-12 * eye.astype(f32))

    def precond(v):
        return jnp.einsum("nij,nj->ni", Minv32, v)

    def dot(a, bb):
        return jnp.sum(a * bb)

    def solve32(rhs64):
        rhs = (rhs64 * fm[:, None]).astype(f32)
        x = jnp.zeros_like(rhs)
        res = rhs  # x0 = 0
        z = precond(res)
        p = z
        rz = dot(res, z)
        rr0 = dot(res, res)

        def body(carry):
            x, res, p, rz, it = carry
            Ap = avp32(p)
            alpha = rz / jnp.maximum(dot(p, Ap), 1e-30)
            x = x + alpha * p
            res = res - alpha * Ap
            z = precond(res)
            rz_new = dot(res, z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return (x, res, p, rz_new, it + 1)

        def cond(carry):
            _, res, _, _, it = carry
            return jnp.logical_and(
                it < cg_iters,
                dot(res, res)
                > jnp.maximum((cg_rtol * cg_rtol).astype(f32) * rr0, 1e-30),
            )

        x, _, _, _, _ = jax.lax.while_loop(cond, body, (x, res, p, rz, 0))
        return (x * fm32[:, None]).astype(dtype)

    x = solve32(b_neg)
    for _ in range(refine_iters):
        x = x + solve32(b_neg - avp64(x))

    cand = poses + x * fm[:, None]
    cand = cand.at[:, 2].set(_wrap(cand[:, 2]))
    rr = edge_residuals(cand, eidx, means)
    per_edge = jnp.einsum("ei,eij,ej->e", rr, infos, rr)
    cost = _red(jnp.sum(jnp.where(emask, per_edge, 0.0)))
    return cand, cost


def _lm_run_cg_impl(poses, eidx, means, infos, emask, free_mask, lam0, ctol,
                    cg_rtol, *, n_cap, max_iters, cg_iters, axis_name=None,
                    mixed=False, refine_iters=2):
    """LM loop with matrix-free PCG steps, fused into one device program.
    Same accept/convergence logic as `lm_run`.  With `axis_name`, edge
    arrays are mesh shards and reductions ride psum (the distributed SPA
    path, parallel/dist_spa.py).  With `mixed`, each step runs the f32
    inner CG + f64 refinement (`_lm_candidate_cg_mixed`)."""
    r0 = edge_residuals(poses, eidx, means)
    pe0 = jnp.einsum("ei,eij,ej->e", r0, infos, r0)
    cost0 = jnp.sum(jnp.where(emask, pe0, 0.0))
    if axis_name:
        cost0 = jax.lax.psum(cost0, axis_name)

    def cond(carry):
        _, _, _, it, done = carry
        return jnp.logical_and(jnp.logical_not(done), it < max_iters)

    def body(carry):
        p, cost, lam, it, _ = carry
        if mixed:
            cand, new_cost = _lm_candidate_cg_mixed(
                p, eidx, means, infos, emask, free_mask, lam, cg_rtol,
                n_cap=n_cap, cg_iters=cg_iters, refine_iters=refine_iters,
                axis_name=axis_name,
            )
        else:
            cand, new_cost = _lm_candidate_cg(
                p, eidx, means, infos, emask, free_mask, lam, cg_rtol,
                n_cap=n_cap, cg_iters=cg_iters, axis_name=axis_name,
            )
        accept = jnp.isfinite(new_cost) & (new_cost <= cost)
        decrease = cost - new_cost
        p = jnp.where(accept, cand, p)
        new_lam = jnp.where(
            accept, jnp.maximum(lam * (1.0 / 3.0), 1.0e-12), lam * 4.0
        )
        done = (accept & (decrease <= ctol * new_cost + 1.0e-15)) | (
            jnp.logical_not(accept) & (new_lam > 1.0e8)
        )
        cost = jnp.where(accept, new_cost, cost)
        return (p, cost, new_lam, it + 1, done)

    p, cost, _, iters, _ = jax.lax.while_loop(
        cond, body, (poses, cost0, lam0, jnp.int32(0), jnp.bool_(False))
    )
    return p, cost, iters


lm_run_cg = jax.jit(
    _lm_run_cg_impl, static_argnames=("n_cap", "max_iters", "cg_iters",
                                      "axis_name", "mixed", "refine_iters")
)


def _cap(n, minimum=16):
    c = minimum
    while c < n:
        c *= 2
    return c


# ---------------------------------------------------------------------------
# Host solver: sparse f64 LM for small/medium graphs.
#
# The normal equations of a pose chain are ill-conditioned (cond ~ N^2), so
# f32 Newton steps degrade LM to slow linear convergence.  At a few hundred
# to a few thousand nodes the solve is latency-bound, not FLOP-bound.  So
# the default path mirrors what the reference gets from CSparse inside
# sba_cpp (reference yag_slam/graph_slam.py:265 — `useCSparse=True`):
# exact sparse f64 Cholesky/LU on the host, vectorized numpy edge assembly.
# The device paths (dense f32/f64, matrix-free PCG, the distributed solve
# in parallel/dist_spa.py) remain for graphs where FLOPs dominate.
# ---------------------------------------------------------------------------

def _np_wrap(t):
    return t - 2.0 * np.pi * np.floor((t + np.pi) / (2.0 * np.pi))


def _np_residuals(poses, eidx, means):
    pi = poses[eidx[:, 0]]
    pj = poses[eidx[:, 1]]
    c, s = np.cos(pi[:, 2]), np.sin(pi[:, 2])
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    lx = c * dx + s * dy
    ly = -s * dx + c * dy
    r = np.stack(
        [lx - means[:, 0], ly - means[:, 1],
         _np_wrap(pj[:, 2] - pi[:, 2] - means[:, 2])], axis=-1
    )
    return r, lx, ly, c, s


def _np_cost(poses, eidx, means, infos):
    r, *_ = _np_residuals(poses, eidx, means)
    return float(np.einsum("ei,eij,ej->", r, infos, r))


def _host_lm(poses, eidx, means, infos, max_iters, lam0, conv_tol):
    """LM with exact sparse f64 steps on host.  poses (N,3) f64 (node 0 is
    the gauge), eidx (E,2) int, means (E,3), infos (E,3,3).  Returns
    (poses, cost, iters, reason) with reason in {"converged", "max_iters",
    "lambda_blowup", "empty"}."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = poses.shape[0]
    nf = n - 1  # free nodes (gauge excluded)
    if nf < 1:
        return poses, 0.0, 0, "empty"

    # A free node with no incident constraints makes H structurally
    # singular (the device paths give such nodes identity rows; splu would
    # raise or factor garbage).  Pin them with a unit diagonal — their rhs
    # is zero, so they solve to a zero update, same as the device paths.
    degree = np.zeros(n, dtype=np.int64)
    np.add.at(degree, eidx.ravel(), 1)
    dangling = np.zeros(3 * nf)
    iso = np.flatnonzero(degree[1:] == 0)
    if iso.size:
        dangling[np.repeat(3 * iso, 3) + np.tile(np.arange(3), iso.size)] = 1.0

    def assemble(p):
        r, lx, ly, c, s = _np_residuals(p, eidx, means)
        E = eidx.shape[0]
        z = np.zeros(E)
        o = np.ones(E)
        Ji = np.empty((E, 3, 3))
        Ji[:, 0] = np.stack([-c, -s, ly], axis=-1)
        Ji[:, 1] = np.stack([s, -c, -lx], axis=-1)
        Ji[:, 2] = np.stack([z, z, -o], axis=-1)
        Jj = np.empty((E, 3, 3))
        Jj[:, 0] = np.stack([c, s, z], axis=-1)
        Jj[:, 1] = np.stack([-s, c, z], axis=-1)
        Jj[:, 2] = np.stack([z, z, o], axis=-1)
        JiW = np.einsum("eki,ekl->eil", Ji, infos)
        JjW = np.einsum("eki,ekl->eil", Jj, infos)
        blocks = np.concatenate(
            [
                np.einsum("eil,elj->eij", JiW, Ji),
                np.einsum("eil,elj->eij", JiW, Jj),
                np.einsum("eil,elj->eij", JjW, Ji),
                np.einsum("eil,elj->eij", JjW, Jj),
            ]
        )
        bi = np.einsum("eil,el->ei", JiW, r)
        bj = np.einsum("eil,el->ei", JjW, r)

        rows_n = np.concatenate(
            [eidx[:, 0], eidx[:, 0], eidx[:, 1], eidx[:, 1]]
        )
        cols_n = np.concatenate(
            [eidx[:, 0], eidx[:, 1], eidx[:, 0], eidx[:, 1]]
        )
        # drop gauge rows/cols; remap node k -> free index k-1
        keep = (rows_n > 0) & (cols_n > 0)
        blocks = blocks[keep]
        rows_n = rows_n[keep] - 1
        cols_n = cols_n[keep] - 1
        # expand 3x3 blocks to scalar COO
        off = np.arange(3)
        rr = np.broadcast_to(
            3 * rows_n[:, None, None] + off[None, :, None], blocks.shape
        ).ravel()
        cc = np.broadcast_to(
            3 * cols_n[:, None, None] + off[None, None, :], blocks.shape
        ).ravel()
        H = sp.coo_matrix(
            (blocks.ravel(), (rr, cc)), shape=(3 * nf, 3 * nf)
        ).tocsc()
        if iso.size:
            H = H + sp.diags(dangling)
        b = np.zeros((n, 3))
        np.add.at(b, eidx[:, 0], bi)
        np.add.at(b, eidx[:, 1], bj)
        return H, b[1:].ravel()

    p = poses.copy()
    cost = _np_cost(p, eidx, means, infos)
    lam = lam0
    it = 0
    reason = "max_iters"
    H, b = assemble(p)
    while it < max_iters:
        it += 1
        d = np.maximum(H.diagonal(), 1e-12)
        try:
            lu = spla.splu((H + lam * sp.diags(d)).tocsc())
            delta = lu.solve(-b)
        except RuntimeError:
            delta = None
        accept = False
        if delta is not None and np.all(np.isfinite(delta)):
            cand = p.copy()
            cand[1:] += delta.reshape(nf, 3)
            cand[:, 2] = _np_wrap(cand[:, 2])
            new_cost = _np_cost(cand, eidx, means, infos)
            accept = np.isfinite(new_cost) and new_cost <= cost
        if accept:
            decrease = cost - new_cost
            p, cost = cand, new_cost
            lam = max(lam / 3.0, 1e-12)
            if decrease <= conv_tol * new_cost + 1e-15:
                reason = "converged"
                break
            H, b = assemble(p)
        else:
            lam *= 4.0
            if lam > 1e8:
                reason = "lambda_blowup"
                break
    return p, cost, it, reason


class PoseGraphSolver:
    """Array-native LM solver over growing node/edge arrays.

    `solver`:
      - "host"  — exact sparse f64 LM on the host CPU (vectorized numpy
        assembly + SuperLU).  The low-latency choice: at online-SLAM graph
        sizes the solve is latency-bound and f32 device steps are too
        inexact for the chain-conditioned normal equations (see _host_lm).
      - "dense" — device Cholesky of the full 3Nx3N system (f64 on device),
        the whole LM loop as one XLA program.
      - "cg"    — device matrix-free block-Jacobi PCG over the edge list;
        the building block of the distributed Schur path
        (parallel/dist_spa.py) for graphs too large for a dense solve.
      - "auto"  — host below AUTO_HOST_NODE_LIMIT nodes, device above
        (dense up to dense_node_limit, then matrix-free PCG).
    """

    DENSE_NODE_LIMIT = 1024
    # Host/device crossover: NOT measured on the GPU yet (profile_spa.py
    # times host, dense and cg side by side).  Until it is, every graph a
    # single process builds goes to the host sparse path.
    AUTO_HOST_NODE_LIMIT = 65536

    def __init__(self, dtype=None, solver="auto", dense_node_limit=None,
                 auto_host_limit=None, precision="mixed"):
        self.dtype = dtype  # None -> jax default (x64 on CPU tests)
        self.solver = solver
        # precision applies to the DEVICE paths only: "mixed" (default)
        # runs f32 factorization/CG + f64 matrix-free iterative
        # refinement; "f64" forces the all-f64 steps.  The host path is
        # always sparse f64.
        self.precision = precision
        self.dense_node_limit = dense_node_limit or self.DENSE_NODE_LIMIT
        self.auto_host_limit = auto_host_limit or self.AUTO_HOST_NODE_LIMIT
        self.poses = []  # python lists; packed per solve
        self.edge_idx = []
        self.edge_means = []
        self.edge_infos = []
        self.id_to_index = {}
        self._order = []  # insertion order of ids

    # -- graph construction -------------------------------------------------
    def add_node(self, x, y, yaw, node_id):
        if node_id in self.id_to_index:
            raise ValueError(f"duplicate node id {node_id}")
        self.id_to_index[node_id] = len(self.poses)
        self._order.append(node_id)
        self.poses.append([float(x), float(y), float(yaw)])

    def add_constraint(self, from_id, to_id, dx, dy, dyaw, info):
        self.edge_idx.append(
            [self.id_to_index[from_id], self.id_to_index[to_id]]
        )
        self.edge_means.append([float(dx), float(dy), float(dyaw)])
        self.edge_infos.append(np.asarray(info, dtype=np.float64))

    def set_pose(self, node_id, x, y, yaw):
        self.poses[self.id_to_index[node_id]] = [float(x), float(y), float(yaw)]

    def _use_host(self, n):
        if self.solver == "host":
            return True
        return self.solver == "auto" and n <= self.auto_host_limit

    # -- solve --------------------------------------------------------------
    def optimize(self, max_iters=100, init_lambda=1.0e-4, tol=1.0e-9,
                 verbose=False, max_cg_iters=50, conv_tol=1.0e-4):
        """Run LM to convergence.

        `conv_tol` is the LM stop: relative cost decrease of an accepted
        step (all paths).  `tol` is the CG relative-residual stop and only
        affects the device "cg"/distributed paths (the C++ SPA's initTol
        plays the same role); the host and dense paths solve exactly.
        """
        n = len(self.poses)
        e = len(self.edge_idx)
        if n < 2 or e == 0:
            return 0.0

        if self._use_host(n):
            p = np.asarray(self.poses, dtype=np.float64)
            out, cost, iters, reason = _host_lm(
                p,
                np.asarray(self.edge_idx, dtype=np.int64),
                np.asarray(self.edge_means, dtype=np.float64),
                np.stack(self.edge_infos),
                max_iters, init_lambda, conv_tol,
            )
            if verbose:
                print(f"[spa] {reason} after {iters} iters, chi2 {cost:.6g}")
            for i in range(n):
                self.poses[i] = [float(out[i, 0]), float(out[i, 1]),
                                 float(out[i, 2])]
            return cost

        n_cap = _cap(n)
        e_cap = _cap(e)

        poses = np.zeros((n_cap, 3))
        poses[:n] = np.asarray(self.poses)
        eidx = np.zeros((e_cap, 2), dtype=np.int32)
        eidx[:e] = np.asarray(self.edge_idx, dtype=np.int32)
        means = np.zeros((e_cap, 3))
        means[:e] = np.asarray(self.edge_means)
        infos = np.zeros((e_cap, 3, 3))
        infos[:e] = np.stack(self.edge_infos)
        emask = np.zeros(e_cap, dtype=bool)
        emask[:e] = True
        free = np.zeros(n_cap, dtype=bool)
        free[1:n] = True  # node 0 is the gauge

        use_cg = self.solver == "cg" or (
            self.solver == "auto" and n > self.dense_node_limit
        )
        # The normal equations of a long chain are ill-conditioned
        # (cond ~ N^2); in f32 the Newton steps are inexact enough to
        # degrade LM to slow linear convergence.  So the solve carries f64
        # poses and costs ("f64": every step in f64; "mixed": f32
        # factorization with f64 refinement), while the scan-matching hot
        # path elsewhere stays f32.
        # jax.enable_x64 is scoped: the f64 trace is cached across calls.
        with jax.enable_x64(True):
            dtype = self.dtype or jnp.float64
            poses_j = jnp.asarray(poses, dtype=dtype)
            args = (
                jnp.asarray(eidx),
                jnp.asarray(means, dtype=dtype),
                jnp.asarray(infos, dtype=dtype),
                jnp.asarray(emask),
            )
            free_j = jnp.asarray(free)
            mixed = self.precision == "mixed"
            if use_cg:
                final_poses, cost, iters = lm_run_cg(
                    poses_j, *args, free_j,
                    jnp.asarray(init_lambda, dtype=dtype),
                    jnp.asarray(conv_tol, dtype=dtype),
                    jnp.asarray(tol, dtype=dtype),
                    n_cap=n_cap, max_iters=max_iters, cg_iters=max_cg_iters,
                    mixed=mixed,
                )
            elif mixed:
                final_poses, cost, iters = lm_run_mixed(
                    poses_j, *args, free_j,
                    jnp.asarray(init_lambda, dtype=dtype),
                    jnp.asarray(conv_tol, dtype=dtype),
                    n_cap=n_cap, max_iters=max_iters,
                )
            else:
                final_poses, cost, iters = lm_run(
                    poses_j, *args, free_j,
                    jnp.asarray(init_lambda, dtype=dtype),
                    jnp.asarray(conv_tol, dtype=dtype),
                    n_cap=n_cap, max_iters=max_iters,
                )
            cost = float(cost)
        if verbose:
            print(f"[spa] stopped after {int(iters)} iters, chi2 {cost:.6g}")

        out = np.asarray(final_poses[:n], dtype=np.float64)
        for i in range(n):
            self.poses[i] = [float(out[i, 0]), float(out[i, 1]), float(out[i, 2])]
        return cost


class _NodeView:
    __slots__ = ("x", "y", "yaw")

    def __init__(self, x, y, yaw):
        self.x = x
        self.y = y
        self.yaw = yaw


class SPA2d:
    """Facade with the reference's C++ SPA2d surface
    (add_node/add_constraint/compute/.nodes — call sites
    /root/reference/yag_slam/graph_slam.py:65,125-126,147,177-178,265,
    269-270)."""

    def __init__(self, dtype=None, solver="auto", precision="mixed"):
        self._solver = PoseGraphSolver(dtype=dtype, solver=solver,
                                       precision=precision)

    def add_node(self, x, y, yaw, node_id):
        self._solver.add_node(x, y, yaw, node_id)

    def add_constraint(self, from_id, to_id, dx, dy, dyaw, info):
        self._solver.add_constraint(from_id, to_id, dx, dy, dyaw, info)

    def compute(self, niter=100, s_lambda=1.0e-4, use_csparse=True,
                init_tol=1.0e-9, max_cg_iters=50, verbose=False,
                conv_tol=1.0e-4):
        # use_csparse accepted for signature parity; the solver chooses
        # host vs dense vs matrix-free PCG by graph size (or the ctor
        # override).  conv_tol is the LM relative-cost-decrease stop;
        # init_tol only affects the CG residual on device paths.
        return self._solver.optimize(
            max_iters=niter, init_lambda=s_lambda, tol=init_tol,
            verbose=verbose, max_cg_iters=max_cg_iters, conv_tol=conv_tol,
        )

    @property
    def nodes(self):
        return [_NodeView(x, y, yaw) for x, y, yaw in self._solver.poses]

"""Free-space segmentation for map splicing.

The reference segments the free space of a saved map image with SLIC
superpixels (/root/reference/yag_slam/splicing.py:32-55, via skimage).
With a binary free-space mask and near-zero compactness, SLIC degenerates
to a spatial clustering of masked pixel coordinates — so we implement it
directly as masked Lloyd's k-means on (x, y), batched on device (distance
matrix + segment means are plain matmul/segment ops).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


# Full-f32 distance products: a reduced-precision matmul (TF32 on NVIDIA
# GPUs) would move k-means assignments near Voronoi boundaries.
_EXACT = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("n_iters",))
def _kmeans_iters(pts, valid, centers, *, n_iters: int):
    """pts (M, 2) float32, valid (M,), centers (K, 2) -> final centers and
    assignments."""

    def step(centers, _):
        d2 = (
            jnp.sum(pts**2, axis=1, keepdims=True)
            - 2.0 * jnp.dot(pts, centers.T, precision=_EXACT)
            + jnp.sum(centers**2, axis=1)[None, :]
        )  # (M, K)
        assign = jnp.argmin(d2, axis=1)
        w = valid.astype(pts.dtype)
        K = centers.shape[0]
        sums = jnp.zeros((K, 2), dtype=pts.dtype).at[assign].add(pts * w[:, None])
        cnts = jnp.zeros((K,), dtype=pts.dtype).at[assign].add(w)
        new_centers = jnp.where(
            cnts[:, None] > 0, sums / jnp.maximum(cnts, 1.0)[:, None], centers
        )
        return new_centers, None

    centers, _ = jax.lax.scan(step, centers, None, length=n_iters)
    d2 = (
        jnp.sum(pts**2, axis=1, keepdims=True)
        - 2.0 * jnp.dot(pts, centers.T, precision=_EXACT)
        + jnp.sum(centers**2, axis=1)[None, :]
    )
    return centers, jnp.argmin(d2, axis=1)


def spatial_segments(mask, n_segments, n_iters=12, seed=0):
    """Cluster the True pixels of `mask` (H, W) into `n_segments` spatially
    compact regions.  Returns an (H, W) int array: 0 = background, segment
    ids 1..K (the reference's SLIC label contract,
    /root/reference/yag_slam/splicing.py:49)."""
    mask = np.asarray(mask).astype(bool)
    ys, xs = np.nonzero(mask)
    m = len(xs)
    if m == 0 or n_segments < 1:
        return np.zeros(mask.shape, dtype=np.int32)
    n_segments = min(n_segments, m)

    rng = np.random.default_rng(seed)
    init_idx = rng.choice(m, size=n_segments, replace=False)
    pts = np.stack([xs, ys], axis=1).astype(np.float32)
    centers = pts[init_idx]

    _, assign = _kmeans_iters(
        jnp.asarray(pts), jnp.ones(m, bool), jnp.asarray(centers),
        n_iters=n_iters,
    )
    out = np.zeros(mask.shape, dtype=np.int32)
    out[ys, xs] = np.asarray(assign) + 1
    return out


def open_free_space(free_mask, size=11):
    """Morphological opening of the free-space mask.

    The reference dilates+erodes the *inverted* image (a closing of
    non-free space, /root/reference/yag_slam/splicing.py:38-44), which on
    the free mask is exactly an opening: thin free slivers and specks are
    removed before segmentation.
    """
    from scipy import ndimage

    st = np.ones((size, size), bool)
    return ndimage.binary_opening(np.asarray(free_mask).astype(bool),
                                  structure=st)

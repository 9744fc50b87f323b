"""Raytracing over a saved occupancy-grid *image* (lifelong-mapping path).

Behavioral spec: the reference's numba ray marcher
(/root/reference/yag_slam/raytracing.py:63-92) — 1-pixel steps along the
ray; a pixel value < 210 stops the ray *after* stepping once more; a
stopping value in (180, 210) is "unknown" and throws the endpoint 1000 px
further (range poisoning, so synthetic scans ignore unknown space); the ray
also stops when the next position leaves the 1-px interior border.

Device shape: instead of a sequential march per ray, all (ray, step)
sample positions are generated up front, the image is gathered once, and
the first stop event per ray is found with a masked argmax — one fused
program for a full 1439-ray sweep.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("max_steps",))
def _trace_rays_device(img, angles_rad, sx, sy, *, max_steps: int):
    h, w = img.shape
    c = jnp.cos(angles_rad)  # (A,)
    s = jnp.sin(angles_rad)
    k = jnp.arange(max_steps, dtype=img.dtype if img.dtype.kind == "f" else jnp.float32)

    px = sx + c[:, None] * k[None, :]  # (A, S) position at step k
    py = sy + s[:, None] * k[None, :]
    xi = jnp.round(px).astype(jnp.int32)
    yi = jnp.round(py).astype(jnp.int32)

    xi_c = jnp.clip(xi, 0, w - 1)
    yi_c = jnp.clip(yi, 0, h - 1)
    vals = img[yi_c, xi_c]  # (A, S)

    # stop events, reference ordering: value-stop is evaluated at position k
    # (ending at k+1); border-stop is evaluated at position k+1 (ending
    # there, value unread).
    val_stop = vals < 210
    out_border = (yi < 1) | (xi < 1) | (xi >= w - 1) | (yi >= h - 1)
    border_next = jnp.concatenate(
        [out_border[:, 1:], jnp.ones((out_border.shape[0], 1), bool)], axis=1
    )
    event = val_stop | border_next
    first = jnp.argmax(event, axis=1)  # first True (all-False can't happen:
    # the final padded border event is always True)

    val_at = jnp.take_along_axis(vals, first[:, None], axis=1)[:, 0]
    stopped_on_value = jnp.take_along_axis(val_stop, first[:, None], axis=1)[:, 0]
    poison = stopped_on_value & (val_at > 180) & (val_at < 210)

    # endpoint = position at step first+1 (the reference always steps once
    # past the stopping pixel), plus 1000 px when poisoned
    dist = (first + 1).astype(c.dtype) + jnp.where(poison, 1000.0, 0.0)
    ex = sx + c * dist
    ey = sy + s * dist
    length = jnp.sqrt((ex - sx) ** 2 + (ey - sy) ** 2)
    return ex, ey, length


def trace_rays(img, angles_deg, sx, sy):
    """Batched sweep; returns (end_x, end_y, length_px) numpy arrays."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    max_steps = int(np.ceil(np.hypot(h, w))) + 2
    ex, ey, ln = _trace_rays_device(
        jnp.asarray(img, jnp.float32),
        jnp.asarray(np.deg2rad(np.asarray(angles_deg, dtype=np.float64)),
                    jnp.float32),
        float(sx),
        float(sy),
        max_steps=max_steps,
    )
    return np.asarray(ex), np.asarray(ey), np.asarray(ln)


def run_raytracing_sweep(img, angles_deg, sx, sy):
    """Reference-shaped API (/root/reference/yag_slam/raytracing.py:90-92):
    returns a list of objects with .length (pixels) per angle."""

    class _Ray:
        __slots__ = ("end_x", "end_y", "length")

        def __init__(self, ex, ey, ln):
            self.end_x = ex
            self.end_y = ey
            self.length = ln

    ex, ey, ln = trace_rays(img, angles_deg, sx, sy)
    return [_Ray(float(a), float(b), float(c)) for a, b, c in zip(ex, ey, ln)]

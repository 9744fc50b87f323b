"""Device-mesh helpers.

The reference is strictly single-process (SURVEY §2.3: no distributed
backend of any kind); this build scales through `jax.sharding.Mesh` +
`shard_map`, with XLA's collectives between devices.  The natural
parallel axes of this workload:

- **dp** (candidate-parallel): loop-closure chains / offline scan batches
  are embarrassingly parallel match jobs;
- the global SPA solve reduces per-edge normal-equation contributions with
  a `psum` (see dist_spa).

Multi-host entry: call `jax.distributed.initialize()` before building the
mesh; everything below is process-count agnostic.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def default_mesh(n_devices=None, axis_name="dp"):
    """1-D data-parallel mesh over the first n (or all) devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def initialize_multihost(coordinator=None, num_processes=None, process_id=None):
    """Initialize jax.distributed for a multi-process run.  With one
    process this is a no-op."""
    if num_processes in (None, 1):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )

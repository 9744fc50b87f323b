"""Test configuration.

Tests run on the CPU backend (JAX_PLATFORMS=cpu) with 8 virtual devices,
so the multi-device sharding paths execute without accelerators, and with
float64 enabled (golden tests compare against a float64 numpy oracle).
The platform is also set through jax.config in case jax was imported
before this file ran; the XLA_FLAGS edit works because the backend has
not been initialized yet.  The persistent compilation cache that the
command-line entry points turn on stays off: tests compile fresh.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)

"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the CPU even where a GPU is present: JAX's CPU backend
is forced through jax.config before any backend is touched, with 8
virtual devices for the mesh tests.  The program itself runs on the
card through `python chip_smoke.py` (one process per card).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

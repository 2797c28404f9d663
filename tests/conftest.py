"""Test configuration: run everything on a virtual 8-device CPU mesh.

JAX_PLATFORMS picks the backend and defaults to the CPU; the tests marked
``gpu`` need ``JAX_PLATFORMS=cuda,cpu`` on a machine with the card.

Multi-device behavior (decomposition, halo exchange, collectives) is tested
by running the same code on N virtual devices, mirroring how the reference
tests CAF code by launching N images (SURVEY.md section 4).

The backend JAX_PLATFORMS names is set via config as well, in case
jax was imported before this file ran.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)

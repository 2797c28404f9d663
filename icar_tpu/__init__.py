"""icar_tpu — a JAX rebuild of the ICAR atmospheric downscaling model.

Brand-new JAX/XLA/Pallas implementation of the capabilities of NCAR/ICAR 2.x:
linear mountain-wave wind downscaling, finite-volume advection on a
terrain-following grid, column physics (microphysics / PBL / radiation /
LSM / convection), boundary forcing ingest and NetCDF output — designed
SPMD-first over a jax.sharding Mesh rather than translated from the
reference's Coarray Fortran.
"""

import os

__version__ = "0.1.0"

# the compile cache's home when JAX_COMPILATION_CACHE_DIR is not set: a
# fixed path inside the checkout (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compilation_cache_dir(environ, platforms: str):
    """The directory this package points JAX's persistent compile cache
    at, or None where it sets nothing: JAX reads JAX_COMPILATION_CACHE_DIR
    itself, and CPU-only sessions (``platforms`` as in JAX_PLATFORMS:
    tests, virtual-device runs) compile cheaply and skip the cache."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if platforms and set(platforms.split(",")) <= {"cpu"}:
        return None
    return DEFAULT_CACHE_DIR


def _setup_compilation_cache():
    """The full-physics interval step takes minutes to compile at
    500x500-class domains; the persistent cache compiles it once."""
    import jax
    path = compilation_cache_dir(
        os.environ,
        jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", ""))
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)


_setup_compilation_cache()

from . import constants

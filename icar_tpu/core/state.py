"""Model state: a flat dict pytree of jnp arrays.

Replaces the ~200-field domain_t object (/root/reference/src/objects/
domain_h.f90:18-363). Which fields exist is decided by the variable
registry's per-scheme requests (registry.collect_requests), mirroring
create_variables (domain_obj.f90:162-433). Static geometry (z, dz,
jacobians, terrain...) lives in grid.Geometry, not in the state.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List

import jax.numpy as jnp
import numpy as np

from ..config import Options
from ..registry import REGISTRY, collect_requests

# fields provided by the static Geometry object rather than the state
GEOMETRY_FIELDS = {
    "z", "z_interface", "dz", "dz_interface", "terrain", "latitude",
    "longitude",
}

State = Dict[str, jnp.ndarray]


def create_state(options: Options, dtype=jnp.float32) -> State:
    """Allocate all requested fields as zeros (create_variables,
    domain_obj.f90:162-433)."""
    req = collect_requests(options)
    d = options.domain
    state: State = {}
    for name in sorted(req.alloc):
        if name in GEOMETRY_FIELDS:
            continue
        spec = REGISTRY[name]
        shape = spec.shape(d.nz, d.ny, d.nx)
        fdtype = dtype
        state[name] = jnp.full(shape, spec.default, fdtype)
    return state


def advected_names(options: Options) -> List[str]:
    """Ordered list of advected species (vars_to_advect)."""
    return list(collect_requests(options).advect)


def restart_names(options: Options) -> List[str]:
    return sorted(collect_requests(options).restart)


def to_numpy(state: State) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in state.items()}


def _cpu_device():
    import jax
    try:
        devs = jax.local_devices(backend="cpu")
    except RuntimeError:
        return None
    return devs[0] if devs else None


@contextmanager
def host_setup():
    """Run model-setup math on the host CPU backend.

    Setup (create_state, initial diagnostics, the first wind solve) is a
    storm of ~90 small eager ops; on the accelerator each would compile
    and launch on its own. On the host CPU they run at numpy speed, and
    place_on_compute_device() ships the finished pytree to the
    accelerator in one transfer afterwards."""
    import jax
    dev = _cpu_device()
    if dev is None:
        yield None
        return
    with jax.default_device(dev):
        yield dev


def compute_device():
    """The device the model computes on: the one a ``jax.default_device``
    context names, else JAX's first device."""
    import jax
    d = jax.config.jax_default_device
    if d is None:
        return jax.devices()[0]
    return jax.devices(d)[0] if isinstance(d, str) else d


def place_on_compute_device(tree, device=None):
    """One bulk transfer of a pytree onto the compute device (the
    counterpart of host_setup). No-op when that device is the CPU."""
    import jax
    if device is None:
        device = compute_device()
    if device.platform == "cpu":
        return tree
    return jax.device_put(tree, device)

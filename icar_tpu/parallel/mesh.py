"""Device mesh construction and state sharding.

The replacement for the coarray image grid (grid_obj.f90
domain_decomposition + the exchangeable_t halo machinery, SURVEY.md
section 2.6): the (x, y) spatial decomposition becomes a
``jax.sharding.Mesh`` with axes ('y', 'x'); every (z, y, x) field is
sharded P(None, 'y', 'x') — z stays on-device whole because column physics
is z-local. Halo exchange is not written by hand: stencil slices on sharded
arrays compile to XLA collective-permutes between devices.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..grid import decompose_images


def padded_sizes(nx: int, ny: int, mesh: Mesh):
    """Uniform padded horizontal sizes divisible by the mesh.

    Top-level shardings in XLA require even divisibility, and a C-grid mixes
    nx and nx+1 arrays; we store every sharded field in one padded
    (NYP, NXP) frame (pad cells are edge-replicated, never read by the
    static-bounds ops) — the counterpart of the reference's
    nx_extra/ny_extra staggered bookkeeping (grid_obj.f90:160-193)."""
    mx = mesh.shape["x"]
    my = mesh.shape["y"]
    nxp = -(-(nx + 1) // mx) * mx
    nyp = -(-(ny + 1) // my) * my
    return nyp, nxp


def pad_field(arr, nyp: int, nxp: int):
    """Edge-replicate pad the trailing two dims to (nyp, nxp)."""
    a = np.asarray(arr)
    py = nyp - a.shape[-2]
    px = nxp - a.shape[-1]
    pad = [(0, 0)] * (a.ndim - 2) + [(0, py), (0, px)]
    return np.pad(a, pad, mode="edge")


def pad_state(state, nyp: int, nxp: int):
    return {k: pad_field(v, nyp, nxp) for k, v in state.items()}


def unpad_state(state_padded, natural_shapes):
    out = {}
    for k, v in state_padded.items():
        s = natural_shapes[k]
        out[k] = v[..., :s[-2], :s[-1]]
    return out


def make_mesh(nx: int, ny: int, devices=None) -> Mesh:
    """Factor the device count into a (yimages, ximages) grid matching the
    domain aspect ratio — the same factorization the reference uses for
    images (grid_obj.f90:39-103)."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    ximages, yimages = decompose_images(n, nx, ny)
    dev_grid = np.array(devices).reshape(yimages, ximages)
    return Mesh(dev_grid, ("y", "x"))


def spec_for(arr) -> P:
    """PartitionSpec for a model field: shard the two horizontal dims."""
    if arr.ndim == 3:
        return P(None, "y", "x")
    if arr.ndim == 2:
        return P("y", "x")
    return P()


def shard_state(state: Dict[str, jnp.ndarray], mesh: Mesh):
    """Place every field with its NamedSharding."""
    return {k: jax.device_put(v, NamedSharding(mesh, spec_for(v)))
            for k, v in state.items()}


def shard_geometry(geom, mesh: Mesh):
    """Return a copy of the Geometry with arrays device_put under the mesh
    sharding (so geometry constants do not get broadcast from host on every
    step)."""
    import dataclasses
    kw = {}
    for f in dataclasses.fields(geom):
        v = getattr(geom, f.name)
        if isinstance(v, np.ndarray) and v.ndim in (2, 3):
            kw[f.name] = jax.device_put(
                jnp.asarray(v), NamedSharding(mesh, spec_for(v)))
        else:
            kw[f.name] = v
    return dataclasses.replace(geom, **kw)

"""Per-column level selection without gathers.

For a SMALL leading axis (z levels, soil/snow layers) an unrolled
where-chain compiles to one fused elementwise pass instead of a
``take_along_axis`` gather per selection.
"""

from __future__ import annotations

import jax.numpy as jnp


def take_level(arr, idx):
    """``jnp.take_along_axis(arr, idx, axis=0)`` replacement for a small
    axis 0.

    ``arr`` is (n, *spatial); ``idx`` is either (*spatial) — one level
    per column, returning (*spatial) — or (m, *spatial), returning
    (m, *spatial). Exact (each output selects one element) and matches
    take_along_axis's clip semantics for out-of-range indices.
    """
    n = arr.shape[0]
    idx = jnp.clip(idx, 0, n - 1)
    out = jnp.broadcast_to(arr[0], jnp.broadcast_shapes(
        idx.shape, arr.shape[1:])).astype(arr.dtype)
    for lev in range(1, n):
        out = jnp.where(idx == lev, arr[lev], out)
    return out

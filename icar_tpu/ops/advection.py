"""Finite-volume advection on the terrain-following staggered grid.

JAX re-implementation of the first-order donor-cell (upwind) scheme
(/root/reference/src/physics/advect.f90). Fields are (z, y, x).

Design notes:
  * All advected species are stacked into one (nq, nz, ny, nx) array and
    advected in one batch-generic call so XLA fuses one pass over memory
    instead of one pass per species (the reference loops species serially,
    advect.f90:400-410).
  * Branchless flux form f = ((U+|U|) q_l + (U-|U|) q_r)/2 matches the
    reference's vectorization trick (advect.f90:147-157).
  * Only interior cells are updated; domain-boundary cells are held and
    relaxed toward the forcing by apply_forcing, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class CourantWinds(NamedTuple):
    """dt/dx-normalized metric-weighted winds (setup_module_winds,
    advect.f90:306-351)."""
    U_m: jnp.ndarray   # (nz, ny, nx-1)  internal x faces
    V_m: jnp.ndarray   # (nz, ny-1, nx)  internal y faces
    W_m: jnp.ndarray   # (nz, ny, nx)    top face of each layer


def setup_courant_winds(u, v, w, dt, dx, jaco_u, jaco_v, jaco_w, rho,
                        advect_density: bool = False) -> CourantWinds:
    """Pre-scale winds once per dt (advect.f90:306-351).

    U/V are divided by dx; W is NOT divided by dz because dz varies per
    cell (advect.f90:342-345). Density is averaged onto the faces."""
    if advect_density:
        rho_u = (rho[:, :, 1:] + rho[:, :, :-1]) * 0.5
        rho_v = (rho[:, 1:, :] + rho[:, :-1, :]) * 0.5
        rho_w = jnp.concatenate([(rho[1:] + rho[:-1]) * 0.5, rho[-1:]], axis=0)
        U_m = u[:, :, 1:-1] * (dt / dx) * jaco_u[:, :, 1:-1] * rho_u
        V_m = v[:, 1:-1, :] * (dt / dx) * jaco_v[:, 1:-1, :] * rho_v
        W_m = w * dt * jaco_w * rho_w
    else:
        U_m = u[:, :, 1:-1] * (dt / dx) * jaco_u[:, :, 1:-1]
        V_m = v[:, 1:-1, :] * (dt / dx) * jaco_v[:, 1:-1, :]
        W_m = w * dt * jaco_w
    return CourantWinds(U_m, V_m, W_m)


def _upwind_flux(ql, qr, U):
    return ((U + jnp.abs(U)) * ql + (U - jnp.abs(U)) * qr) * 0.5


def advect3d_upwind(q, winds: CourantWinds, rho, dz, jaco,
                    advect_density: bool = False):
    """Donor-cell update of one scalar field (advect3d, advect.f90:107-178).

    Returns the advected field; interior cells only (x,y in [1, n-2]).
    Batch-generic over leading dims: a stacked (nq, nz, ny, nx) species
    array advects in ONE call — no vmap, because vmapping the static
    `.at[].add` update lowers it to a scatter, while the direct
    broadcasted form stays a fused slice-update."""
    U_m, V_m, W_m = winds

    # x faces 1..nx-1 between cells (f-1, f); flux difference for cells 1..nx-2
    fx = _upwind_flux(q[..., :-1], q[..., 1:], U_m)            # (.., ny, nx-1)
    xdiv = fx[..., 1:-1, 1:] - fx[..., 1:-1, :-1]              # (.., ny-2, nx-2)

    fy = _upwind_flux(q[..., :-1, :], q[..., 1:, :], V_m)      # (.., ny-1, nx)
    ydiv = fy[..., 1:, 1:-1] - fy[..., :-1, 1:-1]              # (.., ny-2, nx-2)

    # vertical faces between layers k and k+1 (W_m[k] = flux at top of k);
    # winds index batch-generically too (MPDATA's corrective pass passes
    # per-species 4D pseudo-velocities)
    fz = _upwind_flux(q[..., :-1, :, :], q[..., 1:, :, :],
                      W_m[..., :-1, :, :])                     # (.., nz-1, ny, nx)

    qi = q[..., 1:-1, 1:-1]
    jacoi = jaco[:, 1:-1, 1:-1]
    if advect_density:
        jacoi = jacoi * rho[:, 1:-1, 1:-1]
    dzi = dz[:, 1:-1, 1:-1]
    fzi = fz[..., 1:-1, 1:-1]

    dq = (xdiv + ydiv) / jacoi
    # vertical: bottom layer loses only through its top face; top layer
    # flushes q*W out the model top (advect.f90:164-172)
    vert_in = jnp.concatenate([
        fzi[..., :1, :, :],
        fzi[..., 1:, :, :] - fzi[..., :-1, :, :],
        (qi[..., -1:, :, :] * W_m[..., -1:, 1:-1, 1:-1])
        - fzi[..., -1:, :, :]], axis=-3)
    dq = dq + vert_in / (dzi * jacoi)

    # concat form of q.at[..., 1:-1, 1:-1].add(-dq): bit-identical
    # (border cells subtract an exact zero)
    zy = jnp.zeros_like(dq[..., :1, :])
    dqy = jnp.concatenate([zy, dq, zy], axis=-2)
    zx = jnp.zeros_like(q[..., :1])
    dq_full = jnp.concatenate([zx, dqy, zx], axis=-1)
    return q - dq_full


def advect_upwind(stacked_q, u, v, w, dt, dx, jaco_u, jaco_v, jaco_w,
                  jaco, rho, dz, advect_density: bool = False,
                  floors=None, near_end=None):
    """Advect all species at once: ``stacked_q`` is (nq, nz, ny, nx)
    (upwind, advect.f90:380-418).

    ``floors``/``near_end``: optional per-species enforce_limits clamp,
    applied only when near_end > 0 (the interval loop's near-end negative
    clamp, time_step.f90:537-539)."""
    winds = setup_courant_winds(u, v, w, dt, dx, jaco_u, jaco_v, jaco_w,
                                rho, advect_density)
    out = advect3d_upwind(stacked_q, winds, rho, dz, jaco, advect_density)
    if floors is not None and near_end is not None:
        floor = jnp.where(near_end > 0,
                          jnp.asarray(floors, out.dtype), -jnp.inf)
        out = jnp.maximum(out, floor[:, None, None, None])
    return out


def divergence_check(winds: CourantWinds, dz):
    """Max |div| of the Courant winds; diagnostic mirror of test_divergence
    (advect.f90:273-304). Balanced winds should give ~0."""
    U_m, V_m, W_m = winds
    du = U_m[:, 1:-1, 1:] - U_m[:, 1:-1, :-1]
    dv = V_m[:, 1:, 1:-1] - V_m[:, :-1, 1:-1]
    dw = jnp.concatenate([W_m[:1], W_m[1:] - W_m[:-1]], axis=0) / dz
    div = du + dv + dw[:, 1:-1, 1:-1]
    return jnp.max(jnp.abs(div))

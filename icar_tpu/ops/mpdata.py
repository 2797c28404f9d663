"""MPDATA advection (Smolarkiewicz) with flux-corrected transport.

JAX re-implementation of /root/reference/src/physics/adv_mpdata.f90 and the
FCT core include (adv_mpdata_FCT_core.f90; Smolarkiewicz & Grabowski 1990).

The scheme: one upwind pass, then (order-1) corrective passes advecting with
antidiffusive pseudo-velocities computed from the upwind solution, each
optionally limited by 1D FCT along its axis. The reference's scalar loops
become whole-grid slice arithmetic; the sequential FCT min/max bookkeeping
becomes truncated-window rolling extrema.

Layout: (z, y, x); Courant winds as in ops.advection.CourantWinds
(U on internal x faces (nz,ny,nx-1), V on internal y faces (nz,ny-1,nx),
W at layer tops (nz,ny,nx), NOT normalized by dz).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .advection import CourantWinds, advect3d_upwind, setup_courant_winds

EPS_Q = 1e-10
EPS_F = 1e-15



def _add_interior(x, delta, axis):
    """x with ``delta`` added on the interior slices of ``axis`` (the
    concat form of x.at[..., 1:-1, ...].add(delta) — bit-identical)."""

    def sl(a, s):
        idx = [slice(None)] * a.ndim
        idx[axis] = s
        return a[tuple(idx)]
    return jnp.concatenate(
        [sl(x, slice(None, 1)),
         sl(x, slice(1, -1)) + delta,
         sl(x, slice(-1, None))], axis=axis)

def _pseudo_velocities(q, U, V, Wn, G):
    """Antidiffusive pseudo-velocities (mpdata_fluxes,
    adv_mpdata.f90:107-259). ``Wn`` is the dz-normalized vertical Courant
    wind; ``G`` = jacobian*rho (Smolarkiewicz & Margolin 1998 notation).
    Returns (u2, v2, w2) shaped like (U, V, W) broadcast against q's
    leading dims — batch-generic so a stacked species array processes in
    one pass (vmap would lower the .at[].add interior updates to
    scatters)."""
    # ---- U component: faces between x cells (c, c+1) ----
    ql, qr = q[..., :-1], q[..., 1:]
    Gx = G[:, :, :-1] + G[:, :, 1:]
    u2 = jnp.abs(U) * (1 - jnp.abs(U) / (0.5 * Gx)) * (qr - ql) / (qr + ql + EPS_Q)
    # UxV cross term (interior y rows only)
    qn, qs = q[..., 2:, :], q[..., :-2, :]       # q at y+1, y-1
    eq = ((qn[..., 1:] - qs[..., 1:] + qn[..., :-1] - qs[..., :-1])
          / (qn[..., 1:] + qs[..., 1:] + qn[..., :-1] + qs[..., :-1] + EPS_Q))
    ev = 0.25 * (V[:, :-1, :-1] + V[:, 1:, :-1] + V[:, :-1, 1:] + V[:, 1:, 1:])
    cross = 0.5 * U[:, 1:-1, :] * ev * eq / Gx[:, 1:-1, :]
    u2 = _add_interior(u2, -cross, axis=-2)
    # UxW cross term (interior z levels)
    qu, qd = q[..., 2:, :, :], q[..., :-2, :, :]
    eq = ((qu[..., 1:] - qd[..., 1:] + qu[..., :-1] - qd[..., :-1])
          / (qu[..., 1:] + qd[..., 1:] + qu[..., :-1] + qd[..., :-1] + EPS_Q))
    ev = 0.25 * (Wn[1:-1, :, :-1] + Wn[:-2, :, :-1]
                 + Wn[1:-1, :, 1:] + Wn[:-2, :, 1:])
    cross = 0.5 * U[1:-1] * ev * eq / Gx[1:-1]
    u2 = _add_interior(u2, -cross, axis=-3)

    # ---- V component: faces between y rows (g, g+1) ----
    ql, qr = q[..., :-1, :], q[..., 1:, :]
    Gy = G[:, :-1, :] + G[:, 1:, :]
    v2 = jnp.abs(V) * (1 - jnp.abs(V) / (0.5 * Gy)) * (qr - ql) / (qr + ql + EPS_Q)
    # VxU cross (interior x cells)
    qe = q[..., 2:]                              # x+1
    qw = q[..., :-2]                             # x-1
    eq = ((qe[..., :-1, :] - qw[..., 1:, :] + qe[..., 1:, :] - qw[..., :-1, :])
          / (qe[..., 1:, :] + qe[..., :-1, :] + qw[..., 1:, :]
             + qw[..., :-1, :] + EPS_Q))
    ev = 0.25 * (U[:, :-1, :-1] + U[:, 1:, :-1] + U[:, :-1, 1:] + U[:, 1:, 1:])
    cross = 0.5 * V[:, :, 1:-1] * ev * eq / Gy[:, :, 1:-1]
    v2 = _add_interior(v2, -cross, axis=-1)
    # VxW cross (interior z)
    qu, qd = q[..., 2:, :, :], q[..., :-2, :, :]
    eq = ((qu[..., :-1, :] - qd[..., 1:, :] + qu[..., 1:, :] - qd[..., :-1, :])
          / (qu[..., :-1, :] + qd[..., 1:, :] + qu[..., 1:, :]
             + qd[..., :-1, :] + EPS_Q))
    ev = 0.25 * (Wn[1:-1, :-1, :] + Wn[:-2, :-1, :]
                 + Wn[1:-1, 1:, :] + Wn[:-2, 1:, :])
    cross = 0.5 * V[1:-1] * ev * eq / Gy[1:-1]
    v2 = _add_interior(v2, -cross, axis=-3)

    # ---- W component: faces between levels (k, k+1), top = 0 ----
    ql, qr = q[..., :-1, :, :], q[..., 1:, :, :]
    Gz = G[:-1] + G[1:]
    Wf = Wn[:-1]
    w2f = jnp.abs(Wf) * (1 - jnp.abs(Wf) / (0.5 * Gz)) * (qr - ql) / (qr + ql + EPS_Q)
    # WxU cross (interior x)
    qe, qw = q[..., 2:], q[..., :-2]
    eq = ((qe[..., 1:, :, :] - qw[..., :-1, :, :] + qe[..., :-1, :, :]
           - qw[..., 1:, :, :])
          / (qe[..., :-1, :, :] + qe[..., 1:, :, :] + qw[..., :-1, :, :]
             + qw[..., 1:, :, :] + EPS_Q))
    ev = 0.25 * (U[:-1, :, :-1] + U[1:, :, :-1] + U[:-1, :, 1:] + U[1:, :, 1:])
    cross = 0.5 * Wf[:, :, 1:-1] * ev * eq / Gz[:, :, 1:-1]
    w2f = _add_interior(w2f, -cross, axis=-1)
    # WxV cross (interior y)
    qn, qs = q[..., 2:, :], q[..., :-2, :]
    eq = ((qn[..., 1:, :, :] - qs[..., :-1, :, :] + qn[..., :-1, :, :]
           - qs[..., 1:, :, :])
          / (qn[..., :-1, :, :] + qs[..., 1:, :, :] + qn[..., 1:, :, :]
             + qs[..., :-1, :, :] + EPS_Q))
    ev = 0.25 * (V[:-1, :-1, :] + V[1:, :-1, :] + V[:-1, 1:, :] + V[1:, 1:, :])
    cross = 0.5 * Wf[:, 1:-1, :] * ev * eq / Gz[:, 1:-1, :]
    w2f = _add_interior(w2f, -cross, axis=-2)

    w2 = jnp.concatenate([w2f, jnp.zeros_like(w2f[..., :1, :, :])],
                         axis=-3)
    return u2, v2, w2


def _upwind_flux(ql, qr, U):
    return ((U + jnp.abs(U)) * ql + (U - jnp.abs(U)) * qr) * 0.5


def _fct_limit_axis(q0, q1, U2, axis: int, is_w: bool):
    """1D flux-corrected transport limiter along ``axis``
    (adv_mpdata_FCT_core.f90; Smolarkiewicz & Grabowski 1990).

    q0: pre-iteration field; q1: post-upwind field; U2: pseudo-velocity on
    the internal faces of ``axis`` (size n-1 there). Returns limited U2.
    ``axis`` counts from the end (x=-1, y=-2, z=-3) so stacked species
    arrays limit in one pass. Axis-generic SLICING (no moveaxis): the
    transposes a moved-axis formulation pays break XLA fusion and
    materialize full-stack copies."""
    def sl(a, s):
        idx = [slice(None)] * a.ndim
        idx[axis] = s
        return a[tuple(idx)]

    def cat(parts):
        return jnp.concatenate(parts, axis=axis)

    f = _upwind_flux(sl(q1, slice(None, -1)), sl(q1, slice(1, None)), U2)

    # per-cell allowable bounds from the 3-cell window (truncated at edges)
    # of both the original and upwind fields
    hi = jnp.maximum(q0, q1)
    lo = jnp.minimum(q0, q1)
    edge1 = slice(None, 1)
    neg_inf = jnp.full_like(sl(hi, edge1), -jnp.inf)
    pos_inf = jnp.full_like(sl(hi, edge1), jnp.inf)
    qmax = jnp.maximum(hi, jnp.maximum(
        cat([neg_inf, sl(hi, slice(None, -1))]),
        cat([sl(hi, slice(1, None)), neg_inf])))
    qmin = jnp.minimum(lo, jnp.minimum(
        cat([pos_inf, sl(lo, slice(None, -1))]),
        cat([sl(lo, slice(1, None)), pos_inf])))

    # total antidiffusive flux into / out of each cell
    zero = jnp.zeros_like(sl(f, edge1))
    f_left = cat([zero, f])                        # face below/left of cell
    f_right = cat([f, zero])                       # face above/right of cell
    fin = jnp.maximum(0.0, f_left) - jnp.minimum(0.0, f_right)
    fout = jnp.maximum(0.0, f_right) - jnp.minimum(0.0, f_left)
    if not is_w:
        # no flux limiting at the lateral boundary cells
        # (adv_mpdata_FCT_core.f90 'No flux limitations to the boundary
        # cell'): zero the edge slices via masked concat (a static-index
        # .at[].set is fine unvmapped, but the concat fuses better)
        n = fin.shape[axis]
        inner = slice(1, n - 1)
        fin = cat([zero, sl(fin, inner), zero])
        fout = cat([zero, sl(fout, inner), zero])

    beta_in = (qmax - q1) / (fin + EPS_F)
    beta_out = (q1 - qmin) / (fout + EPS_F)

    pos_fac = jnp.minimum(1.0, jnp.minimum(sl(beta_in, slice(1, None)),
                                           sl(beta_out, slice(None, -1))))
    neg_fac = jnp.minimum(1.0, jnp.minimum(sl(beta_in, slice(None, -1)),
                                           sl(beta_out, slice(1, None))))
    return jnp.where(U2 > 0, U2 * pos_fac,
                     jnp.where(U2 < 0, U2 * neg_fac, U2))


def advect3d_mpdata(q, winds: CourantWinds, rho, dz, jaco, order: int,
                    use_fct: bool, advect_density: bool = False):
    """Full MPDATA update of one scalar (advect3d, adv_mpdata.f90:356-419)."""
    G = jaco * rho if advect_density else jaco
    q_prev = q
    for iord in range(order):
        if iord == 0:
            q_new = advect3d_upwind(q_prev, winds, rho, dz, jaco, advect_density)
        else:
            Wn = winds.W_m / dz
            u2, v2, w2 = _pseudo_velocities(q_new, winds.U_m, winds.V_m, Wn, G)
            # worst-case stability factor (Smolarkiewicz 1984 after eq. 24)
            u2 = u2 * 0.5
            v2 = v2 * 0.5
            w2 = w2 * 0.5 * dz
            if use_fct:
                u2 = _fct_limit_axis(q_prev, q_new, u2, axis=-1, is_w=False)
                v2 = _fct_limit_axis(q_prev, q_new, v2, axis=-2, is_w=False)
                wf = _fct_limit_axis(q_prev, q_new,
                                     w2[..., :-1, :, :] / dz[:-1],
                                     axis=-3, is_w=True)
                w2 = jnp.concatenate([wf * dz[:-1],
                                      jnp.zeros_like(w2[..., :1, :, :])],
                                     axis=-3)
            corrective = CourantWinds(u2, v2, w2)
            q_prev = q_new
            q_new = advect3d_upwind(q_new, corrective, rho, dz, jaco,
                                    advect_density)
    return q_new


def advect_mpdata(stacked_q, u, v, w, dt, dx, jaco_u, jaco_v, jaco_w, jaco,
                  rho, dz, order: int = 2, use_fct: bool = True,
                  advect_density: bool = False, floors=None, near_end=None):
    """Advect all species with MPDATA in one stacked pass (mpdata,
    adv_mpdata.f90:463-524).

    ``floors``/``near_end``: optional fused enforce_limits epilogue —
    when near_end > 0, clamp species s to >= floors[s] (the interval
    loop's near-end negative clamp, time_step.f90:537-539), saving a
    whole-stack masked rewrite per substep."""
    winds = setup_courant_winds(u, v, w, dt, dx, jaco_u, jaco_v, jaco_w,
                                rho, advect_density)
    if not advect_density:
        rho_eff = jnp.ones_like(jaco)
    else:
        rho_eff = rho
    # batch-generic over the species dim (see _pseudo_velocities: vmap
    # would turn every interior .at[].add into a scatter)
    out = advect3d_mpdata(stacked_q, winds, rho_eff, dz, jaco, order,
                          use_fct, advect_density)
    if floors is not None and near_end is not None:
        fl = jnp.where(jnp.asarray(near_end) > 0,
                       jnp.asarray(floors)[:, None, None, None],
                       -jnp.inf)
        out = jnp.maximum(out, fl)
    return out

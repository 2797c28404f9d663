"""Froude-number flow-blocking parameterization (mod_blocking).

Re-implementation of /root/reference/src/physics/winds_blocking.f90.  In
the reference this module is written against the ICAR 1.x legacy API and
its driver call is commented out (wind.f90:303-306); here it is wired into
the wind update behind the ``block_flow`` namelist switch (block_parameters,
options_obj.f90:1361-1366) so the capability is actually usable.

The scheme: a (direction x speed) lookup table of "blocked flow"
perturbations is built from linear mountain-wave theory, where each
column's divergence-implied vertical motion is integrated upward and the
perturbation above the level of maximum downward motion is replaced by a
small continued-divergence fraction (compute_blocked_flow_for_wind,
winds_blocking.f90:498-557) — i.e. the flow below the blocking level goes
*around* the terrain rather than over it.  At run time a smoothed bulk
Froude number selects how much of that blocked perturbation applies
(blocking_fraction, atm_utilities.f90:497-505).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .linear_winds import (fourier_terrain, wavenumber_grids,
                           perturbation_layer, calc_direction, _position,
                           _weight)

FRACTION_CONTINUED_DIVERGENCE = 0.05   # winds_blocking.f90:44
NSQ_BLOCKING = 1e-4                    # :46 (fixed background N^2)


class BlockingData(NamedTuple):
    lut_u: jnp.ndarray        # (ndir, nspd, nz, ny, nx+1)
    lut_v: jnp.ndarray        # (ndir, nspd, nz, ny+1, nx)
    dir_values: jnp.ndarray   # (ndir,)
    spd_values: jnp.ndarray   # (nspd,)
    terrain_blocking: jnp.ndarray   # (ny, nx) blocking height [m]


def terrain_blocking_heights(terrain: np.ndarray,
                             n_smoothing_passes: int = 3) -> np.ndarray:
    """Height scale of terrain obstacles: smoothed local relief
    (compute_terrain_blocking_heights, winds_blocking.f90:339-401)."""
    window_size, smooth_window = 5, 2
    ny, nx = terrain.shape

    def box_mean(a, w):
        out = np.empty_like(a)
        for j in range(ny):
            ys, ye = max(j - w, 0), min(j + w, ny - 1)
            for i in range(nx):
                xs, xe = max(i - w, 0), min(i + w, nx - 1)
                out[j, i] = a[ys:ye + 1, xs:xe + 1].mean()
        return out

    tb = box_mean(np.asarray(terrain, np.float64), smooth_window)
    relief = np.empty_like(tb)
    for j in range(ny):
        ys, ye = max(j - window_size, 0), min(j + window_size, ny - 1)
        for i in range(nx):
            xs, xe = max(i - window_size, 0), min(i + window_size, nx - 1)
            w = tb[ys:ye + 1, xs:xe + 1]
            relief[j, i] = w.max() - w.min()
    tb = relief
    for p in range(n_smoothing_passes):
        tb = box_mean(tb, smooth_window)
    return tb.astype(np.float32)


def _find_max_downward_level(wcol_sums: np.ndarray) -> int:
    """Level of maximum domain-total downward motion with the reference's
    early-return-on-descent quirk (find_maximum_downward_motion,
    winds_blocking.f90:559-583)."""
    minw = 999999.0
    max_level = 0
    for i, w in enumerate(wcol_sums):
        if w < minw:
            max_level = i
            minw = w
        elif max_level != 0:
            break
    return max_level


def build_blocking_lut(terrain: np.ndarray, dx: float,
                       dz_levels: np.ndarray, lt,
                       minimum_step: float = 100.0):
    """(dir, speed) table of blocked-flow u/v perturbations
    (generate_blocked_flow_lut + compute_blocked_flow_for_wind,
    winds_blocking.f90:403-557). Runs at init on the host."""
    ny, nx = terrain.shape
    nz = len(dz_levels)
    fzs, buffer = fourier_terrain(np.asarray(terrain), lt.buffer)
    NY, NX = fzs.shape
    k, l, kl = wavenumber_grids(NY, NX, dx)

    ndir, nspd = lt.n_dir_values, lt.n_spd_values
    dir_values = np.linspace(lt.dirmin, lt.dirmax, ndir).astype(np.float32)
    spd_values = np.linspace(lt.spdmin, lt.spdmax, nspd).astype(np.float32)

    z_bot = np.concatenate([[0.0], np.cumsum(dz_levels[:-1])]).astype(
        np.float32)
    z_top = np.cumsum(dz_levels).astype(np.float32)
    n_steps = [max(1, int(np.ceil(dz / minimum_step))) for dz in dz_levels]

    from .linear_winds import perturbation_layer_np
    fzs_np = np.asarray(fzs, np.complex64)
    k_np, l_np, kl_np = (np.asarray(a, np.float32) for a in (k, l, kl))

    def one_entry(u, v):
        # host pocketfft build, like the spatial LUT (see
        # linear_winds.build_lut_chunks)
        ups, vps = [], []
        for z in range(nz):
            up, vp = perturbation_layer_np(
                np.float32(u), np.float32(v), np.float32(NSQ_BLOCKING),
                z_bot[z], z_top[z], n_steps[z], fzs_np, k_np, l_np, kl_np)
            ups.append(up)
            vps.append(vp)
        return np.stack(ups), np.stack(vps)

    lut_u = np.zeros((ndir, nspd, nz, ny, nx + 1), np.float32)
    lut_v = np.zeros((ndir, nspd, nz, ny + 1, nx), np.float32)
    for d in range(ndir):
        for s in range(nspd):
            u = float(np.sin(dir_values[d]) * spd_values[s])
            v = float(np.cos(dir_values[d]) * spd_values[s])
            uf, vf = (np.array(a) for a in one_entry(u, v))
            # column-integrated divergence -> w; negative part only
            w = np.zeros((nz, NY, NX), np.float64)
            w[:, 1:-1, 1:-1] = (uf[:, 1:-1, :-2] - uf[:, 1:-1, 2:]
                                + vf[:, :-2, 1:-1] - vf[:, 2:, 1:-1])
            w = np.cumsum(w, axis=0)
            w = np.minimum(w, 0.0)
            key_level = _find_max_downward_level(w.sum(axis=(1, 2)))
            if key_level < nz - 1:
                uf[key_level + 1:] = (uf[key_level]
                                      * FRACTION_CONTINUED_DIVERGENCE)
                vf[key_level + 1:] = (vf[key_level]
                                      * FRACTION_CONTINUED_DIVERGENCE)
            # crop buffer + stagger to u/v grids (:445-455)
            uc = (uf[:, buffer:NY - buffer, buffer - 1:NX - buffer]
                  + uf[:, buffer:NY - buffer, buffer:NX - buffer + 1]) * 0.5
            vc = (vf[:, buffer - 1:NY - buffer, buffer:NX - buffer]
                  + vf[:, buffer:NY - buffer + 1, buffer:NX - buffer]) * 0.5
            lut_u[d, s] = uc
            lut_v[d, s] = vc
    return lut_u, lut_v, dir_values, spd_values


def init_blocking(terrain: np.ndarray, dx: float, dz_levels: np.ndarray,
                  lt, block) -> BlockingData:
    """Host-side initialization (initialize_blocking,
    winds_blocking.f90:260-333)."""
    tb = terrain_blocking_heights(terrain, block.n_smoothing_passes)
    lut_u, lut_v, dirv, spdv = build_blocking_lut(
        terrain, dx, dz_levels, lt)
    return BlockingData(jnp.asarray(lut_u), jnp.asarray(lut_v),
                        jnp.asarray(dirv), jnp.asarray(spdv),
                        jnp.asarray(tb))


def _box_mean_2d(a, w: int):
    """Edge-clipped box mean (mirrors the reference's windowed sums)."""
    ny, nx = a.shape
    ones = jnp.ones_like(a)
    pad = [(w, w), (w, w)]
    csum = jnp.pad(a, pad)
    cnt = jnp.pad(ones, pad)
    ker = jnp.ones((2 * w + 1, 2 * w + 1), a.dtype)
    num = jax.scipy.signal.convolve2d(csum, ker, mode="valid")
    den = jax.scipy.signal.convolve2d(cnt, ker, mode="valid")
    return num / den


def update_froude(th, u, v, z, terrain_blocking, nsmooth_gridcells: int,
                  n_smoothing_passes: int, fr_max: float):
    """Smoothed bulk Froude number (update_froude_number,
    winds_blocking.f90:67-133): a single boundary-mean wind and
    dry-stability value applied against the local blocking height."""
    nz, ny, nx = th.shape
    th_bot = 0.5 * (jnp.mean(th[0, 0, :]) + jnp.mean(th[0, -1, :]))
    th_top = 0.5 * (jnp.mean(th[-1, 0, :]) + jnp.mean(th[-1, -1, :]))
    um = 0.5 * (jnp.mean(u[:, 0, :]) + jnp.mean(u[:, -1, :]))
    vm = 0.5 * (jnp.mean(v[:, 0, :]) + jnp.mean(v[:, -1, :]))
    wind_speed = jnp.sqrt(um ** 2 + vm ** 2)
    z_bot = z[0, 0, 0]
    z_top = z[-1, 0, 0]
    bv = C.GRAVITY * (jnp.log(th_top) - jnp.log(th_bot)) / (z_top - z_bot)
    stability = jnp.sqrt(jnp.maximum(bv, 0.0))
    denom = terrain_blocking * stability
    froude = jnp.where(denom == 0.0, 100.0, wind_speed / jnp.maximum(
        denom, 1e-12))
    for _ in range(n_smoothing_passes):
        froude = _box_mean_2d(froude, nsmooth_gridcells)
    return froude


def apply_blocking(u, v, froude, bd: BlockingData, winsz: int,
                   blocking_contribution: float, fr_max: float,
                   fr_min: float):
    """Add the Froude-weighted blocked-flow perturbation to the staggered
    winds (spatial_blocking, winds_blocking.f90:142-251)."""
    nz = u.shape[0]
    froude_gain = 1.0 / max(fr_max - fr_min, 1e-3)

    def vert_window_mean(a):
        # moving mean over z with half-window winsz, edge-clipped
        cs = jnp.cumsum(jnp.concatenate([jnp.zeros_like(a[:1]), a],
                                        axis=0), axis=0)
        iz = jnp.arange(nz)
        lo = jnp.maximum(iz - winsz, 0)
        hi = jnp.minimum(iz + winsz, nz - 1)
        return (cs[hi + 1] - cs[lo]) / (hi - lo + 1)[:, None, None]

    u_mean = vert_window_mean(u)          # (nz, ny, nx+1)
    v_mean = vert_window_mean(v)          # (nz, ny+1, nx)
    # wind components co-located per staggered grid (reference indexes
    # u(i,:,uk) and v(vi,:,k) with clipped cross indices)
    v_on_u = jnp.pad(0.5 * (v_mean[:, :-1, :] + v_mean[:, 1:, :]),
                     ((0, 0), (0, 0), (0, 1)), mode="edge")
    u_on_v = jnp.pad(0.5 * (u_mean[:, :, :-1] + u_mean[:, :, 1:]),
                     ((0, 0), (0, 1), (0, 0)), mode="edge")

    def interp(lut, uu, vv):
        """Bilinear (dir, speed) interpolation of the LUT at each point's
        local windowed wind (winds_blocking.f90:180-230)."""
        nspd = lut.shape[1]
        flat = lut.reshape((-1,) + lut.shape[2:])
        curdir = calc_direction(uu, vv)
        curspd = jnp.sqrt(uu ** 2 + vv ** 2)
        dpos = _position(bd.dir_values, curdir)
        spos = _position(bd.spd_values, curspd)
        dw, dnext = _weight(bd.dir_values, dpos, curdir)
        sw, snext = _weight(bd.spd_values, spos, curspd)

        def take(d, s):
            i = (d * nspd + s).astype(jnp.int32)
            return jnp.take_along_axis(flat, i[None], axis=0)[0]

        return (sw * (dw * take(dpos, spos) + (1 - dw) * take(dnext, spos))
                + (1 - sw) * (dw * take(dpos, snext)
                              + (1 - dw) * take(dnext, snext)))

    pert_u = interp(bd.lut_u, u_mean, v_on_u)
    pert_v = interp(bd.lut_v, u_on_v, v_mean)

    fr_u = jnp.pad(froude, ((0, 0), (0, 1)), mode="edge")
    fr_v = jnp.pad(froude, ((0, 1), (0, 0)), mode="edge")
    frac_u = jnp.clip((fr_max - fr_u) * froude_gain, 0.0, 1.0)
    frac_v = jnp.clip((fr_max - fr_v) * froude_gain, 0.0, 1.0)
    blocked_u = (fr_u < fr_max)
    blocked_v = (fr_v < fr_max)
    u = u + jnp.where(blocked_u[None],
                      pert_u * frac_u[None] * blocking_contribution, 0.0)
    v = v + jnp.where(blocked_v[None],
                      pert_v * frac_v[None] * blocking_contribution, 0.0)
    return u, v

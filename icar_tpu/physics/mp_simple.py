"""SB04 "simple" microphysics, vectorized over the grid.

JAX re-implementation of /root/reference/src/physics/mp_simple.f90 (the
microphysics of Smith & Barstad 2004): instant saturation adjustment with
latent-heat feedback, time-constant conversion of cloud to rain/snow,
explicit sedimentation at fixed fall speeds with CFL substepping, and
evaporation/sublimation of falling precipitation.

The reference is branch-dense scalar column code under an OpenMP loop; here
every branch becomes a masked `jnp.where` over the whole (z, y, x) grid so
all columns are processed at once. The saturation-adjustment iteration
(up to 15 Newton-like halving steps, mp_simple.f90:217-246) runs as a
`while_loop` with a per-cell convergence mask. On the GPU the whole scheme
runs as one column-local kernel instead (ops/sb04_kernel.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import constants as C

# module parameters (mp_simple.f90:63-96)
LH_VAPOR = 2.26e6
DLHVDT = 2400.0
LH_LIQUID = 3.34e5
HEAT_CAPACITY = 1006.0
SMALL = 1e-30
SNOW_EVAP_TC = 1 / 2000.0
RAIN_EVAP_TC = 1 / 500.0
SNOW_FORMATION_TC = 1 / 2000.0
RAIN_FORMATION_TC = 1 / 500.0
FREEZING = 273.15
SNOW_FALL_RATE = 1.5     # m/s
RAIN_FALL_RATE = 10.0    # m/s
SNOW_CLOUD_INIT = 1e-4   # kg/kg
RAIN_CLOUD_INIT = 1e-4   # kg/kg
MAXERR = 1e-4
N_SAT_ITERS = 15


def sat_mr(temperature, pressure):
    """Saturated mixing ratio [kg/kg] wrt liquid above 0C / ice below
    (sat_mr, mp_simple.f90:146-182; Lowe & Ficke 1974)."""
    a = jnp.where(temperature < FREEZING, 21.8745584, 17.2693882)
    b = jnp.where(temperature < FREEZING, 7.66, 35.86)
    e_s = 610.78 * jnp.exp(a * (temperature - 273.16) / (temperature - b))
    e_s = jnp.where(pressure - e_s <= 0, pressure * 0.99999, e_s)
    return 0.6219907 * e_s / (pressure - e_s)


def cloud_conversion(pressure, temperature, qv, qc, dt):
    """Saturation adjustment with latent heating (cloud_conversion,
    mp_simple.f90:198-280). Returns (temperature, qv, qc, qvsat)."""
    pre_t, pre_qv, pre_qc = temperature, qv, qc
    vapor2temp = (LH_VAPOR + (373.15 - temperature) * DLHVDT) / HEAT_CAPACITY

    def cond(carry):
        t, qv, qc, qvsat, lastqv, niter, it = carry
        # early exit once every cell converged: after the first substep most
        # of the grid is already at equilibrium, cutting the reference's
        # fixed 15 sweeps to ~1-3 (same numerics — inactive cells are
        # masked out either way)
        return (it < N_SAT_ITERS) & jnp.any(jnp.abs(lastqv - qv) > MAXERR)

    def body(carry):
        t, qv, qc, qvsat, lastqv, niter, it = carry
        active = jnp.abs(lastqv - qv) > MAXERR
        lastqv = jnp.where(active, qv, lastqv)
        qvs = sat_mr(t, pressure)
        qvsat = jnp.where(active, qvs, qvsat)

        supersat = qv > qvs
        exc_sup = (qv - qvs) * 0.5
        t_sup = t + exc_sup * vapor2temp
        qv_sup = qv - exc_sup
        qc_sup = qc + exc_sup

        # unsaturated with cloud present: evaporate up to all of qc
        exc_un = (qvs - qv) * 0.5
        full_evap = exc_un >= qc
        evap = jnp.where(full_evap, qc, exc_un)
        t_un = t - evap * vapor2temp
        qv_un = qv + evap
        qc_un = qc - evap

        has_cloud = qc > 0
        t_new = jnp.where(supersat, t_sup, jnp.where(has_cloud, t_un, t))
        qv_new = jnp.where(supersat, qv_sup, jnp.where(has_cloud, qv_un, qv))
        qc_new = jnp.where(supersat, qc_sup, jnp.where(has_cloud, qc_un, qc))

        t = jnp.where(active, t_new, t)
        qv = jnp.where(active, qv_new, qv)
        qc = jnp.where(active, qc_new, qc)
        niter = niter + active.astype(jnp.int32)
        return t, qv, qc, qvsat, lastqv, niter, it + 1

    init = (temperature, qv, qc, jnp.zeros_like(qv),
            qv + 2 * MAXERR, jnp.zeros(qv.shape, jnp.int32), jnp.int32(0))
    t, qv, qc, qvsat, lastqv, niter, _ = jax.lax.while_loop(cond, body, init)

    # non-converged cells revert to the entry state (mp_simple.f90:248-255)
    failed = niter >= N_SAT_ITERS
    t = jnp.where(failed, pre_t, t)
    qv = jnp.where(failed, sat_mr(pre_t, pressure), qv)
    qc = jnp.where(failed, pre_qc, qc)
    qc = jnp.maximum(qc, 0.0)
    return t, qv, qc, qvsat


def cloud2hydrometeor(qc, q, conversion, qcmin):
    """Convert cloud to rain/snow with a time constant (cloud2hydrometeor,
    mp_simple.f90:295-315)."""
    delta = jnp.where(qc > qcmin, qc - qc * conversion, 0.0)
    transfer = jnp.minimum(delta, qc)
    return jnp.maximum(qc - transfer, 0.0), q + transfer


def phase_change(temperature, q1, qmax, q2, lheat, change_rate):
    """Generic phase change q1 -> q2 with latent heating (phase_change,
    mp_simple.f90:333-362)."""
    delta = (qmax - q2) * change_rate
    delta = jnp.minimum(delta, q1)
    delta = jnp.minimum(delta, (qmax - q2) * 0.99)
    delta = jnp.maximum(delta, 0.0)
    q1n = jnp.maximum(q1 - delta, 0.0)
    q2n = q2 + delta
    tn = temperature + delta * (lheat / HEAT_CAPACITY)
    return tn, q1n, q2n


def mp_conversions(pressure, temperature, qv, qc, qr, qs, dt,
                   cloud2rain, cloud2snow):
    """All per-cell conversions (mp_conversions, mp_simple.f90:381-420)."""
    l_melt = -LH_LIQUID
    l_evap = -(LH_VAPOR + (373.15 - temperature) * DLHVDT)
    l_subl = l_melt + l_evap

    temperature, qv, qc, qvsat = cloud_conversion(pressure, temperature, qv,
                                                  qc, dt)

    any_species = (qc + qr + qs) > SMALL
    qc_big = qc > SMALL
    warm = temperature > FREEZING

    # warm cloud -> rain
    m = any_species & qc_big & warm
    qc_r, qr_r = cloud2hydrometeor(qc, qr, cloud2rain, RAIN_CLOUD_INIT)
    qc = jnp.where(m, qc_r, qc)
    qr = jnp.where(m, qr_r, qr)
    # above freezing, melt snow into rain
    mm = m & (qs > SMALL)
    t_m, qs_m, qr_m = phase_change(temperature, qs, 100.0, qr, l_melt, cloud2rain)
    temperature = jnp.where(mm, t_m, temperature)
    qs = jnp.where(mm, qs_m, qs)
    qr = jnp.where(mm, qr_m, qr)

    # cold cloud -> snow
    mc = any_species & qc_big & ~warm
    qc_s, qs_s = cloud2hydrometeor(qc, qs, cloud2snow, SNOW_CLOUD_INIT)
    qc = jnp.where(mc, qc_s, qc)
    qs = jnp.where(mc, qs_s, qs)

    # subsaturated: evaporate rain, then sublimate snow
    unsat = any_species & (qv < qvsat)
    mr = unsat & (qr > SMALL)
    t_e, qr_e, qv_e = phase_change(temperature, qr, qvsat, qv, l_evap, cloud2rain / 2)
    temperature = jnp.where(mr, t_e, temperature)
    qr = jnp.where(mr, qr_e, qr)
    qv = jnp.where(mr, qv_e, qv)
    ms = unsat & (qs > SMALL)
    t_s, qs_e, qv_s = phase_change(temperature, qs, qvsat, qv, l_subl, cloud2snow / 2)
    temperature = jnp.where(ms, t_s, temperature)
    qs = jnp.where(ms, qs_e, qs)
    qv = jnp.where(ms, qv_s, qv)

    return temperature, qv, qc, qr, qs


def _sediment_substep(q, fall_dist, rho, dz):
    """One explicit upstream fall step (sediment, mp_simple.f90:437-459).

    ``fall_dist`` is the per-substep, per-column fall distance [m] (already
    dt/cfl scaled), shape (ny, nx). Returns (q_new, surface_flux[kg/m^2])."""
    sed = fall_dist * q[0] * rho[0]
    flux = fall_dist[None] * q[1:] * rho[1:]        # into layer k from k+1
    zeros = jnp.zeros_like(q[:1])
    gain = jnp.concatenate([flux, zeros], axis=0)
    loss = jnp.concatenate([zeros, flux], axis=0)
    q_new = q + (gain - loss) / (rho * dz)
    q_new = q_new.at[0].add(-sed / (dz[0] * rho[0]))
    return q_new, sed


def _sediment_species(q, qv, temperature, pressure, rho, dz, dt,
                      fall_rate, evap_rate_base, l_heat):
    """CFL-substepped sedimentation + inter-substep evaporation for one
    species (mp_simple.f90:507-564). Per-column substep counts follow the
    reference's per-column CFL; columns finish early via masking.

    Returns (q, qv, temperature, accumulated_surface_precip)."""
    # per-column cfl count: ceil(max_k dt*v/dz)  (mp_simple.f90:511)
    cfl = jnp.ceil(jnp.max(dt / dz * fall_rate, axis=0))          # (ny, nx)
    n_max = jnp.max(cfl).astype(jnp.int32)
    fall_dist = dt * fall_rate / cfl                              # (ny, nx) [m]
    evap_rate = evap_rate_base / (2.0 * cfl)

    def substep(carry):
        s, q, qv, t, precip = carry
        active = (s < cfl)                                        # (ny, nx)
        q_new, sed = _sediment_substep(q, fall_dist, rho, dz)
        q = jnp.where(active[None], q_new, q)
        precip = precip + jnp.where(active, sed, 0.0)
        # evaporate/sublimate fallen precip in subsaturated layers
        qvsat = sat_mr(t, pressure)
        l_evap = l_heat(t)
        m = active[None] & (qv < qvsat) & (q > SMALL)
        t_e, q_e, qv_e = phase_change(t, q, qvsat, qv, l_evap, evap_rate[None])
        t = jnp.where(m, t_e, t)
        q = jnp.where(m, q_e, q)
        qv = jnp.where(m, qv_e, qv)
        return s + 1, q, qv, t, precip

    def cond(carry):
        return carry[0] < n_max

    precip0 = jnp.zeros(q.shape[1:], q.dtype)
    _, q, qv, temperature, precip = jax.lax.while_loop(
        cond, substep, (jnp.int32(0), q, qv, temperature, precip0))
    return q, qv, temperature, precip


def mp_simple(pressure, theta, exner, rho, qv, qc, qr, qs, rain, snow,
              dt, dz, mesh=None, interpret=False):
    """Full scheme driver (mp_simple_driver, mp_simple.f90:595-646).

    All 3D args are (z, y, x); rain/snow are (y, x) accumulators [mm].
    Returns updated (theta, qv, qc, qr, qs, rain, snow).

    On the GPU the whole scheme runs as one column-local kernel
    (ops/sb04_kernel.py), per shard under ``mesh``. Every other backend
    runs ``mp_simple_jnp``, the reference (GSPMD partitions it under a
    mesh). ``interpret=True`` runs the kernel through the Pallas
    interpreter on any backend; only tests pass it."""
    from ..core.state import compute_device
    device = mesh.devices.flat[0] if mesh is not None else compute_device()
    args = (pressure, theta, exner, rho, qv, qc, qr, qs, rain, snow, dt, dz)
    if device.platform != "gpu" and not interpret:
        return mp_simple_jnp(*args)
    from ..ops import sb04_kernel
    if mesh is None:
        return sb04_kernel.mp_simple(*args, interpret=interpret)
    return sb04_kernel.mp_simple_sharded(mesh, *args, interpret=interpret)


def mp_simple_jnp(pressure, theta, exner, rho, qv, qc, qr, qs, rain, snow,
                  dt, dz):
    """The scheme in plain jnp: the reference implementation, and the
    path of every backend but the GPU."""
    cloud2snow = jnp.exp(-SNOW_FORMATION_TC * dt)
    cloud2rain = jnp.exp(-RAIN_FORMATION_TC * dt)

    temperature = theta * exner
    temperature, qv, qc, qr, qs = mp_conversions(
        pressure, temperature, qv, qc, qr, qs, dt, cloud2rain, cloud2snow)

    def l_evap_fn(t):
        return -(LH_VAPOR + (373.15 - t) * DLHVDT)

    def l_subl_fn(t):
        return -LH_LIQUID + l_evap_fn(t)

    # rain sedimentation (only when rain exists anywhere, mp_simple.f90:507)
    def do_rain(args):
        qr, qv, t, rain = args
        qr, qv, t, sed = _sediment_species(
            qr, qv, t, pressure, rho, dz, dt, RAIN_FALL_RATE,
            cloud2rain, l_evap_fn)
        return qr, qv, t, rain + sed
    def no_rain(args):
        return args
    qr, qv, temperature, rain = jax.lax.cond(
        jnp.max(qr) > SMALL, do_rain, no_rain,
        (qr, qv, temperature, rain))

    # snow sedimentation; snowfall adds to both snow and total rain
    # (mp_simple.f90:542-549)
    def do_snow(args):
        qs, qv, t, rain, snow = args
        qs, qv, t, sed = _sediment_species(
            qs, qv, t, pressure, rho, dz, dt, SNOW_FALL_RATE,
            cloud2snow, l_subl_fn)
        return qs, qv, t, rain + sed, snow + sed
    def no_snow(args):
        return args
    qs, qv, temperature, rain, snow = jax.lax.cond(
        jnp.max(qs) > SMALL, do_snow, no_snow,
        (qs, qv, temperature, rain, snow))

    theta = temperature / exner
    return theta, qv, qc, qr, qs, rain, snow

"""SB04 microphysics as one column-local Pallas kernel for NVIDIA GPUs.

The jnp scheme (physics/mp_simple.py) runs the saturation adjustment as a
data-dependent ``lax.while_loop`` of up to 15 full-grid sweeps, then a
CFL-substepped fall loop per species. On XLA:GPU every trip of those loops
re-reads and re-writes the fields in device memory, launches the loop body
again and reads the loop predicate back on the host. The scheme is
column-local, so here each program of a Pallas kernel (Triton route) takes
a block of contiguous columns of the grid flattened to (nz, ny*nx) — loads
along x are coalesced — loops over z inside the program, and runs both
loops with an exit per block. The fall loops work in place on the
block's columns of the outputs, which stay in cache: device memory sees
about 9 field reads and 7 writes per call.

The per-cell arithmetic is the jnp reference's, op for op:

- saturation adjustment (cloud_conversion, mp_simple.f90:198-280): one
  loop per level, up to ``N_SAT_ITERS`` trips while any cell of the block
  at that level is active. A cell's result depends only on its own trips
  (an inactive cell never becomes active again), so the per-block loop
  equals the jnp whole-grid loop. A cell is reverted to its entry state
  iff it was active in all ``N_SAT_ITERS`` trips — the jnp path's per-cell
  ``niter >= 15`` count, carried here the same way;
- conversions (mp_conversions, mp_simple.f90:381-420);
- sedimentation (mp_simple.f90:507-564): per-column CFL substep counts;
  the block runs the largest count in the block with a per-column active
  mask, as the jnp loop does over the grid.

One difference is deliberate: the jnp path skips a species' fall loop when
its global maximum is at most 1e-30 (``SMALL``); the kernel skips it when
the block holds none of it at all. The two agree whenever any cell of the
grid holds more than 1e-30 kg/kg of that species.

``interpret=True`` runs the kernel through the Pallas interpreter; only
tests and ``chip_smoke.py --rehearse`` pass it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..physics.mp_simple import (DLHVDT, FREEZING, HEAT_CAPACITY, LH_LIQUID,
                                 LH_VAPOR, MAXERR, N_SAT_ITERS,
                                 RAIN_CLOUD_INIT, RAIN_FALL_RATE,
                                 RAIN_FORMATION_TC, SMALL, SNOW_CLOUD_INIT,
                                 SNOW_FALL_RATE, SNOW_FORMATION_TC,
                                 cloud2hydrometeor, phase_change, sat_mr)

# columns per program and warps per program, tuned on the H100 at
# 500x500x20 (PERF.md): small blocks leave the data-dependent loops as
# soon as their own columns converge
BLOCK = 64
NUM_WARPS = 1


def _saturation(p, t0, qv0, qc0):
    """cloud_conversion on one level of the block; returns (t, qv, qc,
    qvsat) with the jnp reference's op order."""
    vapor2temp = (LH_VAPOR + (373.15 - t0) * DLHVDT) / HEAT_CAPACITY

    def cond(c):
        t, qv, qc, qvsat, lastqv, niter, it = c
        busy = jnp.where(jnp.abs(lastqv - qv) > MAXERR, 1, 0)
        return (it < N_SAT_ITERS) & (jnp.max(busy) > 0)

    def body(c):
        t, qv, qc, qvsat, lastqv, niter, it = c
        active = jnp.abs(lastqv - qv) > MAXERR
        lastqv = jnp.where(active, qv, lastqv)
        qvs = sat_mr(t, p)
        qvsat = jnp.where(active, qvs, qvsat)
        supersat = qv > qvs
        exc_sup = (qv - qvs) * 0.5
        t_sup = t + exc_sup * vapor2temp
        qv_sup = qv - exc_sup
        qc_sup = qc + exc_sup
        exc_un = (qvs - qv) * 0.5
        evap = jnp.where(exc_un >= qc, qc, exc_un)
        t_un = t - evap * vapor2temp
        qv_un = qv + evap
        qc_un = qc - evap
        has_cloud = qc > 0
        t_new = jnp.where(supersat, t_sup, jnp.where(has_cloud, t_un, t))
        qv_new = jnp.where(supersat, qv_sup,
                           jnp.where(has_cloud, qv_un, qv))
        qc_new = jnp.where(supersat, qc_sup,
                           jnp.where(has_cloud, qc_un, qc))
        t = jnp.where(active, t_new, t)
        qv = jnp.where(active, qv_new, qv)
        qc = jnp.where(active, qc_new, qc)
        niter = niter + active.astype(jnp.int32)
        return t, qv, qc, qvsat, lastqv, niter, it + 1

    init = (t0, qv0, qc0, jnp.zeros_like(qv0), qv0 + 2 * MAXERR,
            jnp.zeros(qv0.shape, jnp.int32), jnp.int32(0))
    t, qv, qc, qvsat, _, niter, _ = jax.lax.while_loop(cond, body, init)
    failed = niter >= N_SAT_ITERS
    t = jnp.where(failed, t0, t)
    qv = jnp.where(failed, sat_mr(t0, p), qv)
    qc = jnp.where(failed, qc0, qc)
    return t, qv, jnp.maximum(qc, 0.0), qvsat


def _conversions(t0, t, qv, qc, qr, qs, qvsat, cloud2rain, cloud2snow):
    """mp_conversions after the saturation stage, on one level; latent
    heats come from the pre-adjustment temperature ``t0``."""
    l_melt = -LH_LIQUID
    l_evap = -(LH_VAPOR + (373.15 - t0) * DLHVDT)
    l_subl = l_melt + l_evap
    any_species = (qc + qr + qs) > SMALL
    qc_big = qc > SMALL
    warm = t > FREEZING

    m = any_species & qc_big & warm
    qc_r, qr_r = cloud2hydrometeor(qc, qr, cloud2rain, RAIN_CLOUD_INIT)
    qc = jnp.where(m, qc_r, qc)
    qr = jnp.where(m, qr_r, qr)
    mm = m & (qs > SMALL)
    t_m, qs_m, qr_m = phase_change(t, qs, 100.0, qr, l_melt, cloud2rain)
    t = jnp.where(mm, t_m, t)
    qs = jnp.where(mm, qs_m, qs)
    qr = jnp.where(mm, qr_m, qr)

    mc = any_species & qc_big & ~warm
    qc_s, qs_s = cloud2hydrometeor(qc, qs, cloud2snow, SNOW_CLOUD_INIT)
    qc = jnp.where(mc, qc_s, qc)
    qs = jnp.where(mc, qs_s, qs)

    unsat = any_species & (qv < qvsat)
    mr = unsat & (qr > SMALL)
    t_e, qr_e, qv_e = phase_change(t, qr, qvsat, qv, l_evap, cloud2rain / 2)
    t = jnp.where(mr, t_e, t)
    qr = jnp.where(mr, qr_e, qr)
    qv = jnp.where(mr, qv_e, qv)
    ms = unsat & (qs > SMALL)
    t_s, qs_e, qv_s = phase_change(t, qs, qvsat, qv, l_subl, cloud2snow / 2)
    t = jnp.where(ms, t_s, t)
    qs = jnp.where(ms, qs_e, qs)
    qv = jnp.where(ms, qv_s, qv)
    return t, qv, qc, qr, qs


def _sediment(q_ref, qv_ref, t_ref, load, store, nz, dt, fall_rate,
              evap_base, snow):
    """The CFL-substepped fall of one species with evaporation between
    substeps (_sediment_species), in place on the block's columns of
    ``q_ref``/``qv_ref``/``t_ref``. ``load(ref, k)`` reads level k of a
    ref (or of a read-only input, by name); ``store(ref, k, v)`` writes
    it. Returns the surface precipitation of the call."""
    def loop(body, init):
        return jax.lax.fori_loop(0, nz, body, init)

    cfl = jnp.ceil(loop(
        lambda k, c: jnp.maximum(c, dt / load("dz", k) * fall_rate),
        jnp.zeros_like(load("dz", 0))))
    fall_dist = dt * fall_rate / cfl
    evap_rate = evap_base / (2.0 * cfl)
    # an all-zero block is a fixed point of the substep: every flux is 0
    # and every phase change needs q > SMALL
    held = loop(lambda k, c: jnp.maximum(c, jnp.max(load(q_ref, k))),
                jnp.float32(0.0))
    n = jnp.where(held > 0.0, jnp.max(cfl).astype(jnp.int32), 0)

    def l_heat(t):
        l_evap = -(LH_VAPOR + (373.15 - t) * DLHVDT)
        return -LH_LIQUID + l_evap if snow else l_evap

    def substep(c):
        s, precip = c
        active = s < cfl
        sed = fall_dist * load(q_ref, 0) * load("rho", 0)

        def level(k, carry):
            # ascending k: level k+1 still holds this substep's input
            q_k, rho_k, dz_k = load(q_ref, k), load("rho", k), load("dz", k)
            up = jnp.minimum(k + 1, nz - 1)
            gain = jnp.where(k + 1 < nz,
                             fall_dist * load(q_ref, up) * load("rho", up),
                             0.0)
            loss = jnp.where(k > 0, fall_dist * q_k * rho_k, 0.0)
            q_new = q_k + (gain - loss) / (rho_k * dz_k)
            q_new = jnp.where(k == 0, q_new + -sed / (dz_k * rho_k), q_new)
            q = jnp.where(active, q_new, q_k)
            t, qv = load(t_ref, k), load(qv_ref, k)
            qvsat = sat_mr(t, load("p", k))
            m = active & (qv < qvsat) & (q > SMALL)
            t_e, q_e, qv_e = phase_change(t, q, qvsat, qv, l_heat(t),
                                          evap_rate)
            store(q_ref, k, jnp.where(m, q_e, q))
            store(t_ref, k, jnp.where(m, t_e, t))
            store(qv_ref, k, jnp.where(m, qv_e, qv))
            return carry

        loop(level, 0)
        return s + 1, precip + jnp.where(active, sed, 0.0)

    _, precip = jax.lax.while_loop(lambda c: c[0] < n, substep,
                                   (jnp.int32(0), jnp.zeros_like(cfl)))
    return precip


def _kernel(scal_ref, p_ref, ex_ref, th_ref, rho_ref, dz_ref, qv_ref,
            qc_ref, qr_ref, qs_ref, th_o, qv_o, qc_o, qr_o, qs_o, sedr_o,
            seds_o, *, nz, ncol, block, barrier):
    cols = pl.program_id(0) * block + jnp.arange(block)
    valid = cols < ncol
    dt, cloud2rain, cloud2snow = scal_ref[0], scal_ref[1], scal_ref[2]
    # lanes past the last column read neutral clear air, so they cannot
    # feed NaNs or extra trips into the block's reductions
    named = {"p": (p_ref, 1e5), "ex": (ex_ref, 1.0), "th": (th_ref, 300.0),
             "rho": (rho_ref, 1.0), "dz": (dz_ref, 1e9)}

    def load(ref, k):
        ref, other = named[ref] if isinstance(ref, str) else (ref, 0.0)
        return plgpu.load(ref.at[k * ncol + cols], mask=valid, other=other)

    def store(ref, k, v):
        plgpu.store(ref.at[k * ncol + cols], v, mask=valid)

    def sync():
        # the phases hand their fields over through the outputs; each
        # column stays with one thread, the barrier makes it explicit
        if barrier:
            plgpu.debug_barrier()

    # phase 1, level by level: saturation adjustment and conversions
    # (the outputs hold the temperature in th_o until the last phase)
    def column_physics(k, carry):
        p = load("p", k)
        t0 = load("th", k) * load("ex", k)
        t, qv, qc, qvsat = _saturation(p, t0, load(qv_ref, k),
                                       load(qc_ref, k))
        t, qv, qc, qr, qs = _conversions(
            t0, t, qv, qc, load(qr_ref, k), load(qs_ref, k), qvsat,
            cloud2rain, cloud2snow)
        for ref, v in ((th_o, t), (qv_o, qv), (qc_o, qc), (qr_o, qr),
                       (qs_o, qs)):
            store(ref, k, v)
        return carry

    jax.lax.fori_loop(0, nz, column_physics, 0)
    sync()
    sed_r = _sediment(qr_o, qv_o, th_o, load, store, nz, dt,
                      RAIN_FALL_RATE, cloud2rain, snow=False)
    sync()
    sed_s = _sediment(qs_o, qv_o, th_o, load, store, nz, dt,
                      SNOW_FALL_RATE, cloud2snow, snow=True)
    sync()

    def to_theta(k, carry):
        store(th_o, k, load(th_o, k) / load("ex", k))
        return carry

    jax.lax.fori_loop(0, nz, to_theta, 0)
    plgpu.store(sedr_o.at[cols], sed_r, mask=valid)
    plgpu.store(seds_o.at[cols], sed_s, mask=valid)


def mp_simple(pressure, theta, exner, rho, qv, qc, qr, qs, rain, snow, dt,
              dz, *, block: int = BLOCK, interpret: bool = False):
    """physics/mp_simple.mp_simple_jnp through the kernel: the same (nz,
    ny, nx) fields and (ny, nx) accumulators in, the same (theta, qv, qc,
    qr, qs, rain, snow) out, the call's surface rain and snow [mm] added
    to the accumulators as the jnp scheme adds them. ``block`` (columns
    per program) is a keyword for tests of partial blocks."""
    nz, ny, nx = pressure.shape
    ncol = ny * nx
    f32 = jnp.float32
    flat = [a.astype(f32).reshape(-1) for a in
            (pressure, exner, theta, rho, dz, qv, qc, qr, qs)]
    dt = jnp.asarray(dt, f32)
    scal = jnp.stack([dt, jnp.exp(-RAIN_FORMATION_TC * dt),
                      jnp.exp(-SNOW_FORMATION_TC * dt)])
    out = pl.pallas_call(
        functools.partial(_kernel, nz=nz, ncol=ncol, block=block,
                          barrier=not interpret),
        grid=(pl.cdiv(ncol, block),),
        out_shape=[jax.ShapeDtypeStruct((nz * ncol,), f32)] * 5
        + [jax.ShapeDtypeStruct((ncol,), f32)] * 2,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="sb04_microphysics",
    )(scal, *flat)
    theta, qv, qc, qr, qs = (o.reshape(nz, ny, nx) for o in out[:5])
    sed_r, sed_s = out[5].reshape(ny, nx), out[6].reshape(ny, nx)
    return theta, qv, qc, qr, qs, rain + sed_r + sed_s, snow + sed_s


def mp_simple_sharded(mesh, pressure, theta, exner, rho, qv, qc, qr, qs,
                      rain, snow, dt, dz, **kw):
    """mp_simple under a ('y', 'x') mesh: the kernel runs on each shard
    through one shard_map. The scheme is column-local, so no halo is
    exchanged. The fields are edge-padded to a multiple of the mesh (pad
    columns then hold real-looking air, never NaN-prone zeros) and
    cropped after."""
    from jax.sharding import PartitionSpec as PS

    ny, nx = pressure.shape[-2:]
    my, mx = mesh.shape["y"], mesh.shape["x"]
    nyp, nxp = -(-ny // my) * my, -(-nx // mx) * mx

    def frame(a):
        pad = [(0, 0)] * (a.ndim - 2) + [(0, nyp - ny), (0, nxp - nx)]
        return jnp.pad(a, pad, mode="edge")

    def spec(a):
        return PS(None, "y", "x") if a.ndim == 3 else PS("y", "x")

    fields = [frame(a) for a in (pressure, theta, exner, rho, qv, qc, qr,
                                 qs, rain, snow, dz)]
    # dt (traced inside the interval step) enters as a replicated operand
    out = jax.shard_map(
        lambda dt, *a: mp_simple(*a[:10], dt, a[10], **kw),
        mesh=mesh, in_specs=(PS(),) + tuple(spec(a) for a in fields),
        out_specs=(PS(None, "y", "x"),) * 5 + (PS("y", "x"),) * 2,
        check_vma=False)(jnp.asarray(dt, jnp.float32), *fields)
    return tuple(o[..., :ny, :nx] for o in out)

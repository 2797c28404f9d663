#!/usr/bin/env python
"""Per-component timing of the ridge-config substep on real hardware.

Times each piece of the inner loop (CFL reduction, diagnostics, simple
microphysics, upwind advection, and the composed substep) on the bench
domain, and converts each to achieved device-memory bandwidth from an
analytic bytes-touched model, as a share of the published peak in
bench.py's HBM_PEAK_GBPS.

Usage: python tools/perf_breakdown.py [NX NY NZ]
"""

import sys
import time

sys.path.insert(0, __import__("os").path.dirname(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__))))

import jax
import jax.numpy as jnp

from bench import peak_for


def timeit(fn, *args, n=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    nx, ny, nz = 500, 500, 20
    if len(sys.argv) == 4:
        nx, ny, nz = map(int, sys.argv[1:])

    from icar_tpu import constants as C
    from icar_tpu.core.diagnostics import compute_dt, diagnostic_update
    from icar_tpu.models.icar import ideal_ridge_model
    from icar_tpu.ops import advection
    from icar_tpu.physics import mp_simple

    print(f"building ridge model {nx}x{ny}x{nz} ...", flush=True)
    model = ideal_ridge_model(nx=nx, ny=ny, nz=nz, dx=1000.0,
                              hill_height=1000.0, u_speed=10.0, rh=0.95,
                              flat_z_height=-5)
    s = model.state
    geom = model.geom
    dev = jax.devices()[0]
    peak = peak_for(dev)
    field_mb = nz * ny * nx * 4 / 1e6
    print(f"device: {dev}  peak HBM ~{peak} GB/s  3D field = {field_mb:.1f} MB")

    dt = jnp.float32(10.0)
    dz3 = jnp.asarray(geom.dz_interface)
    dzl = jnp.asarray(geom.dz_levels, jnp.float32)

    rows = []

    def report(name, seconds, fields_touched):
        gb = fields_touched * nz * ny * nx * 4 / 1e9
        bw = gb / seconds
        rows.append((name, seconds * 1e3, fields_touched, bw,
                     100 * bw / peak))

    # --- CFL dt (reads u, v, w; reduction)
    f = jax.jit(lambda u, v, w: compute_dt(u, v, w, dzl, geom.dx, 1.4, 3))
    t = timeit(f, s["u"], s["v"], s["w"])
    report("compute_dt", t, 3)

    # --- diagnostics (partial: physics inputs only)
    f = jax.jit(lambda st: diagnostic_update(st, geom, full=False))
    t = timeit(f, dict(s))
    report("diagnostic_update(partial)", t, 4 + 7)

    # --- mp_simple (the SB04 kernel on the GPU)
    f = jax.jit(lambda st: mp_simple.mp_simple(
        st["pressure"], st["potential_temperature"], st["exner"],
        st["density"], st["water_vapor"], st["cloud_water"],
        st["rain_mass"], st["snow_mass"], st["precipitation"],
        st["snowfall"], dt, dz3))
    t = timeit(f, dict(s))
    report("mp_simple", t, 8 + 4 + 11 + 10 + 10)

    # --- upwind advection of the 5 advected species
    adv = tuple(model.advect_names)
    stacked = jnp.stack([s[k] for k in adv])
    ju = jnp.asarray(geom.jacobian_u)
    jv = jnp.asarray(geom.jacobian_v)
    jw = jnp.asarray(geom.jacobian_w)
    jc = jnp.asarray(geom.jacobian)
    adz = jnp.asarray(geom.advection_dz)

    f = jax.jit(lambda q, u, v, w, rho: advection.advect_upwind(
        q, u, v, w, dt, geom.dx, ju, jv, jw, jc, rho, adz, False))
    t = timeit(f, stacked, s["u"], s["v"], s["w"], s["density"])
    nq = len(adv)
    report(f"advect_upwind({nq} species)", t, nq * 7 + 8)

    # --- the full interval step, amortized per substep
    model.advance(600.0)
    jax.block_until_ready(model.state["potential_temperature"])
    t0 = time.perf_counter()
    reps = 3
    steps = 0
    for _ in range(reps):
        model.advance(600.0)
        steps += model.last_n_substeps
    jax.block_until_ready(model.state["potential_temperature"])
    t_sub = (time.perf_counter() - t0) / steps
    rows.append(("full substep (amortized)", t_sub * 1e3, None,
                 None, None))

    print(f"\n{'component':34s} {'ms':>8s} {'fields':>7s} "
          f"{'GB/s':>7s} {'%peak':>6s}")
    for name, ms, ftch, bw, pct in rows:
        ftch = "" if ftch is None else str(ftch)
        bw = "" if bw is None else f"{bw:7.1f}"
        pct = "" if pct is None else f"{pct:5.1f}%"
        print(f"{name:34s} {ms:8.3f} {ftch:>7s} {bw:>7s} {pct:>6s}")
    gp = nx * ny * nz / t_sub
    print(f"\nfull-step throughput: {gp/1e6:.1f}M gp*steps/s "
          f"({1.0/t_sub:.1f} substeps/s)")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Benchmark: ideal-ridge throughput in grid-points*steps/s per chip.

The north-star metric from BASELINE.json: a 500x500x20 ideal ridge with
upwind advection + SB04 simple microphysics (the reference's "fast"
configuration, run/short_icar_options.nml mp=2 adv=1), timed over whole
forcing intervals of the jitted while_loop step.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
The detail block carries roofline evidence: XLA's own bytes-accessed
cost analysis of the compiled step, converted to achieved device-memory
bandwidth and % of the device's published peak (HBM_PEAK_GBPS).

--config picks one BASELINE.md config; --matrix runs all of them and
embeds the per-config results (any failing config fails the run);
--sharded attaches a 1-device mesh (measures the GSPMD padded-frame
overhead vs the unsharded path).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# published device-memory bandwidth (GB/s) by jax device_kind. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part (80 GB HBM3,
# 3.35 TB/s).
HBM_PEAK_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}


def peak_for(device) -> float:
    """The published bandwidth of ``device``; a device missing from the
    table is an error, not a default."""
    try:
        return HBM_PEAK_GBPS[device.device_kind]
    except KeyError:
        raise KeyError(f"no published bandwidth for device kind "
                       f"{device.device_kind!r}; add it to HBM_PEAK_GBPS "
                       "with its source") from None


def build_model(config: str, nx, ny, nz):
    """The BASELINE.md config matrix. 'ridge' is the headline metric the
    driver records; the others cover MPDATA+Thompson, the linear-theory
    wind solver, and a full physics column."""
    from icar_tpu import constants as C
    from icar_tpu.models.icar import ideal_ridge_model

    common = dict(nx=nx, ny=ny, nz=nz, dx=1000.0, hill_height=1000.0,
                  u_speed=10.0, rh=0.95, flat_z_height=-5)
    if config == "ridge":
        return ideal_ridge_model(mp=C.MP_SIMPLE, windtype=C.WIND_NONE,
                                 **common)
    if config == "mpdata_thompson":
        return ideal_ridge_model(mp=C.MP_THOMPSON, adv=C.ADV_MPDATA,
                                 windtype=C.WIND_NONE, **common)
    if config == "linear":
        # LUT dims right-sized for one device: the reference defaults
        # (10x36x10) need 144 GB at 500^2x20 — the reference itself only
        # runs that distributed across many images (it prints the
        # per-image footprint, linear_winds.f90:682). 5x8x3 entries =
        # 4.8 GB, inside the enforced max_lut_gb budget; a multi-device
        # mesh shards the spatial dims for bigger tables.
        def lut_cb(o):
            o.lt.n_spd_values = 5
            o.lt.n_dir_values = 8
            o.lt.n_nsq_values = 3
            # buffered terrain is nx + 2*(buffer+2); 48 makes it 600 =
            # 2^3*3*5^2 (the default 50 gives 604 = 4*151, whose prime
            # factor forces a Bluestein FFT)
            o.lt.buffer = 48
            # a long host build at this scale: cache it across runs
            # inside the checkout (parameter-validated, lt_lut_io.f90
            # semantics)
            os.makedirs(os.path.join(ROOT, ".bench_cache"), exist_ok=True)
            o.lt.read_lut = o.lt.write_lut = True
            o.lt.lut_filename = os.path.join(ROOT, ".bench_cache",
                                             "linear_lut.npz")
        return ideal_ridge_model(mp=C.MP_SIMPLE, windtype=C.WIND_LINEAR,
                                 options_cb=lut_cb, **common)
    if config == "fullphys":
        return ideal_ridge_model(
            mp=C.MP_THOMPSON, windtype=C.WIND_CONSERVE_MASS,
            rad=C.RA_SIMPLE, pbl=C.PBL_SIMPLE, lsm=C.LSM_NOAH,
            water=C.WATER_SIMPLE, conv=C.CU_TIEDTKE, **common)
    if config == "fullphys_rrtmg":
        # the FLAGSHIP expensive physics (VERDICT r4 missing #3): full
        # RRTMG LW+SW with the reference's update-interval throttle
        # (rad_parameters update_interval_rrtmg = 1800 s,
        # opt_types.f90:156 / ra_driver.f90:304), YSU PBL and NoahMP
        # LSM. The external RRTMG k-distribution data files are not
        # shippable (the reference downloads them separately), so the
        # bench injects SYNTHETIC k-tables with the REAL per-band
        # dimensions (NGC/NSPA/NSPB g-points + every minor-species
        # table): the measured compute/memory cost equals the
        # real-data cost; only the radiance values are physical-shaped
        # noise.
        from icar_tpu.physics import rrtmg_lw, rrtmg_sw
        from icar_tpu.physics.rrtmg_lw_tables import synthetic_lw_tables
        from icar_tpu.physics.rrtmg_sw_tables import synthetic_sw_tables
        rrtmg_lw.set_lw_tables(synthetic_lw_tables())
        rrtmg_sw.set_sw_tables(synthetic_sw_tables())
        m = ideal_ridge_model(
            mp=C.MP_THOMPSON, windtype=C.WIND_CONSERVE_MASS,
            rad=C.RA_RRTMG, pbl=C.PBL_YSU, lsm=C.LSM_NOAHMP,
            water=C.WATER_SIMPLE, conv=C.CU_TIEDTKE, **common)
        _init_noahmp_state(m)
        return m
    if config == "conus":
        # CONUS-scale domain-decomposed run (BASELINE.md): full physics
        # sharded over every available device. With a single device this
        # still attaches a 1-device mesh so the measured program IS the
        # domain-decomposed one (padded frame + GSPMD partitioning)
        import jax
        from icar_tpu.parallel.mesh import make_mesh
        m = ideal_ridge_model(
            mp=C.MP_THOMPSON, windtype=C.WIND_CONSERVE_MASS,
            rad=C.RA_SIMPLE, pbl=C.PBL_SIMPLE, lsm=C.LSM_NOAH,
            water=C.WATER_SIMPLE, conv=C.CU_TIEDTKE, **common)
        m.attach_mesh(make_mesh(nx, ny, jax.devices()))
        return m
    raise SystemExit(f"unknown config {config!r}")


LABELS = {
    "ridge": "upwind+mp_simple",
    "mpdata_thompson": "MPDATA+Thompson",
    "linear": "linear winds+mp_simple",
    "fullphys": "Thompson+Noah+PBL+rad+Tiedtke",
    "fullphys_rrtmg": "Thompson+NoahMP+YSU+RRTMG(LW+SW)+Tiedtke",
    "conus": "full physics, domain-decomposed",
}


def _init_noahmp_state(m):
    """Consistent NoahMP initial state for an ideal run (the reference
    reads these from forcing/land files; noahmp_init mirror —
    tests/test_noahmp.py e2e setup)."""
    import jax.numpy as jnp
    import numpy as np

    from icar_tpu.physics import noahmp as nmp_mod
    from icar_tpu.physics.noah_params import load_tables
    from icar_tpu.physics.noahmp_params import load_mp_tables

    s = {k: np.array(v) for k, v in m.state.items()}
    s["skin_temperature"] = np.asarray(
        m.state["temperature"][0], np.float32).copy()
    s["soil_temperature"][:] = s["skin_temperature"][None]
    s["soil_deep_temperature"] = s["skin_temperature"].copy()
    init = nmp_mod.noahmp_init_state(
        s["skin_temperature"], s["swe"].astype(np.float32),
        s["snow_height"], s["soil_temperature"],
        s["soil_water_content"], s["soil_type"], s["veg_type"],
        load_mp_tables(), load_tables())
    st = dict(m.state)
    for k, v in s.items():
        st[k] = jnp.asarray(v, st[k].dtype)
    field_map = {
        "snow_albedo_prev": "albold", "snow_water_eq_prev": "sneqvo",
        "soil_liquid_water": "sh2o", "canopy_temperature": "tah",
        "canopy_vapor_pressure": "eah", "veg_leaf_temperature": "tv",
        "ground_surf_temperature": "tg", "snow_layer_depth": "zsnso",
        "water_table_depth": "zwt", "water_aquifer": "wa",
        "storage_gw": "wt", "lai": "lai", "sai": "sai"}
    for f, k in field_map.items():
        st[f] = jnp.asarray(init[k], st[f].dtype)
    st["snow_nlayers"] = jnp.asarray(init["isnow"], jnp.float32)
    st["snow_temperature"] = jnp.asarray(init["stc"][:3])
    st["soil_temperature"] = jnp.asarray(init["stc"][3:])
    m.state = st


def step_bytes_accessed(model, interval):
    """XLA's bytes-accessed cost analysis of the compiled interval step.

    The while_loop body is counted ONCE, so for a multi-substep interval
    this approximates bytes per substep (plus the interval-end diagnostics
    and, for sharded runs, the padded-frame slicing). Custom calls (the
    SB04 kernel) report their operand+result bytes."""
    import jax.numpy as jnp
    lowered = model._step_fn.lower(model.state, model._dqdt,
                                   jnp.float32(0.0), jnp.float32(interval),
                                   model._time_aux(), model.geom_args())
    ca = lowered.compile().cost_analysis()
    return float(ca.get("bytes accessed", 0.0)) or None


def run_config(config, nx, ny, nz, sharded=False, n_timed=3,
               interval=1200.0):
    import jax

    peak = peak_for(jax.devices()[0])     # unknown devices fail up front
    t0 = time.time()
    model = build_model(config, nx, ny, nz)
    if sharded and model.mesh is None:
        from icar_tpu.parallel.mesh import make_mesh
        model.attach_mesh(make_mesh(nx, ny, jax.devices()[:1]))

    pre_advance = None
    if config == "linear":
        # the BASELINE names "linear-theory wind solver with time-varying
        # forcing": every interval pays one update_winds — the spatial-LUT
        # stability evaluation + trilinear lookup + perturbation relax +
        # balance (driver.f90:128-138 runs update_winds per forcing step)
        import jax.numpy as jnp

        from icar_tpu.forcing.ideal import make_ideal_case
        case = make_ideal_case(model.geom, u_profile=10.0, rh=0.95)
        u0, v0 = jnp.asarray(case.u), jnp.asarray(case.v)

        def pre_advance(m):
            u, v, w = m.compute_winds(u0, v0, rotate=True)
            m.state = {**m.state, "u": u, "v": v, "w": w}
    setup_s = time.time() - t0

    # every timed region ends in block_until_ready on the (donated)
    # state, which waits for the step on the GPU; the substep counts are
    # fetched outside the timers. warmup: compile + one interval
    t0 = time.time()
    if pre_advance is not None:
        pre_advance(model)
    model.advance(interval)
    jax.block_until_ready(model.state)
    warmup_s = time.time() - t0

    t0 = time.time()
    ns = []
    wind_s = 0.0
    for _ in range(n_timed):
        if pre_advance is not None:
            # time the per-interval wind update (the spatial-LUT
            # stability evaluation + occupancy-gated stream + balance)
            # as its own number: folding it into the substep fit made
            # per_substep_ms/interval_overhead_ms meaningless for the
            # linear config (VERDICT r4 weak #5)
            tw = time.time()
            pre_advance(model)
            jax.block_until_ready(model.state["w"])
            wind_s += time.time() - tw
        model.advance(interval)
        ns.append(model._last_n)
    jax.block_until_ready(model.state)
    elapsed = time.time() - t0
    steps = sum(int(n) for n in ns)

    # sanity: state must stay finite
    import numpy as np
    th = np.asarray(model.field("potential_temperature"))
    assert np.isfinite(th).all(), "non-finite state after benchmark run"

    gp_steps_per_s = nx * ny * nz * steps / elapsed
    advance_s = elapsed - wind_s
    detail = {
        "substeps": steps,
        "elapsed_s": round(elapsed, 3),
        "warmup_s": round(warmup_s, 3),
        "setup_s": round(setup_s, 3),
        "steps_per_s": round(steps / elapsed, 3),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    if wind_s > 0:
        detail["wind_update_ms"] = round(wind_s / n_timed * 1e3, 1)
    # split per-substep cost from the per-interval overhead (the hoisted
    # CFL/diagnostics prologue, interval-end diagnostics, limits pass):
    # time one short interval, fit t = a + b*n against the long ones.
    # The wind-update time is excluded (reported separately above).
    n_long = steps / n_timed
    t0 = time.time()
    model.advance(interval / 8)
    jax.block_until_ready(model.state)
    t_short = time.time() - t0
    n_short = model.last_n_substeps
    b_fit = a_fit = None
    if n_long > n_short:
        b_fit = (advance_s / n_timed - t_short) / (n_long - n_short)
        if b_fit <= 0:
            # timing noise made the short interval slower than the long
            # ones; a negative slope would record negative per_substep_ms
            # and roofline_pct — fall back to the naive accounting
            b_fit = None
        else:
            a_fit = max(t_short - b_fit * n_short, 0.0)
            detail["per_substep_ms"] = round(b_fit * 1e3, 3)
            detail["interval_overhead_ms"] = round(a_fit * 1e3, 3)
    ba = step_bytes_accessed(model, interval)
    if ba:
        # XLA's bytes-accessed counts ONE execution of the compiled
        # interval program: the while body ONCE plus the pre/post
        # segments. Under the memory-bound assumption time ~ bytes, the
        # a/b fit splits it; the steady-state roofline uses the per-
        # substep share only (the naive ba*steps/elapsed overstates
        # bandwidth by the pre/post share).
        detail["bytes_per_program"] = int(ba)
        if b_fit and a_fit is not None and (a_fit + b_fit) > 0:
            body = ba * b_fit / (a_fit + b_fit)
            bw = body / b_fit / 1e9
            detail["bytes_per_substep"] = int(body)
        else:
            bw = ba * (steps / elapsed) / 1e9
            detail["bytes_per_substep"] = int(ba)
        detail["achieved_hbm_gbps"] = round(bw, 1)
        detail["hbm_peak_gbps"] = peak
        detail["roofline_pct"] = round(100.0 * bw / peak, 1)
    if sharded:
        detail["sharded_1dev"] = True
    return gp_steps_per_s, detail


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="ridge", choices=list(LABELS))
    ap.add_argument("--size", default="500x500x20",
                    help="domain as NXxNYxNZ")
    ap.add_argument("--matrix", action="store_true",
                    help="run every BASELINE config; embed per-config "
                         "results in detail.matrix")
    ap.add_argument("--sharded", action="store_true",
                    help="attach a 1-device mesh (GSPMD overhead probe)")
    args = ap.parse_args()
    nx, ny, nz = (int(s) for s in args.size.split("x"))

    if args.matrix:
        matrix = {}
        for cfg in LABELS:
            v, d = run_config(cfg, nx, ny, nz)
            matrix[cfg] = {"gp_steps_per_s": round(v, 1), **d}
            print(f"# {cfg}: {matrix[cfg]}", file=sys.stderr, flush=True)
        ridge = matrix.get("ridge", {})
        result = {
            "metric": (f"grid-points*steps/s per chip (ideal ridge "
                       f"{nx}x{ny}x{nz}, {LABELS['ridge']})"),
            "value": ridge.get("gp_steps_per_s"),
            "unit": "gp*steps/s",
            "vs_baseline": None,
            "detail": {"matrix": matrix},
        }
        print(json.dumps(result))
        return

    value, detail = run_config(args.config, nx, ny, nz,
                               sharded=args.sharded)
    result = {
        "metric": (f"grid-points*steps/s per chip (ideal ridge "
                   f"{nx}x{ny}x{nz}, {LABELS[args.config]})"),
        "value": round(value, 1),
        "unit": "gp*steps/s",
        "vs_baseline": None,
        "detail": detail,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()

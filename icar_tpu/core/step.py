"""The inner physics loop: one forcing interval as a jitted while_loop.

JAX re-implementation of step (/root/reference/src/main/time_step.f90:440-551).
The whole substep loop — CFL dt (a global reduction), diagnostics, operator-
split physics (rad -> lsm -> pbl -> cu -> mp -> advect), forcing relaxation
and limit enforcement — traces into ONE XLA computation. The reference's
explicit halo_send/halo_retrieve around microphysics disappears: stencil
slices on sharded arrays compile to collectives scheduled by XLA, which
overlaps them with column physics automatically.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..config import Options
from ..ops import advection, wind
from ..physics import mp_simple
from .diagnostics import compute_dt, diagnostic_update

# fields whose forcing tendency is applied everywhere (non-advected);
# advected scalars are forced at the lateral boundaries only
# (apply_forcing, domain_obj.f90:2383-2448)
FULL_FIELD_FORCED = ("u", "v", "w", "pressure")

# fields clamped to >= 0 near the end of an interval (enforce_limits,
# domain_obj.f90:2228)
LIMITED_FIELDS = (
    "water_vapor", "cloud_water", "cloud_ice", "rain_mass", "snow_mass",
    "graupel_mass", "cloud_number", "ice_number", "rain_number",
    "snow_number", "graupel_number",
)


def geom_array_fields(geom):
    """Names of the Geometry arrays passed to the jitted step as
    ARGUMENTS rather than trace-time constants: each 3D metric embedded
    as an MLIR constant costs ~40 MB of serialized module at 500^2 (the
    full-physics step reached 775 MB and exceeded the compile-transport
    limit). 1D/scalar members stay closure constants."""
    import dataclasses
    return tuple(
        f.name for f in dataclasses.fields(geom)
        if isinstance(getattr(geom, f.name), np.ndarray)
        and getattr(geom, f.name).ndim >= 2)


def geom_arguments(geom):
    """The numpy geometry-argument dict for the jitted step."""
    return {k: np.asarray(getattr(geom, k)) for k in geom_array_fields(geom)}


def boundary_mask(ny: int, nx: int, dtype=np.float32):
    """1 on the lateral domain boundary ring, 0 inside.

    Built in numpy: it is a trace-time constant of the step function, and
    a device-resident constant would be fetched back from the device at
    lowering time (array._value), waiting on any setup work still queued
    there."""
    m = np.zeros((ny, nx), dtype)
    m[0, :] = 1.0
    m[-1, :] = 1.0
    m[:, 0] = 1.0
    m[:, -1] = 1.0
    return m


def apply_forcing(state, dqdt: Dict[str, jnp.ndarray], dt, bmask):
    """Integrate forcing tendencies for dt seconds (apply_forcing,
    domain_obj.f90:2383-2448)."""
    s = dict(state)
    for name, tend in dqdt.items():
        if name not in s:
            continue
        if name in FULL_FIELD_FORCED or s[name].ndim == 2:
            s[name] = s[name] + tend * dt
        else:
            # advected scalars: only the boundary ring is relaxed
            s[name] = s[name] + tend * dt * bmask[None]
    return s


def enforce_limits(state):
    s = dict(state)
    for name in LIMITED_FIELDS:
        if name in s:
            s[name] = jnp.maximum(s[name], 0.0)
    return s


def make_step_fn(options: Options, geom, advect_names, with_forcing: bool,
                 physics_extra=None, natural_shapes=None, mesh=None):
    """Build the jitted interval-step function.

    Returns ``step(state, dqdt, t0, end_time) -> (state, t, n_substeps)``
    where times are seconds since the interval start (traced scalars).
    ``physics_extra`` is an optional list of (name, fn) applied in order
    after the built-in sequence, each fn: (state, geom, dt) -> state.

    ``natural_shapes``: when given (sharded execution), state/dqdt arrive in
    the uniform padded frame (parallel.mesh.padded_sizes); fields are sliced
    to their natural shapes inside jit — where GSPMD handles the resulting
    uneven shardings with internal halo padding — and written back into the
    padded buffers at interval end. ``mesh`` is the mesh of that frame:
    the column-local SB04 kernel runs under it through one shard_map.
    """
    phys = options.physics
    # make-time constants stay NUMPY (see boundary_mask): numpy constants
    # embed into the lowered module locally; device arrays would each pay a
    # blocking device fetch at lowering time
    dz_levels = np.asarray(geom.dz_levels, np.float32)
    bmask = boundary_mask(geom.ny, geom.nx)
    adv_names = tuple(advect_names)
    # advected species ride the while_loop carry as ONE stacked array
    # (state["_qstack"]): physics reads them back as zero-copy slices and
    # advection's fused output becomes the next carry directly, instead of
    # restacking + unstacking every advected field every substep
    use_stack = bool(adv_names) and phys.advection in (C.ADV_UPWIND,
                                                       C.ADV_MPDATA)
    limit_floor_1d = np.asarray(
        [0.0 if k in LIMITED_FIELDS else -np.inf for k in adv_names],
        np.float32) if use_stack else None
    limit_floor = (limit_floor_1d[:, None, None, None]
                   if use_stack else None)

    sin_lat = np.sin(np.asarray(geom.lat) * (np.pi / 180.0))
    cos_lat = np.cos(np.asarray(geom.lat) * (np.pi / 180.0))
    lon2d = np.asarray(geom.lon)
    z_atm = np.asarray(geom.z[0] - geom.terrain)

    if phys.radiation == C.RA_RRTMG:
        from ..physics import rrtmg_lw as rrtmg_mod
        lw_tables = rrtmg_mod.get_lw_tables(options.rad.rrtmg_support_dir)
        if not options.rad.use_simple_sw:
            from ..physics import rrtmg_sw as rrtmg_sw_mod
            sw_tables = rrtmg_sw_mod.get_sw_tables(
                options.rad.rrtmg_support_dir)
        from ..physics.ghg import ghg_for_options
        ghg = ghg_for_options(options)

    # the Thompson scheme can consume + produce the species stack
    # directly (the fused kernel reads stack rows as static slices):
    # no per-substep unstack/restack around microphysics at all
    if phys.microphysics in (C.MP_THOMPSON, C.MP_THOMPSON_AER) and use_stack:
        from ..physics import mp_thompson as _mt
        thompson_stack_smap = _mt.stack_smap(adv_names)
    else:
        thompson_stack_smap = None
    thompson_stack_capable = (
        thompson_stack_smap is not None
        and float(options.mp.update_interval) <= 0)

    def _restack_dirty(ctx, s):
        """The current species stack: the carry stack with only the
        rows whose field was replaced since unstack written back."""
        q = ctx["stack"]
        for i, k in enumerate(adv_names):
            if s[k] is not ctx["views"][k]:
                q = q.at[i].set(s[k])
        return q

    def physics_step(state, dt, t, aux, mp_elapsed, lsm_elapsed,
                     rad_elapsed, advect_clamp=None, stack_ctx=None):
        from ..physics import pbl_simple as pbl_mod
        from ..physics import ra_simple as ra_mod
        from ..physics import surface as sfc_mod

        s = state
        zeros3 = lambda: jnp.zeros_like(s["potential_temperature"])
        dz3d = jnp.asarray(geom.dz_interface)

        # --- radiation (rad, time_step.f90:488)
        if phys.radiation == C.RA_SIMPLE:
            doy = aux["day_of_year0"] + t / 86400.0
            theta, sw, lw, cc = ra_mod.ra_simple(
                s["potential_temperature"], s["exner"], s["water_vapor"],
                s.get("cloud_water", zeros3()), s.get("snow_mass", zeros3()),
                s.get("rain_mass", zeros3()), s["pressure"], lon2d, sin_lat,
                cos_lat, doy, aux["year_length"], dt)
            s = dict(s)
            s["potential_temperature"] = theta
            s["shortwave"] = sw
            s["longwave"] = lw
            s["cloud_fraction"] = cc

        elif phys.radiation == C.RA_RRTMG:
            from ..physics import rrtmg_lw as rrtmg_mod
            s = dict(s)
            doy = aux["day_of_year0"] + t / 86400.0
            elev, day_frac = ra_mod.solar_elevation(
                doy, aux["year_length"], lon2d, sin_lat, cos_lat)
            # NOTE reference quirk preserved: cosz = SIN(solar_elevation)
            # (ra_driver.f90:298) — elevation, not zenith, so the name is
            # a misnomer but the value is correct for flux geometry
            s["cosine_zenith_angle"] = jnp.sin(elev)

            def do_radiation(s):
                """Recompute LW tendency + SW down (throttled to
                update_interval_rrtmg; ra_driver.f90:304-515)."""
                s = dict(s)
                qc = s.get("cloud_water", zeros3())
                qi = s.get("cloud_ice", zeros3())
                qsn = s.get("snow_mass", zeros3())
                t3d = s["temperature"]
                if options.rad.icloud == 3:
                    # Thompson cloud fraction + subgrid condensate for
                    # the radiation call only (ra_driver.f90:310-343)
                    from ..physics import cloud_fraction as cf_mod
                    cldfra, qc, qi = cf_mod.cal_cldfra3(
                        s["water_vapor"], qc, qi, qsn, dz3d,
                        s["pressure"], t3d, s["land_mask"],
                        geom.dx / 1000.0)
                    s["cloud_fraction"] = jnp.max(cldfra, axis=0)
                elif options.rad.icloud > 0:
                    # icloud=1/2: cloud fraction stays 0 — quirk of the
                    # reference flow (cldfra=0 allocated, never filled;
                    # ra_driver.f90:237 + :452-468)
                    cldfra = zeros3()
                else:
                    cldfra = zeros3()
                key = jax.random.fold_in(jax.random.PRNGKey(88),
                                         t.astype(jnp.int32))
                if options.rad.use_simple_sw:
                    # simple SW only (F_runlw=.False.; ra_driver.f90:429);
                    # qs argument is snow+ice+graupel (:434-436)
                    _, sw, _, cc = ra_mod.ra_simple(
                        s["potential_temperature"], s["exner"],
                        s["water_vapor"], qc,
                        qsn + qi + s.get("graupel_mass", zeros3()),
                        s.get("rain_mass", zeros3()), s["pressure"],
                        lon2d, sin_lat, cos_lat, doy, aux["year_length"],
                        dt, runlw=False)
                    s["shortwave"] = sw
                    s["cloud_fraction"] = cc
                    s["tend_th_swrad"] = zeros3()
                else:
                    # full RRTMG shortwave (RRTMG_SWRAD,
                    # ra_driver.f90:345-428)
                    from ..physics import rrtmg_sw as rrtmg_sw_mod
                    sw_tend, swdown, _gsw, swcf, swdir = \
                        rrtmg_sw_mod.rrtmg_sw_driver(
                            sw_tables, jax.random.fold_in(key, 1),
                            s["pressure"], s["pressure_interface"],
                            t3d, s["temperature_interface"],
                            s["cosine_zenith_angle"], s["albedo"],
                            s["water_vapor"], qc, qi, qsn, cldfra,
                            s["re_cloud"], s["re_ice"], s["re_snow"],
                            s["density"], dz3d, s["exner"],
                            xland=s["land_mask"], ghg=ghg)
                    s["tend_th_swrad"] = sw_tend
                    s["shortwave"] = swdown
                    s["shortwave_cloud_forcing"] = swcf
                    # direct/diffuse surface split (ra_rrtmg_sw SWDDIR /
                    # SWDDIF; default_output_metadata.f90
                    # shortwave_direct/diffuse — VERDICT r3 item #8)
                    if "shortwave_direct" in s:
                        s["shortwave_direct"] = swdir
                        s["shortwave_diffuse"] = swdown - swdir
                th_tend, glw, olr, lwcf = rrtmg_mod.rrtmg_lw_driver(
                    lw_tables, key, s["pressure"], s["pressure_interface"],
                    t3d, s["temperature_interface"], s["skin_temperature"],
                    s["water_vapor"], qc, qi, qsn, cldfra, s["re_cloud"],
                    s["re_ice"], s["re_snow"], s["density"], dz3d,
                    s["emissivity"], s["exner"], xland=s["land_mask"],
                    ghg=ghg)
                s["tend_th_lwrad"] = th_tend
                s["longwave"] = glw
                s["out_longwave_rad"] = olr
                s["longwave_cloud_forcing"] = lwcf
                return s

            rad_int = float(options.rad.update_interval_rrtmg)
            if rad_int > 0:
                rad_elapsed = rad_elapsed + dt
                run_now = rad_elapsed >= rad_int - 1e-6
                s = jax.lax.cond(run_now, do_radiation, lambda op: op, s)
                rad_elapsed = jnp.where(run_now, 0.0, rad_elapsed)
            else:
                s = do_radiation(s)
            # heating applied every substep from the stored tendencies
            # (ra_driver.f90:516)
            s["potential_temperature"] = (
                s["potential_temperature"]
                + (s["tend_th_lwrad"] + s["tend_th_swrad"]) * dt)

        # --- land / water surface (lsm, time_step.f90:491)
        # flux/soil computation is throttled by lsm update_interval
        # (default 300 s; lsm_driver.f90:999-1022), while the computed
        # sensible/latent fluxes feed the lowest layers every substep
        # (apply_fluxes, lsm_driver.f90:1549-1552)
        if phys.landsurface != C.LSM_NONE or phys.watersurface != C.WATER_NONE:
            def do_surface(s, lsm_dt):
                s = dict(s)
                wind = jnp.sqrt(s["u_mass"][0] ** 2 + s["v_mass"][0] ** 2)
                sh = s.get("sensible_heat", jnp.zeros_like(wind))
                lh = s.get("latent_heat", jnp.zeros_like(wind))
                z0 = s["roughness_z0"]
                tskin = s.get("skin_temperature", s["temperature"][0])
                qv_surf = s["water_vapor"][0]
                if phys.watersurface in (C.WATER_SIMPLE, C.WATER_LAKE) \
                        and "sst" in s:
                    # under water=3 the simple scheme still handles ocean
                    # cells (lsm_driver.f90:1063-1072); lake cells are
                    # overwritten below
                    water_mask = s["land_mask"] == 2.0   # kLC_WATER
                    sh, lh, z0, tskin, qv_surf = sfc_mod.water_simple(
                        s["sst"], s["surface_pressure"], wind, s["ustar"],
                        s["water_vapor"][0], s["temperature"][0], z_atm,
                        water_mask, sh, lh, z0, tskin)
                if phys.watersurface == C.WATER_LAKE:
                    # CLM lake model for lakemask cells
                    # (lsm_driver.f90:1075-1140). Precip input: accumulated
                    # precipitation since the last lsm call, like the Noah
                    # call's RAINBL (the reference passes a stale
                    # current_precipitation module variable here — its
                    # assignment at lsm_driver.f90:1082 is commented out;
                    # we use the freshly computed delta instead).
                    from ..physics import water_lake as lake_mod
                    lakemask = s["lakemask"] > 0.5
                    precip_delta = jnp.maximum(
                        (s["precipitation"] - s["rainbl"]).astype(
                            jnp.float32), 0.0)
                    lout, lfields = lake_mod.lake_driver(
                        s, s["temperature"][0], s["pressure_interface"][0],
                        s["pressure_interface"][1],
                        jnp.asarray(geom.dz_interface)[0],
                        s["water_vapor"][0], s["u_mass"][0], s["v_mass"][0],
                        s["longwave"], s["shortwave"], precip_delta,
                        jnp.asarray(geom.lat), lsm_dt)
                    sh = jnp.where(lakemask, lout["hfx"], sh)
                    lh = jnp.where(lakemask, lout["lh"], lh)
                    tskin = jnp.where(lakemask, lout["tsk"], tskin)
                    s["ground_heat_flux"] = jnp.where(
                        lakemask, lout["grdflx"], s["ground_heat_flux"])
                    s["albedo"] = jnp.where(
                        lakemask, lout["albedo"], s["albedo"])
                    for k, v in lfields.items():
                        m = lakemask[None] if v.ndim == 3 else lakemask
                        s[k] = jnp.where(m, v.astype(s[k].dtype), s[k])
                    if phys.landsurface != C.LSM_NOAH:
                        s["rainbl"] = s["precipitation"]
                if phys.landsurface == C.LSM_NOAH:
                    from ..physics import lsm_noah as noah_mod
                    from ..physics.noah_params import load_tables
                    tables = load_tables()
                    lnz = jnp.log((z_atm + z0) / z0)
                    base = (75 * C.KARMAN ** 2
                            * jnp.sqrt((z_atm + z0) / z0)) / lnz ** 2
                    chs = sfc_mod.exchange_coefficient(
                        wind, tskin, s["temperature"][0], z_atm,
                        (C.KARMAN / lnz) ** 2, base)
                    chs = chs * jnp.maximum(wind, 1.0)
                    land = s["land_mask"] == 1.0
                    veg_t = s["veg_type"].astype(jnp.int32)
                    precip_delta = jnp.maximum(
                        (s["precipitation"] - s["rainbl"]).astype(
                            jnp.float32), 0.0)
                    nout = noah_mod.noah_driver(
                        tables,
                        jnp.asarray(geom.dz_interface)[0], s["water_vapor"][0],
                        s["pressure_interface"][0], s["pressure_interface"][1],
                        s["temperature"][0], s["exner"][0],
                        s["surface_pressure"], tskin, chs,
                        s["longwave"], s["shortwave"], s["albedo"],
                        s["emissivity"], precip_delta, lsm_dt,
                        veg_t, s["soil_type"].astype(jnp.int32),
                        s["vegetation_fraction"], s["snow_albedo_max"],
                        s["soil_deep_temperature"], land,
                        s["canopy_water"], s["soil_temperature"],
                        s["soil_water_content"], s["soil_liquid_water"],
                        s["swe"].astype(jnp.float32), s["snow_height"],
                        s["snow_cover"], s["snow_time"], z0)
                    sh = jnp.where(land, nout["hfx"], sh)
                    lh = jnp.where(land, nout["lh"], lh)
                    z0 = jnp.where(land, nout["roughness"], z0)
                    tskin = jnp.where(land, nout["skin_temperature"], tskin)
                    qv_surf = jnp.where(land, nout["qsfc"], qv_surf)
                    for name, key in (
                            ("canopy_water", "canopy_water"),
                            ("soil_temperature", "soil_temperature"),
                            ("soil_water_content", "soil_water_content"),
                            ("soil_liquid_water", "soil_liquid_water"),
                            ("snow_height", "snow_height"),
                            ("snow_cover", "snow_cover"),
                            ("albedo", "albedo"),
                            ("emissivity", "emissivity"),
                            ("snow_time", "snotime"),
                            ("ground_heat_flux", "ground_heat_flux")):
                        s[name] = nout[key]
                    s["swe"] = jnp.minimum(nout["swe"],
                                           options.lsm.max_swe).astype(
                        s["swe"].dtype)
                    s["runoff_surface"] = (s["runoff_surface"]
                                           + nout["runoff_surface"])
                    s["runoff_subsurface"] = (s["runoff_subsurface"]
                                              + nout["runoff_subsurface"])
                    s["rainbl"] = s["precipitation"]
                if phys.landsurface == C.LSM_NOAHMP:
                    # NoahMP (lsm_driver.f90:1293-1517); cosz from the
                    # solar-elevation helper exactly as the reference
                    # (cosine_zenith_angle = sin(solar_elevation),
                    # lsm_driver.f90:1336-1338)
                    from ..physics import noahmp as nmp_mod
                    from ..physics import ra_simple as ra_mod
                    from ..physics.noahmp_params import (load_mp_tables,
                                                         resolve_params)
                    from ..physics.noah_params import load_tables
                    mp_tables = load_mp_tables(
                        lu_categories=options.lsm.LU_Categories)
                    veg_t = s["veg_type"].astype(jnp.int32)
                    soil_t = s["soil_type"].astype(jnp.int32)
                    pnmp = resolve_params(mp_tables, load_tables(),
                                          veg_t, soil_t)
                    doy = aux["day_of_year0"] + t / 86400.0
                    elev, _ = ra_mod.solar_elevation(
                        doy, aux["year_length"], lon2d, sin_lat, cos_lat)
                    cosz = jnp.sin(elev)
                    land = s["land_mask"] == 1.0
                    precip_delta = jnp.maximum(
                        (s["precipitation"] - s["rainbl"]).astype(
                            jnp.float32), 0.0)
                    nstate = dict(
                        albold=s["snow_albedo_prev"],
                        sneqvo=s["snow_water_eq_prev"],
                        stc=jnp.concatenate([s["snow_temperature"],
                                             s["soil_temperature"]],
                                            axis=0),
                        sh2o=s["soil_liquid_water"],
                        smc=s["soil_water_content"],
                        tah=s["canopy_temperature"],
                        eah=s["canopy_vapor_pressure"],
                        fwet=s["canopy_fwet"],
                        canliq=s["canopy_water_liquid"],
                        canice=s["canopy_water_ice"],
                        tv=s["veg_leaf_temperature"],
                        tg=s["ground_surf_temperature"],
                        qsfc=s["water_vapor"][0],
                        isnow=s["snow_nlayers"].astype(jnp.int32),
                        zsnso=s["snow_layer_depth"],
                        snowh=s["snow_height"],
                        sneqv=s["swe"].astype(jnp.float32),
                        snice=s["snow_layer_ice"],
                        snliq=s["snow_layer_liquid_water"],
                        zwt=s["water_table_depth"],
                        wa=s["water_aquifer"],
                        wt=s["storage_gw"],
                        lai=s["lai"], sai=s["sai"],
                        cm=s["coeff_momentum_drag"],
                        ch=s["coeff_heat_exchange"],
                        tauss=s["snow_age_factor"])
                    nout, nnew = nmp_mod.noahmp_driver(
                        pnmp, jnp.asarray(geom.lat), aux["year_length"],
                        doy, cosz, lsm_dt, s["vegetation_fraction"],
                        veg_t, s["temperature"][0],
                        s["pressure_interface"][1],
                        s["pressure_interface"][0],
                        s["u_mass"][0], s["v_mass"][0],
                        s["water_vapor"][0], s["shortwave"],
                        s["longwave"], precip_delta,
                        s["soil_deep_temperature"], z_atm, nstate)
                    sh = jnp.where(land, nout["hfx"], sh)
                    lh = jnp.where(land, nout["lh"], lh)
                    tskin = jnp.where(land, nout["tsk"], tskin)
                    z0 = jnp.where(land, nout["z0wrf"], z0)
                    qv_surf = jnp.where(land, nout["q1"], qv_surf)
                    s["ground_heat_flux"] = jnp.where(
                        land, nout["grdflx"], s["ground_heat_flux"])
                    alb_valid = land & (nout["albedo"] > 0.0)
                    s["albedo"] = jnp.where(alb_valid, nout["albedo"],
                                            s["albedo"])
                    s["emissivity"] = jnp.where(land, nout["emissi"],
                                                s["emissivity"])
                    s["runoff_surface"] = s["runoff_surface"] \
                        + jnp.where(land, nout["runsrf"] * lsm_dt, 0.0)
                    s["runoff_subsurface"] = s["runoff_subsurface"] \
                        + jnp.where(land, nout["runsub"] * lsm_dt, 0.0)
                    for name, key in (
                            ("snow_albedo_prev", "albold"),
                            ("snow_water_eq_prev", "sneqvo"),
                            ("soil_liquid_water", "sh2o"),
                            ("soil_water_content", "smc"),
                            ("canopy_temperature", "tah"),
                            ("canopy_vapor_pressure", "eah"),
                            ("canopy_fwet", "fwet"),
                            ("canopy_water_liquid", "canliq"),
                            ("canopy_water_ice", "canice"),
                            ("veg_leaf_temperature", "tv"),
                            ("ground_surf_temperature", "tg"),
                            ("snow_layer_depth", "zsnso"),
                            ("snow_height", "snowh"),
                            ("snow_layer_ice", "snice"),
                            ("snow_layer_liquid_water", "snliq"),
                            ("water_table_depth", "zwt"),
                            ("water_aquifer", "wa"),
                            ("storage_gw", "wt"),
                            ("lai", "lai"), ("sai", "sai"),
                            ("coeff_momentum_drag", "cm"),
                            ("coeff_heat_exchange", "ch"),
                            ("snow_age_factor", "tauss")):
                        v = nnew[key]
                        m = land[None] if v.ndim == 3 else land
                        s[name] = jnp.where(m, v.astype(s[name].dtype),
                                            s[name])
                    nsn = len(s["snow_temperature"])
                    s["snow_temperature"] = jnp.where(
                        land[None], nnew["stc"][:nsn],
                        s["snow_temperature"])
                    s["soil_temperature"] = jnp.where(
                        land[None], nnew["stc"][nsn:],
                        s["soil_temperature"])
                    s["snow_nlayers"] = jnp.where(
                        land, nnew["isnow"].astype(jnp.float32),
                        s["snow_nlayers"])
                    s["swe"] = jnp.where(
                        land,
                        jnp.minimum(nnew["sneqv"], options.lsm.max_swe),
                        s["swe"].astype(jnp.float32)).astype(
                            s["swe"].dtype)
                    s["canopy_water"] = jnp.where(
                        land, nnew["canliq"] + nnew["canice"],
                        s["canopy_water"])
                    # glacier cells (vegtype == isice) use the dedicated
                    # glacier column (noahmplsm, lsm_noahmpdrv.f90:876)
                    from ..physics import noahmp_glacier as gla_mod
                    gmask = land & (veg_t == mp_tables.isice)
                    gstate = dict(nstate)
                    ficeold_g = jnp.where(
                        nstate["snice"] + nstate["snliq"] > 0.0,
                        nstate["snice"]
                        / jnp.maximum(nstate["snice"] + nstate["snliq"],
                                      1e-6), 0.0)
                    qair_g = s["water_vapor"][0] \
                        / (1.0 + s["water_vapor"][0])
                    gout, gnew = gla_mod.glacier_sflx(
                        pnmp, cosz, lsm_dt, jnp.asarray(nmp_mod.ZSOIL),
                        s["temperature"][0], s["pressure_interface"][1],
                        s["u_mass"][0], s["v_mass"][0], qair_g,
                        s["shortwave"], s["longwave"],
                        precip_delta / lsm_dt,
                        s["soil_deep_temperature"], ficeold_g, z_atm,
                        gstate)
                    sh = jnp.where(gmask, gout["fsh"], sh)
                    lh = jnp.where(gmask, gout["fgev"], lh)
                    tskin = jnp.where(gmask, gout["trad"], tskin)
                    s["ground_heat_flux"] = jnp.where(
                        gmask, gout["ssoil"], s["ground_heat_flux"])
                    galb = gmask & (gout["albedo"] > 0.0)
                    s["albedo"] = jnp.where(galb, gout["albedo"],
                                            s["albedo"])
                    s["runoff_surface"] = s["runoff_surface"] \
                        + jnp.where(gmask, gout["runsrf"] * lsm_dt, 0.0)
                    s["runoff_subsurface"] = s["runoff_subsurface"] \
                        + jnp.where(gmask, gout["runsub"] * lsm_dt, 0.0)
                    for name, key in (
                            ("snow_water_eq_prev", "sneqvo"),
                            ("soil_liquid_water", "sh2o"),
                            ("soil_water_content", "smc"),
                            ("ground_surf_temperature", "tg"),
                            ("snow_layer_depth", "zsnso"),
                            ("snow_height", "snowh"),
                            ("snow_layer_ice", "snice"),
                            ("snow_layer_liquid_water", "snliq"),
                            ("coeff_momentum_drag", "cm"),
                            ("coeff_heat_exchange", "ch"),
                            ("snow_age_factor", "tauss")):
                        v = gnew[key]
                        m = gmask[None] if v.ndim == 3 else gmask
                        s[name] = jnp.where(m, v.astype(s[name].dtype),
                                            s[name])
                    s["snow_temperature"] = jnp.where(
                        gmask[None], gnew["stc"][:nsn],
                        s["snow_temperature"])
                    s["soil_temperature"] = jnp.where(
                        gmask[None], gnew["stc"][nsn:],
                        s["soil_temperature"])
                    s["snow_nlayers"] = jnp.where(
                        gmask, gnew["isnow"].astype(jnp.float32),
                        s["snow_nlayers"])
                    s["swe"] = jnp.where(
                        gmask,
                        jnp.minimum(gnew["sneqv"], options.lsm.max_swe),
                        s["swe"].astype(jnp.float32)).astype(
                            s["swe"].dtype)
                    s["rainbl"] = s["precipitation"]
                lnz2 = jnp.log((2.0 + z0) / z0)
                ex2 = (C.KARMAN / lnz2) ** 2 * wind
                t2, q2 = sfc_mod.surface_diagnostics(
                    sh, lh / C.LH_VAPORIZATION, tskin, qv_surf, ex2, ex2,
                    s["surface_pressure"])
                s["sensible_heat"] = sh
                s["latent_heat"] = lh
                s["roughness_z0"] = z0
                if "skin_temperature" in s:
                    s["skin_temperature"] = tskin
                if "temperature_2m" in s:
                    s["temperature_2m"] = t2
                    s["humidity_2m"] = q2

                return s

            lsm_int = float(options.lsm.update_interval)
            if lsm_int > 0:
                lsm_elapsed = lsm_elapsed + dt
                run_now = lsm_elapsed >= lsm_int - 1e-6
                s = jax.lax.cond(
                    run_now,
                    lambda op: do_surface(op[0], op[1]),
                    lambda op: op[0],
                    (s, lsm_elapsed))
                lsm_elapsed = jnp.where(run_now, 0.0, lsm_elapsed)
            else:
                s = do_surface(s, dt)
            s = dict(s)
            th, qv = sfc_mod.apply_fluxes(
                s["potential_temperature"], s["water_vapor"], s["density"],
                jnp.asarray(geom.dz_interface), s["exner"],
                s["sensible_heat"], s["latent_heat"], dt,
                sh_feedback_fraction=options.lsm.sh_feedback_fraction,
                lh_feedback_fraction=options.lsm.lh_feedback_fraction)
            s["potential_temperature"] = th
            s["water_vapor"] = qv

        # --- planetary boundary layer (pbl, time_step.f90:494)
        if phys.boundarylayer == C.PBL_YSU:
            from ..physics import ysu as ysu_mod
            s = dict(s)
            wspd10 = jnp.sqrt(s["u_10m"] ** 2 + s["v_10m"] ** 2)
            wspd10 = jnp.where(wspd10 == 0, 1e-5, wspd10)
            tskin = s["skin_temperature"]
            t1 = s["temperature"][0]
            # bulk Richardson number (calc_Richardson_nr,
            # atm_utilities.f90:1131)
            ri = C.GRAVITY / t1 * (t1 - tskin) * z_atm / (wspd10 ** 2)
            xland_r = s["land_mask"]
            # NOTE reference quirk preserved: ICAR passes CLOUD WATER as the
            # lowest-level moisture to the surface-layer scheme
            # (pbl_driver.f90:239 'qs=domain%cloud_water_mass')
            sfc = ysu_mod.surface_layer(
                s["surface_pressure"], tskin, s["pressure"][0], t1,
                s.get("cloud_water", zeros3())[0],
                s["u_mass"][0], s["v_mass"][0], z_atm, s["roughness_z0"],
                xland_r, geom.dx, s["ustar"], s["sensible_heat"],
                s["latent_heat"] / C.LH_VAPORIZATION)
            th, qv, qc, qi, hpbl, kpbl, exch_h = ysu_mod.ysu(
                s["u_mass"], s["v_mass"], s["potential_temperature"],
                s["temperature"], s["water_vapor"],
                s.get("cloud_water", zeros3()), s.get("cloud_ice", zeros3()),
                s["pressure"], s["pressure_interface"], s["exner"],
                jnp.asarray(geom.dz_interface), jnp.asarray(geom.z),
                jnp.asarray(geom.terrain), s["surface_pressure"], tskin,
                s["roughness_z0"], xland_r, s["sensible_heat"],
                s["latent_heat"] / C.LH_VAPORIZATION, s["ustar"],
                s["u_10m"], s["v_10m"], sfc.psim, sfc.psih, ri, dt)
            s["potential_temperature"] = th
            s["water_vapor"] = qv
            if "cloud_water" in s:
                s["cloud_water"] = qc
            if "cloud_ice" in s:
                s["cloud_ice"] = qi
            if "hpbl" in s:
                s["hpbl"] = hpbl
            if "exch_h" in s:
                s["exch_h"] = exch_h
        if phys.convection != C.CU_NONE and phys.boundarylayer != C.PBL_NONE:
            qv_before_pbl = s["water_vapor"]
        if phys.boundarylayer == C.PBL_SIMPLE:
            water_mask = (s["land_mask"] == 2.0) if "land_mask" in s else None
            th, qv, qc, qi, qr, qs = pbl_mod.pbl_simple(
                s["potential_temperature"], s["water_vapor"],
                s.get("cloud_water", zeros3()), s.get("cloud_ice", zeros3()),
                s.get("rain_mass", zeros3()), s.get("snow_mass", zeros3()),
                s["u_mass"], s["v_mass"], s["exner"], s["density"],
                jnp.asarray(geom.z), jnp.asarray(geom.dz_interface),
                jnp.asarray(geom.terrain), dt, water_mask)
            s = dict(s)
            s["potential_temperature"] = th
            s["water_vapor"] = qv
            for name, val in (("cloud_water", qc), ("cloud_ice", qi),
                              ("rain_mass", qr), ("snow_mass", qs)):
                if name in s:
                    s[name] = val

        # --- convection (convect, time_step.f90:497; cu_driver.f90)
        if phys.convection == C.CU_TIEDTKE:
            from ..physics import cu_tiedtke as cu_mod
            s = dict(s)
            if phys.boundarylayer != C.PBL_NONE:
                s["tend_qv_pbl"] = (s["water_vapor"] - qv_before_pbl) / dt
            w_if = jnp.concatenate(
                [jnp.zeros_like(s["w_real"][:1]), s["w_real"]], axis=0)
            # pressure_interface holds the interface BELOW each layer;
            # append the model-top interface by reflection
            p_if = jnp.concatenate(
                [s["pressure_interface"],
                 2.0 * s["pressure"][-1:] - s["pressure_interface"][-1:]],
                axis=0)
            th_c, qv_c, qc_c, qi_c, rain_c = cu_mod.tiedtke(
                s["u_mass"], s["v_mass"], w_if, s["temperature"],
                s["water_vapor"], s.get("cloud_water", zeros3()),
                s.get("cloud_ice", zeros3()), s["exner"], s["density"],
                s["tend_qv_adv"], s["tend_qv_pbl"], s["pressure"],
                p_if,
                jnp.asarray(geom.dz_interface),
                s["latent_heat"] / C.LH_VAPORIZATION, s["sensible_heat"],
                s["land_mask"], dt)
            cu = options.cu
            frac = cu.tendency_fraction
            if frac > 0:
                th0, qv0 = s["potential_temperature"], s["water_vapor"]
                if cu.tend_th_fraction > 0:
                    s["potential_temperature"] = th0 + (th_c - th0) \
                        * cu.tend_th_fraction
                if cu.tend_qv_fraction > 0:
                    s["water_vapor"] = qv0 + (qv_c - qv0) \
                        * cu.tend_qv_fraction
                if cu.tend_qc_fraction > 0 and "cloud_water" in s:
                    s["cloud_water"] = s["cloud_water"] \
                        + (qc_c - s["cloud_water"]) * cu.tend_qc_fraction
                if cu.tend_qi_fraction > 0 and "cloud_ice" in s:
                    s["cloud_ice"] = s["cloud_ice"] \
                        + (qi_c - s["cloud_ice"]) * cu.tend_qi_fraction
            s["precipitation"] = s["precipitation"] + rain_c
            s["convective_precipitation"] = (
                s["convective_precipitation"] + rain_c)

        if phys.convection == C.CU_KF:
            # Kain-Fritsch: tendencies persist across substeps while the
            # NCA countdown is positive (cu_kf.f90:224-230); the commented
            # ICAR feedback adds qr/qs tendencies to the grid-scale rain
            # and snow fields (cu_driver.f90:494-498)
            from ..physics import cu_kf as kf_mod
            s = dict(s)
            (t_th, t_qv, t_qc, t_qr, t_qi, t_qs, raincv, w0avg, nca,
             prate) = kf_mod.kfcps(
                s["u_mass"], s["v_mass"], s["potential_temperature"],
                s["water_vapor"], s["pressure"], s["density"],
                jnp.asarray(geom.dz_mass), s["w_real"], s["exner"],
                dt, geom.dx, s["kf_w0avg"], s["kf_nca"], s["kf_prate"],
                s["tend_th_cu"], s["tend_qv_cu"], s["tend_qc_cu"],
                s["tend_qr_cu"], s["tend_qi_cu"], s["tend_qs_cu"])
            s["kf_w0avg"], s["kf_nca"], s["kf_prate"] = w0avg, nca, prate
            s["tend_th_cu"], s["tend_qv_cu"] = t_th, t_qv
            s["tend_qc_cu"], s["tend_qr_cu"] = t_qc, t_qr
            s["tend_qi_cu"], s["tend_qs_cu"] = t_qi, t_qs
            cu = options.cu
            if cu.tendency_fraction > 0:
                if cu.tend_th_fraction > 0:
                    s["potential_temperature"] = (
                        s["potential_temperature"]
                        + t_th * dt * cu.tend_th_fraction)
                if cu.tend_qv_fraction > 0:
                    s["water_vapor"] = (s["water_vapor"]
                                        + t_qv * dt * cu.tend_qv_fraction)
                if cu.tend_qc_fraction > 0 and "cloud_water" in s:
                    s["cloud_water"] = (s["cloud_water"]
                                        + t_qc * dt * cu.tend_qc_fraction)
                if cu.tend_qi_fraction > 0 and "cloud_ice" in s:
                    s["cloud_ice"] = (s["cloud_ice"]
                                      + t_qi * dt * cu.tend_qi_fraction)
                if "rain_mass" in s:
                    s["rain_mass"] = s["rain_mass"] + t_qr * dt
                if "snow_mass" in s:
                    s["snow_mass"] = s["snow_mass"] + t_qs * dt
            s["precipitation"] = s["precipitation"] + raincv
            s["convective_precipitation"] = (
                s["convective_precipitation"] + raincv)

        if phys.convection == C.CU_NSAS:
            from ..physics import cu_nsas as nsas_mod
            s = dict(s)
            w_if = jnp.concatenate(
                [jnp.zeros_like(s["w_real"][:1]), s["w_real"]], axis=0)
            p_if = jnp.concatenate(
                [s["pressure_interface"],
                 2.0 * s["pressure"][-1:] - s["pressure_interface"][-1:]],
                axis=0)
            th_c, qv_c, qc_c, qi_c, rain_c = nsas_mod.nsas(
                s["u_mass"], s["v_mass"], w_if, s["temperature"],
                s["water_vapor"], s.get("cloud_water", zeros3()),
                s.get("cloud_ice", zeros3()), s["density"], s["pressure"],
                p_if, jnp.asarray(geom.dz_interface), s["exner"],
                s.get("hpbl", jnp.zeros_like(s["sensible_heat"])),
                s["sensible_heat"],
                s["latent_heat"] / C.LH_VAPORIZATION,
                s["land_mask"], geom.dx, dt)
            cu = options.cu
            th0, qv0 = s["potential_temperature"], s["water_vapor"]
            if cu.tend_th_fraction > 0:
                s["potential_temperature"] = th0 + (th_c - th0) \
                    * cu.tend_th_fraction
            if cu.tend_qv_fraction > 0:
                s["water_vapor"] = qv0 + (qv_c - qv0) \
                    * cu.tend_qv_fraction
            if cu.tend_qc_fraction > 0 and "cloud_water" in s:
                s["cloud_water"] = s["cloud_water"] \
                    + (qc_c - s["cloud_water"]) * cu.tend_qc_fraction
            if cu.tend_qi_fraction > 0 and "cloud_ice" in s:
                s["cloud_ice"] = s["cloud_ice"] \
                    + (qi_c - s["cloud_ice"]) * cu.tend_qi_fraction
            s["precipitation"] = s["precipitation"] + rain_c
            s["convective_precipitation"] = (
                s["convective_precipitation"] + rain_c)

        if phys.convection == C.CU_BMJ:
            from ..physics import cu_bmj as bmj_mod
            s = dict(s)
            th_c, qv_c, rain_c, cldefi_c = bmj_mod.bmj(
                s["temperature"], s["potential_temperature"],
                s["water_vapor"], s["pressure"], s["exner"],
                s["density"], jnp.asarray(geom.dz_interface),
                s["land_mask"], s["cldefi"], dt,
                psfc=s["pressure_interface"][0])
            cu = options.cu
            if cu.tend_th_fraction > 0:
                th0 = s["potential_temperature"]
                s["potential_temperature"] = th0 + (th_c - th0) \
                    * cu.tend_th_fraction
            if cu.tend_qv_fraction > 0:
                qv0 = s["water_vapor"]
                s["water_vapor"] = qv0 + (qv_c - qv0) \
                    * cu.tend_qv_fraction
            s["cldefi"] = cldefi_c
            s["precipitation"] = s["precipitation"] + rain_c
            s["convective_precipitation"] = (
                s["convective_precipitation"] + rain_c)

        # --- extra physics hooks (custom schemes)
        if physics_extra:
            for _, fn in physics_extra:
                s = fn(s, geom, dt)

        # --- microphysics, optionally batched by the mp update_interval
        # (mp_driver.f90:698-713: accumulate substeps and run the scheme
        # with the accumulated dt once enough model time has passed)
        def do_microphysics(s, dt):
            if phys.microphysics == C.MP_SIMPLE:
                theta, qv, qc, qr, qs, rain, snow = mp_simple.mp_simple(
                    s["pressure"], s["potential_temperature"],
                    s["exner"], s["density"], s["water_vapor"],
                    s["cloud_water"], s["rain_mass"], s["snow_mass"],
                    s["precipitation"], s["snowfall"], dt,
                    jnp.asarray(geom.dz_interface), mesh=mesh)
                s = dict(s)
                s["potential_temperature"] = theta
                s["water_vapor"] = qv
                s["cloud_water"] = qc
                s["rain_mass"] = qr
                s["snow_mass"] = qs
                s["precipitation"] = rain
                s["snowfall"] = snow

            if phys.microphysics == C.MP_WSM3:
                from ..physics import mp_wsm3
                theta, qv, qci, qrs, rain, snow = mp_wsm3.wsm3(
                    s["potential_temperature"], s["water_vapor"],
                    s["cloud_water"], s["rain_mass"], s["w_real"], s["exner"],
                    s["pressure"], jnp.asarray(geom.dz_mass), s["density"], dt,
                    s["precipitation"], s["snowfall"])
                s = dict(s)
                s["potential_temperature"] = theta
                s["water_vapor"] = qv
                s["cloud_water"] = qci
                s["rain_mass"] = qrs
                s["precipitation"] = rain
                s["snowfall"] = snow

            if phys.microphysics in (C.MP_THOMPSON, C.MP_THOMPSON_AER):
                # mp=5 is the Thompson-Eidhammer scheme. The reference
                # driver invokes it WITHOUT aerosol fields
                # (mp_driver.f90:446-476), i.e. the constant-Nc fallback;
                # with mp_parameters use_aerosol_aware=.true. the full
                # is_aerosol_aware path runs with prognostic nc/nwfa/nifa.
                from ..physics import mp_thompson
                from ..physics.thompson_tables import ThompsonParams
                import dataclasses as _dc
                tp = ThompsonParams(**{f.name: getattr(options.mp, f.name)
                                       for f in _dc.fields(ThompsonParams)})
                aerosol = (phys.microphysics == C.MP_THOMPSON_AER
                           and "nwfa" in s)
                if (not aerosol and stack_ctx is not None
                        and thompson_stack_capable):
                    # stack-native path: restack only the fields some
                    # earlier scheme dirtied (zero restack in the
                    # mp+advect-only configurations), run the scheme on
                    # the stack, and hand the output stack to advection
                    qstack = _restack_dirty(stack_ctx, s)
                    out_stack, rain, snow, graupel = \
                        mp_thompson.mp_thompson_stack(
                            qstack, adv_names, s["exner"], s["pressure"],
                            jnp.asarray(geom.dz_mass), dt,
                            s["precipitation"], s["snowfall"],
                            s["graupel"], params=tp)
                    s = dict(s)
                    stack_ctx["stack"] = out_stack
                    for i, k in enumerate(adv_names):
                        v = out_stack[i]
                        s[k] = v
                        stack_ctx["views"][k] = v
                    s["precipitation"] = rain
                    s["snowfall"] = snow
                    s["graupel"] = graupel
                    if phys.microphysics == C.MP_THOMPSON_AER:
                        re_qc, re_qi, re_qs = mp_thompson.calc_effect_rad(
                            s["potential_temperature"] * s["exner"],
                            s["pressure"], s["water_vapor"],
                            s["cloud_water"], s["cloud_ice"],
                            s["ice_number"], s["snow_mass"], params=tp)
                        s["re_cloud"] = re_qc
                        s["re_ice"] = re_qi
                        s["re_snow"] = re_qs
                    return s
                if aerosol:
                    nwfa_in = s["nwfa"]
                    if "nwfa2d" in s:
                        # surface CCN replenishment applied to the lowest
                        # level each mp call (mp_thompson_aer.f90:1233)
                        nwfa_in = nwfa_in.at[0].add(s["nwfa2d"] * dt)
                    (theta, qv, qc, qi, qr, qs, qg, ni, nr, nc, nwfa,
                     nifa, rain, snow, graupel) = \
                        mp_thompson.mp_thompson_aer(
                        s["potential_temperature"], s["water_vapor"],
                        s["cloud_water"], s["cloud_ice"], s["rain_mass"],
                        s["snow_mass"], s["graupel_mass"], s["ice_number"],
                        s["rain_number"], s["cloud_number"], nwfa_in,
                        s["nifa"], s["exner"], s["pressure"],
                        jnp.asarray(geom.dz_mass), dt, s["precipitation"],
                        s["snowfall"], s["graupel"],
                        w=s.get("w_real"), params=tp)
                else:
                    (theta, qv, qc, qi, qr, qs, qg, ni, nr, rain, snow,
                     graupel) = mp_thompson.mp_thompson(
                        s["potential_temperature"], s["water_vapor"],
                        s["cloud_water"], s["cloud_ice"], s["rain_mass"],
                        s["snow_mass"], s["graupel_mass"], s["ice_number"],
                        s["rain_number"], s["exner"], s["pressure"],
                        jnp.asarray(geom.dz_mass), dt,
                        s["precipitation"], s["snowfall"], s["graupel"],
                        params=tp)
                s = dict(s)
                s["potential_temperature"] = theta
                s["water_vapor"] = qv
                s["cloud_water"] = qc
                s["cloud_ice"] = qi
                s["rain_mass"] = qr
                s["snow_mass"] = qs
                s["graupel_mass"] = qg
                s["ice_number"] = ni
                s["rain_number"] = nr
                s["precipitation"] = rain
                s["snowfall"] = snow
                s["graupel"] = graupel
                if aerosol:
                    s["cloud_number"] = nc
                    s["nwfa"] = nwfa
                    s["nifa"] = nifa
                if phys.microphysics == C.MP_THOMPSON_AER:
                    re_qc, re_qi, re_qs = mp_thompson.calc_effect_rad(
                        theta * s["exner"], s["pressure"], qv, qc, qi, ni,
                        qs, params=tp,
                        nc=(s["cloud_number"] if aerosol else None))
                    s["re_cloud"] = re_qc
                    s["re_ice"] = re_qi
                    s["re_snow"] = re_qs

            if phys.microphysics == C.MP_MORRISON:
                from ..physics import mp_morrison
                (theta, qv, qc, qi, qr, qs, qg, ni, ns_, nr, ng, rain, snow,
                 graupel) = mp_morrison.mp_morrison(
                    s["potential_temperature"], s["water_vapor"],
                    s["cloud_water"], s["cloud_ice"], s["rain_mass"],
                    s["snow_mass"], s["graupel_mass"], s["ice_number"],
                    s["snow_number"], s["rain_number"], s["graupel_number"],
                    s["exner"], s["pressure"], jnp.asarray(geom.dz_mass),
                    s["w_real"], dt, s["precipitation"], s["snowfall"],
                    s["graupel"])
                s = dict(s)
                s["potential_temperature"] = theta
                s["water_vapor"] = qv
                s["cloud_water"] = qc
                s["cloud_ice"] = qi
                s["rain_mass"] = qr
                s["snow_mass"] = qs
                s["graupel_mass"] = qg
                s["ice_number"] = ni
                s["snow_number"] = ns_
                s["rain_number"] = nr
                s["graupel_number"] = ng
                s["precipitation"] = rain
                s["snowfall"] = snow
                s["graupel"] = graupel

            if phys.microphysics == C.MP_WSM6:
                from ..physics import mp_wsm6
                (theta, qv, qc, qi, qr, qs, qg, rain, snow,
                 graupel) = mp_wsm6.wsm6(
                    s["potential_temperature"], s["water_vapor"],
                    s["cloud_water"], s["cloud_ice"], s["rain_mass"],
                    s["snow_mass"], s["graupel_mass"], s["exner"],
                    s["pressure"], jnp.asarray(geom.dz_mass), s["density"], dt,
                    s["precipitation"], s["snowfall"], s["graupel"])
                s = dict(s)
                s["potential_temperature"] = theta
                s["water_vapor"] = qv
                s["cloud_water"] = qc
                s["cloud_ice"] = qi
                s["rain_mass"] = qr
                s["snow_mass"] = qs
                s["graupel_mass"] = qg
                s["precipitation"] = rain
                s["snowfall"] = snow
                s["graupel"] = graupel
            return s

        mp_interval = float(options.mp.update_interval)
        if phys.microphysics != C.MP_NONE and mp_interval > 0:
            mp_elapsed = mp_elapsed + dt
            run_now = mp_elapsed >= mp_interval - 1e-6
            s = jax.lax.cond(
                run_now,
                lambda op: do_microphysics(op[0], op[1]),
                lambda op: op[0],
                (s, mp_elapsed))
            mp_elapsed = jnp.where(run_now, 0.0, mp_elapsed)
        else:
            s = do_microphysics(s, dt)

        # --- advection of all requested species in one fused pass
        if use_stack:
            if stack_ctx is not None:
                stacked = _restack_dirty(stack_ctx, s)
            else:
                stacked = jnp.stack([s[k] for k in adv_names])
            common = (s["u"], s["v"], s["w"], dt, geom.dx,
                      jnp.asarray(geom.jacobian_u), jnp.asarray(geom.jacobian_v),
                      jnp.asarray(geom.jacobian_w), jnp.asarray(geom.jacobian),
                      s.get("density"), jnp.asarray(geom.advection_dz))
            adv_floors = (limit_floor_1d if advect_clamp is not None
                          else None)
            # the near-end enforce_limits clamp on the stack folds into the
            # advection epilogue when nothing later in the substep (i.e.
            # forcing) touches the stack — this replaces a whole-stack
            # lax.cond, whose identity branch copied the stack every substep
            if phys.advection == C.ADV_UPWIND:
                out = advection.advect_upwind(
                    stacked, *common, options.run.advect_density,
                    floors=adv_floors, near_end=advect_clamp)
            else:
                from ..ops import mpdata
                out = mpdata.advect_mpdata(
                    stacked, *common, order=options.adv.mpdata_order,
                    use_fct=options.adv.flux_corrected_transport,
                    advect_density=options.run.advect_density,
                    floors=adv_floors, near_end=advect_clamp)
            # the advected species LEAVE the dict here and ride the loop
            # carry as this one stacked array: the next substep's physics
            # reads them back as zero-copy slices, so the per-substep
            # unstack (one full write+read of every advected field) is gone
            s = {k: v for k, v in s.items() if k not in adv_names}
            s["_qstack"] = out
            if "tend_qv_adv" in s and "water_vapor" in adv_names:
                # moisture-convergence tendency feeding the next
                # substep's convective trigger (tend%qv_adv)
                i_qv = adv_names.index("water_vapor")
                s["tend_qv_adv"] = (out[i_qv] - stacked[i_qv]) / dt
        return s, mp_elapsed, lsm_elapsed, rad_elapsed

    def _slice_natural(d):
        out = {}
        for k, v in d.items():
            s = natural_shapes[k]
            out[k] = v[..., :s[-2], :s[-1]]
        return out

    def _substep_needs(pressure_varies: bool, winds_vary: bool):
        """The PARTIAL_FIELDS the per-substep diagnostic refresh must
        recompute for THIS configuration: a diagnostic is refreshed only if
        (a) some configured scheme consumes it and (b) its inputs can change
        during the interval. theta changes every substep; pressure and the
        staggered winds change only when the forcing relaxes them
        (apply_forcing, domain_obj.f90:2400-2428) — everything derived
        purely from static fields is computed once before the loop. This is
        most of the substep's memory savings over the reference, which
        refreshes every diagnostic every dt (time_step.f90:49-198)."""
        any_surface = (phys.landsurface != C.LSM_NONE
                       or phys.watersurface != C.WATER_NONE)
        needs = set()
        if (phys.microphysics != C.MP_NONE
                or phys.boundarylayer != C.PBL_NONE
                or phys.convection != C.CU_NONE
                or phys.radiation == C.RA_RRTMG
                or any_surface or options.run.advect_density):
            needs.add("density")
        if (phys.radiation == C.RA_RRTMG or any_surface
                or phys.boundarylayer == C.PBL_YSU
                or phys.convection != C.CU_NONE):
            needs.add("temperature")
        if phys.radiation == C.RA_RRTMG:
            needs.add("temperature_interface")
        if pressure_varies:
            needs.add("exner")
            if (any_surface or phys.convection != C.CU_NONE
                    or phys.radiation == C.RA_RRTMG
                    or phys.boundarylayer != C.PBL_NONE):
                needs.add("pressure_interface")
                needs.add("surface_pressure")
        if winds_vary and (any_surface or phys.convection != C.CU_NONE
                           or phys.boundarylayer != C.PBL_NONE):
            needs.add("uv_mass")
        return frozenset(needs)

    def quantized_dt(u, v, w):
        dt = compute_dt(u, v, w, dz_levels, geom.dx,
                        options.run.cfl_reduction_factor,
                        options.run.cfl_strictness)
        dt = jnp.minimum(dt, C.MAX_DT)
        # quantize dt to 1/64 s (exact in f32) so the substep count is
        # identical run-to-run and sharding-to-sharding: different mesh
        # layouts fuse the CFL arithmetic differently, and an ulp-level
        # dt difference would flip while_loop trip counts (the
        # reference's co_min is exact because max/min reductions are
        # order-independent; the elementwise CFL sums feeding it are
        # not). Mirrors the determinism of time_step.f90:413 co_min.
        return jnp.maximum(jnp.floor(dt * 64.0) / 64.0, 1.0 / 64.0)

    geom_np = geom
    gfields = geom_array_fields(geom)

    def _bind_geometry(gvals):
        """Swap the closed-over geometry for the traced argument arrays
        (sliced back to natural shapes under the padded sharded frame).
        Every helper below closes over ``geom`` by name, so rebinding it
        at trace time routes all metric reads through the arguments."""
        import dataclasses
        nonlocal geom
        g = {}
        for k in gfields:
            nat = getattr(geom_np, k).shape
            v = gvals[k]
            if v.shape != nat:
                v = v[..., :nat[-2], :nat[-1]]
            g[k] = v
        geom = dataclasses.replace(geom_np, **g)

    def step(state, dqdt, t0, end_time, aux, gvals):
        _bind_geometry(gvals)
        if natural_shapes is not None:
            state_padded = state
            state = _slice_natural(state)
            dqdt = _slice_natural(dqdt)
        if "rain_frac" in aux:
            precip0 = state["precipitation"]

        # loop-invariant analysis (trace-time): pressure and the staggered
        # winds change inside the interval ONLY via forcing relaxation, so
        # when the installed dqdt lacks them, everything derived from them —
        # the CFL dt and the pressure-derived diagnostics — hoists out of
        # the substep loop (exact: the hoisted value equals what every
        # substep would recompute)
        pressure_varies = with_forcing and "pressure" in dqdt
        winds_vary = with_forcing and any(k in dqdt for k in ("u", "v", "w"))
        needs = _substep_needs(pressure_varies, winds_vary)
        full_each = (phys.boundarylayer == C.PBL_YSU)
        w_real_cfg = (phys.microphysics == C.MP_WSM3
                      or phys.convection != C.CU_NONE)

        # establish every derived field once before the loop; the body then
        # refreshes only the `needs` subset
        state = diagnostic_update(state, geom, full=False,
                                  with_w_real=w_real_cfg)
        if not winds_vary:
            dt_static = quantized_dt(state["u"], state["v"], state["w"])

        tend_stack = None
        if use_stack:
            state = dict(state)
            state["_qstack"] = jnp.stack([state.pop(k) for k in adv_names])
            if with_forcing and any(k in dqdt for k in adv_names):
                zero = jnp.zeros_like(state["_qstack"][0])
                tend_stack = jnp.stack([dqdt.get(k, zero)
                                        for k in adv_names])

        def unstack(state):
            state = dict(state)
            qstack = state.pop("_qstack")
            for i, k in enumerate(adv_names):
                state[k] = qstack[i]
            return state

        def unstack_ctx(state):
            """Unstack + remember the carry stack and the slice-view
            identities: the restack before advection then touches only
            the rows whose field some physics scheme actually replaced
            (trace-time identity check — which schemes write which
            fields is static), instead of a full jnp.stack (a chain of
            S full-stack dynamic-update-slices every substep)."""
            state = dict(state)
            qstack = state.pop("_qstack")
            views = {}
            for i, k in enumerate(adv_names):
                v = qstack[i]
                state[k] = v
                views[k] = v
            return state, {"stack": qstack, "views": views}

        # limited fields NOT riding the stack (clamped through a small
        # lax.cond; usually empty — every limited field is advected in
        # every stock configuration, so the old whole-state cond tupled
        # 25 fields for nothing)
        limited_rest = tuple(k for k in LIMITED_FIELDS
                             if k in state and k not in adv_names)
        clamp_in_advect = (use_stack and tend_stack is None
                           and phys.advection in (C.ADV_UPWIND,
                                                  C.ADV_MPDATA))

        def cond(carry):
            t = carry[1]
            return t < end_time - 1e-3

        def body(carry):
            state, t, n, mp_el, lsm_el, rad_el = carry
            stack_ctx = None
            if use_stack:
                state, stack_ctx = unstack_ctx(state)
            if winds_vary:
                dt = quantized_dt(state["u"], state["v"], state["w"])
            else:
                dt = dt_static
            dt = jnp.minimum(dt, end_time - t)
            # clamp over-shot negatives in the last couple of substeps
            # (enforce_limits near the interval end, time_step.f90:537-539)
            near_end = (end_time - t) < dt * 2

            # YSU consumes the 10m-wind/ustar diagnostics every substep
            state = diagnostic_update(state, geom,
                                      full=full_each,
                                      with_w_real=(w_real_cfg and winds_vary),
                                      needs=None if full_each else needs)
            state, mp_el, lsm_el, rad_el = physics_step(
                state, dt, t, aux, mp_el, lsm_el, rad_el,
                advect_clamp=(near_end.astype(jnp.float32)
                              if clamp_in_advect else None),
                stack_ctx=stack_ctx)
            if with_forcing:
                state = apply_forcing(state, dqdt, dt, bmask)
                if tend_stack is not None:
                    # boundary-ring relaxation of the advected species on
                    # the stacked carry (apply_forcing,
                    # domain_obj.f90:2400-2428), with the near-end clamp
                    # fused in (it must follow forcing)
                    state = dict(state)
                    floor_b = jnp.where(near_end,
                                        jnp.asarray(limit_floor), -jnp.inf)
                    state["_qstack"] = jnp.maximum(
                        state["_qstack"]
                        + tend_stack * (dt * bmask)[None, None],
                        floor_b)
            if use_stack and tend_stack is None and not clamp_in_advect:
                # MPDATA path: fused masked clamp on the stack
                state = dict(state)
                state["_qstack"] = jnp.where(
                    near_end,
                    jnp.maximum(state["_qstack"], jnp.asarray(limit_floor)),
                    state["_qstack"])
            if limited_rest:
                sub = {k: state[k] for k in limited_rest}
                sub = jax.lax.cond(
                    near_end,
                    lambda d: {k: jnp.maximum(v, 0.0)
                               for k, v in d.items()},
                    lambda d: d, sub)
                state = dict(state)
                state.update(sub)
            return state, t + dt, n + 1, mp_el, lsm_el, rad_el

        # counters start at their intervals so the first substep runs the
        # throttled physics immediately (last_model_time init in the
        # reference drivers)
        state, t, n, _, _, _ = jax.lax.while_loop(
            cond, body,
            (state, t0, jnp.int32(0),
             jnp.float32(options.mp.update_interval),
             jnp.float32(options.lsm.update_interval),
             jnp.float32(options.rad.update_interval_rrtmg)))
        if use_stack:
            state = unstack(state)
        # output-only diagnostics (IVT/IWV, 10m winds, w_real) once per
        # interval rather than per substep
        state = diagnostic_update(state, geom, full=True)
        if "rain_frac" in aux:
            # monthly precipitation bias correction: scale this interval's
            # increment on interior cells (apply_rain_fraction,
            # mp_driver.f90:350-397) — applied in-jit so the bias-corrected
            # loop never syncs with the host
            rf = aux["rain_frac"]
            p = state["precipitation"]
            rf = rf[..., :p.shape[-2], :p.shape[-1]].astype(p.dtype)
            state = dict(state)
            state["precipitation"] = precip0 + (p - precip0) * rf
        if natural_shapes is not None:
            state = {k: state_padded[k].at[..., :v.shape[-2], :v.shape[-1]]
                     .set(v) for k, v in state.items()}
        return state, t, n

    # The state argument is DONATED: without donation the program entry
    # copies every carried buffer (~2.5 GB at 500x500x20). Callers of the
    # raw step function pass fresh buffers.
    return jax.jit(step, donate_argnums=(0,))

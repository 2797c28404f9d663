"""The main model driver: init -> forcing loop -> physics -> output.

Replaces program icar (/root/reference/src/main/driver.f90) and
initialization (init.f90): reads terrain + forcing files, builds the model,
and runs the outer loop — ingest a forcing step, run the wind solver on the
target fields, install relaxation tendencies, integrate physics to the next
forcing/output event, write output/restart.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..config import Options
from ..forcing.boundary import ForcingData, Regridder, compute_tendencies
from ..io.netcdf import NCFile
from ..io.output import OutputWriter, read_restart, write_restart
from ..models.icar import ICARModel
from ..ops import wind as wind_ops
from ..utils.calendar import TimeDelta


def load_domain(options: Options):
    """Read hi-res terrain/lat/lon from the init-conditions file
    (read_domain_shape + read_core_variables, domain_obj.f90:2144, 1324)."""
    path = options.forcing.init_conditions_file
    names = options.forcing.var_names
    with NCFile(path) as f:
        terrain = f.read(names.get("hgt_hi", "hgt_hi"))
        lat = f.read(names.get("lat_hi", "lat_hi"))
        lon = f.read(names.get("lon_hi", "lon_hi"))
    if terrain.ndim == 3:
        terrain, lat, lon = terrain[0], lat[0], lon[0]
    return (np.asarray(terrain, np.float64), np.asarray(lat, np.float64),
            np.asarray(lon, np.float64))


class ICARDriver:
    """Owns the model + forcing machinery and runs the outer loop."""

    def __init__(self, options: Options, mesh=None):
        from ..utils.diagnostics_debug import Timers
        self.options = options
        self.timers = Timers()
        self.timers["init"].start()
        terrain, lat, lon = load_domain(options)
        options.domain.ny, options.domain.nx = terrain.shape
        self.model = ICARModel(options, terrain, lat, lon)

        self.forcing = ForcingData(options)
        raw0 = self.forcing.read_step(0)
        self.regridder = Regridder.build(
            self.model.geom, self.forcing.lat, self.forcing.lon,
            raw0.get("z"), options, f_stag=self.forcing.stagger_coords)

        # all initial-condition math on the host CPU backend, as numpy-
        # sized eager work (core/state.host_setup); ICARModel.advance()
        # transfers the finished state to the device in bulk
        from .state import host_setup
        with host_setup():
            self._install_initial_conditions(raw0)
            self._install_external_conditions()
            self._init_lake()
            self._init_noahmp()
        if mesh is not None:
            self.model.attach_mesh(mesh)

        if options.output.engine == "classic-async":
            from ..io.output import AsyncStepWriter
            self.writer = AsyncStepWriter(options.output.output_file,
                                          self._output_names(), options)
        elif options.output.engine == "sharded":
            from ..io.output import ShardedOutputWriter
            self.writer = ShardedOutputWriter(options.output.output_file,
                                              self._output_names(), options)
        else:
            out_name = options.output.output_file + "run.nc"
            self.writer = OutputWriter(out_name, self._output_names(), options)
        self.restart_base = options.output.restart_file
        # online precipitation bias correction (setup_bias_correction,
        # init.f90:300-321): monthly rain-fraction climatology, clipped to
        # [0.2, 5] then inverted
        self.use_rain_fraction = False
        if options.bias.use_bias_correction and options.bias.filename:
            with NCFile(options.bias.filename) as f:
                rf = np.asarray(f.read(options.bias.rain_fraction_var),
                                np.float32)
            if rf.ndim != 3:
                raise ValueError("rain_fraction must be (12, ny, nx)")
            self.model.set_rain_fraction(1.0 / np.clip(rf, 0.2, 5.0))
            self.use_rain_fraction = True
        self.timers["init"].stop()

    def _output_names(self):
        names = list(self.options.output.names)
        if not names:
            names = ["u", "v", "w", "pressure", "potential_temperature",
                     "water_vapor", "cloud_water", "precipitation"]
        # reference output-metadata short names -> registry names
        # (default_output_metadata.f90 name= entries)
        alias = {"ta2m": "temperature_2m", "hus2m": "humidity_2m",
                 "qv": "water_vapor", "qc": "cloud_water",
                 "qi": "cloud_ice", "qr": "rain_mass", "qs": "snow_mass",
                 "qg": "graupel_mass", "ts": "skin_temperature",
                 "u10m": "u_10m", "v10m": "v_10m",
                 "psfc": "surface_pressure", "hfss": "sensible_heat",
                 "hfls": "latent_heat", "rsds": "shortwave",
                 "rlds": "longwave", "pressure_i": "pressure_interface",
                 "temperature_i": "temperature_interface",
                 "cu_precipitation": "convective_precipitation",
                 "precip": "precipitation"}
        from .. import registry
        resolved = [alias.get(n, n) for n in names]
        for n in resolved:
            if n not in registry.spec_names():
                print(f"warning: requested output variable '{n}' is not "
                      "known; it will be skipped", file=sys.stderr)
        return resolved

    def _install_initial_conditions(self, raw0):
        """Full-3D initial state from the first forcing step
        (get_initial_conditions, domain_obj.f90:63-98)."""
        m = self.model
        target = self.regridder.to_model_grid(raw0, m.geom)
        s = dict(m.state)
        for name in ("potential_temperature", "water_vapor", "pressure",
                     "cloud_water", "cloud_ice",
                     "sst", "shortwave", "longwave",
                     "sensible_heat", "latent_heat", "hpbl",
                     "nwfa", "nifa"):
            if name in target and name in s:
                s[name] = target[name]
        if "nwfa" in target and "nwfa2d" in s:
            # the CCN replenishment flux derives from the ACTUAL initial
            # surface nwfa (thompson_aer_init runs after ingest in the
            # reference; mp_thompson_aer.f90:536-549)
            from ..physics.mp_thompson import aer_surface_flux
            s["nwfa2d"] = jnp.asarray(
                aer_surface_flux(np.asarray(target["nwfa"])[0], m.geom.dx),
                jnp.float32)
        from .diagnostics import diagnostic_update
        m.state = diagnostic_update(s, m.geom)
        u, v, w = m.compute_winds(target["u"], target["v"], rotate=True)
        s = dict(m.state)
        s["u"], s["v"], s["w"] = u, v, w
        m.state = diagnostic_update(s, m.geom)
        for name in ("skin_temperature", "sst", "soil_temperature",
                     "soil_deep_temperature"):
            if name in s and float(jnp.max(jnp.abs(s[name]))) == 0.0:
                t0 = s["temperature"][0]
                m.state[name] = jnp.broadcast_to(t0, s[name].shape).astype(
                    s[name].dtype)

    def _install_external_conditions(self):
        """Externally-supplied surface/snow state (SWE, snow height, soil/skin
        temperature) overrides the defaults at init (init_external,
        external_bnd.f90)."""
        from ..forcing.boundary import load_external_conditions
        ext = load_external_conditions(self.options, self.model.geom)
        if not ext:
            return
        s = dict(self.model.state)
        applied = []
        for name, arr in ext.items():
            if name in s:
                if arr.ndim == 2 and s[name].ndim == 3:
                    arr = jnp.broadcast_to(arr, s[name].shape)
                s[name] = jnp.asarray(arr, s[name].dtype)
                applied.append(name)
        self.model.state = s
        if applied:
            print("external initial conditions applied:", ", ".join(applied))

    def _init_lake(self):
        """CLM lake model state initialization (lakeini,
        water_lake.f90:4904-5431 via lsm_init, lsm_driver.f90:884-989).
        Skipped on restart — the checkpoint carries the lake state."""
        from .. import constants as C
        o = self.options
        if o.physics.watersurface != C.WATER_LAKE or o.run.restart:
            return
        from ..physics.water_lake import lake_init
        m = self.model
        fields = {k: np.asarray(v) for k, v in m.state.items()}
        _, _, water_cat, lake_cat = o.lsm.resolved_categories()
        lake_init(fields, np.asarray(m.geom.terrain),
                  np.asarray(m.geom.lat), lake_category=lake_cat,
                  water_category=water_cat,
                  lakedepth_default=o.lsm.lakedepth_default,
                  lake_min_elev=o.lsm.lake_min_elev)
        s = dict(m.state)
        for k, v in fields.items():
            if k in s:
                s[k] = jnp.asarray(v, s[k].dtype)
        # lakes count as water in the land mask (lsm_driver.f90:710,880)
        if "land_mask" in s:
            s["land_mask"] = jnp.where(jnp.asarray(fields["lakemask"]) > 0.5,
                                       2.0, s["land_mask"])
        m.state = s
        n_lake = int(fields["lakemask"].sum())
        print(f"lake model initialized: {n_lake} lake cells")

    def _init_noahmp(self):
        """NoahMP prognostic-state initialization (noahmp_init +
        snow_init, lsm_noahmpdrv.f90:1443-2149). Skipped on restart."""
        from .. import constants as C
        o = self.options
        if o.physics.landsurface != C.LSM_NOAHMP or o.run.restart:
            return
        from ..physics import noahmp as nmp
        from ..physics.noahmp_params import load_mp_tables
        from ..physics.noah_params import load_tables
        m = self.model
        s = dict(m.state)
        init = nmp.noahmp_init_state(
            np.asarray(s["skin_temperature"]),
            np.asarray(s["swe"], np.float32),
            np.asarray(s["snow_height"]),
            np.asarray(s["soil_temperature"]),
            np.asarray(s["soil_water_content"]),
            np.asarray(s["soil_type"]), np.asarray(s["veg_type"]),
            load_mp_tables(lu_categories=o.lsm.LU_Categories),
            load_tables())
        mapping = {
            "snow_albedo_prev": "albold", "snow_water_eq_prev": "sneqvo",
            "soil_liquid_water": "sh2o", "soil_water_content": "smc",
            "canopy_temperature": "tah",
            "canopy_vapor_pressure": "eah", "canopy_fwet": "fwet",
            "canopy_water_liquid": "canliq", "canopy_water_ice": "canice",
            "veg_leaf_temperature": "tv", "ground_surf_temperature": "tg",
            "snow_layer_depth": "zsnso", "snow_height": "snowh",
            "snow_layer_ice": "snice",
            "snow_layer_liquid_water": "snliq",
            "water_table_depth": "zwt", "water_aquifer": "wa",
            "storage_gw": "wt", "lai": "lai", "sai": "sai",
            "coeff_momentum_drag": "cm", "coeff_heat_exchange": "ch",
            "snow_age_factor": "tauss", "swe": "sneqv",
        }
        for field, key in mapping.items():
            if field in s:
                s[field] = jnp.asarray(init[key], s[field].dtype)
        s["snow_nlayers"] = jnp.asarray(init["isnow"], jnp.float32)
        nsn = s["snow_temperature"].shape[0]
        s["snow_temperature"] = jnp.asarray(init["stc"][:nsn])
        s["soil_temperature"] = jnp.asarray(init["stc"][nsn:])
        m.state = s
        print("NoahMP state initialized")

    def _rain_frac_month(self, t):
        """Month index of the bias-correction climatology at model time t
        (apply_rain_fraction month selection, mp_driver.f90:357-359)."""
        date = self.options.start_time() + TimeDelta(t)
        n = self.model._rain_frac_months.shape[0]
        return min(int(n * date.year_fraction()), n - 1)

    def _forcing_tendencies(self, raw):
        """Target fields -> wind solve -> relaxation tendencies
        (update_winds update path + update_delta_fields,
        driver.f90:128-138)."""
        m = self.model
        target = self.regridder.to_model_grid(raw, m.geom)
        u, v, w = m.compute_winds(target["u"], target["v"], rotate=True)
        target["u"], target["v"], target["w"] = u, v, w
        current = {k: m.state[k] for k in target if k in m.state}
        if m.mesh is not None:
            current = {k: jnp.asarray(m.field(k)) for k in target
                       if k in m.state}
        dqdt = compute_tendencies(current, target,
                                  self.options.forcing.input_interval)
        m.set_forcing_tendencies({k: np.asarray(v) for k, v in dqdt.items()})

    def run(self):
        """The outer loop (driver.f90:119-199)."""
        o = self.options
        total_seconds = (o.end_time() - o.start_time()).seconds()
        input_dt = o.forcing.input_interval
        output_dt = o.output.output_interval
        restart_every = max(1, o.output.restart_count)

        t = 0.0
        n_outputs = 0
        if o.run.restart:
            # resume from a checkpoint (driver.f90:81-87): an explicit
            # &restart_info restart_file, the newest checkpoint at/before
            # restart_date, or simply the most recent one
            # (init_restart_options, options_obj.f90:476-540)
            import glob
            if o.run.restart_in_file:
                pick = o.run.restart_in_file
            else:
                cands = sorted(glob.glob(self.restart_base + "*.nc")
                               + glob.glob(self.restart_base + "*.npz"))
                if not cands:
                    raise FileNotFoundError(
                        f"restart requested but no checkpoint matches "
                        f"{self.restart_base}*.nc|npz")
                pick = cands[-1]
                if o.run.restart_date:
                    from ..utils.calendar import Time
                    want = (Time.from_string(o.run.restart_date,
                                             o.run.calendar)
                            - o.start_time()).seconds()

                    def t_of(p):
                        import os as _os
                        stem = _os.path.splitext(p)[0]
                        try:
                            return int(stem[-8:])
                        except ValueError:
                            return -1
                    eligible = [p for p in cands if 0 <= t_of(p) <= want + 1]
                    if not eligible:
                        raise FileNotFoundError(
                            f"no checkpoint at or before restart_date "
                            f"{o.run.restart_date} (t={want:.0f}s) in "
                            f"{self.restart_base}*.nc|npz")
                    pick = max(eligible, key=t_of)
            t = read_restart(pick, self.model)
            n_outputs = int(round(t / output_dt))
            print(f"restarted from {pick} at t={t:.0f}s")
        else:
            self.writer.write_step(self.model, t)
        next_output = (n_outputs + 1) * output_dt
        n_steps_total = self.forcing.n_steps()
        step_idx = int(t // input_dt) + 1

        debug = self.options.run.debug
        self._next_progress_pct = 5.0
        while t < total_seconds - 1e-3:
            # ingest the next forcing step (cycling the last one if short)
            self.timers["input"].start()
            idx = min(step_idx, n_steps_total - 1)
            raw = self.forcing.read_step(idx)
            self._forcing_tendencies(raw)
            self.timers["input"].stop()
            step_idx += 1
            input_end = min(t + input_dt, total_seconds)

            while t < input_end - 1e-3:
                target_t = min(next_output, input_end)
                month = (self._rain_frac_month(t)
                         if self.use_rain_fraction else None)
                self.timers["physics"].start()
                self.model.advance(target_t - t, rain_frac_month=month)
                self.timers["physics"].stop()
                t = target_t
                if debug:
                    from ..utils.diagnostics_debug import domain_check
                    self.model.state, problems = domain_check(
                        self.model.state, msg=f"t={t:.0f}s", fix=True)
                pct = 100.0 * t / total_seconds
                if pct >= self._next_progress_pct:
                    # 5% progress ticker (print_progress,
                    # time_step.f90:342-364)
                    print(f"  {pct:5.1f}% complete (t={t:.0f}s)",
                          flush=True)
                    self._next_progress_pct = (pct // 5.0 + 1) * 5.0
                if abs(t - next_output) < 1e-3:
                    self.timers["output"].start()
                    self.writer.write_step(self.model, t)
                    n_outputs += 1
                    next_output += output_dt
                    if n_outputs % restart_every == 0:
                        write_restart(
                            f"{self.restart_base}{int(t):08d}.nc",
                            self.model, t)
                    self.timers["output"].stop()
        if hasattr(self.writer, "wait"):
            errors = self.writer.wait()
            if errors:
                print(f"WARNING: {errors} async output write(s) failed")
        print(self.timers.report())
        return self.model


def main(argv=None):
    """CLI entry: ``python -m icar_tpu options.nml [--profile DIR]``
    (mirrors ./icar icar_options.nml). ``--profile DIR`` wraps the run
    in a jax profiler trace (view with TensorBoard / xprof) — the
    counterpart of the reference's MODE=profile build
    (src/makefile:14-16). The run uses JAX's default backend; there is no
    fallback to another."""
    import contextlib
    import sys

    args = list(argv if argv is not None else sys.argv[1:])
    profile_dir = None
    if "--profile" in args:
        i = args.index("--profile")
        profile_dir = args[i + 1] if i + 1 < len(args) else ""
        del args[i:i + 2]
    if not args or profile_dir == "":
        print("usage: python -m icar_tpu <options_namelist> [--profile DIR]")
        return 1
    import jax
    devices = jax.devices()
    print(f"running on {devices[0].platform} ({devices[0].device_kind}), "
          f"{len(devices)} device(s)", flush=True)
    options = Options.from_namelist(args[0])
    options.validate()
    driver = ICARDriver(options)
    ctx = contextlib.nullcontext()
    if profile_dir:
        ctx = jax.profiler.trace(profile_dir, create_perfetto_trace=True)
        print(f"profiling to {profile_dir}")
    with ctx:
        driver.run()
    print(f"icar_tpu run complete: {driver.writer.path}")
    return 0

"""Options / namelist parsing tests (mirrors test_caf_options.f90 coverage)."""

import pytest

from icar_tpu import constants as C
from icar_tpu.config import Options
from icar_tpu.registry import collect_requests
from icar_tpu.utils.namelist import read_namelist

NML = """
&model_version
    version = "2.1",
    comment = "test comment"     ! trailing comment
/
&physics
    pbl = 0, lsm = 0, water=0, mp = 2,
    rad = 0, conv= 0, adv = 1, wind= 2
/
&parameters
    forcing_start_date = '2001-04-01 03:00:00',
    start_date = "2001-04-02 00:00:00",
    end_date = "2001-04-10 00:00:00",
    calendar = "standard",
    inputinterval = 3600,
    dx = 4000.0,
    nz = 15,
    smooth_wind_distance = 72000,
/
&z_info
    dz_levels = 50., 75., 125., 200., 300., 400., 7*500., 2*500.
/
&output_list
    names = "u","v","precipitation"
    outputinterval = 3600
    output_file = "output/icar_out_"
/
"""


def test_namelist_parser(tmp_path):
    p = tmp_path / "opts.nml"
    p.write_text(NML)
    nml = read_namelist(str(p))
    assert nml["model_version"]["comment"] == "test comment"
    assert nml["physics"]["mp"] == 2
    assert nml["z_info"]["dz_levels"][:3] == [50.0, 75.0, 125.0]
    assert len(nml["z_info"]["dz_levels"]) == 15
    assert nml["output_list"]["names"] == ["u", "v", "precipitation"]


def test_options_from_namelist(tmp_path):
    p = tmp_path / "opts.nml"
    p.write_text(NML)
    o = Options.from_namelist(str(p))
    assert o.physics.microphysics == C.MP_SIMPLE
    assert o.physics.windtype == C.WIND_CONSERVE_MASS
    assert o.domain.nz == 15
    assert o.domain.dx == 4000.0
    assert o.domain.dz_levels[3] == 200.0
    assert o.run.calendar == "gregorian"
    assert (o.end_time() - o.start_time()).days() == 8.0
    o.domain.nx = o.domain.ny = 50
    o.validate()


def _skip_without_reference(test):
    """Skip ``test`` when the reference checkout it reads is absent."""
    import functools

    @functools.wraps(test)
    def run():
        try:
            return test()
        except FileNotFoundError as e:
            import pytest
            pytest.skip(f"reference file not available: {e.filename}")
    return run


@_skip_without_reference
def test_reference_namelist_parses():
    """The actual reference short options file must parse."""
    o = Options.from_namelist("/root/reference/run/short_icar_options.nml")
    assert o.physics.microphysics == C.MP_THOMPSON
    assert o.physics.windtype == C.WIND_LINEAR
    assert o.domain.nz == 15
    assert len(o.domain.dz_levels) == 40
    assert o.forcing.var_names["p"] == "P"
    assert o.forcing.var_names["u"] == "U"
    assert o.output.restart_count == 24


def test_var_requests():
    o = Options()
    o.physics.microphysics = C.MP_SIMPLE
    req = collect_requests(o)
    # mp_simple advects exactly these 5 species (mp_simple.f90:116-118)
    assert req.advect == ["potential_temperature", "water_vapor", "cloud_water",
                          "rain_mass", "snow_mass"]
    assert "precipitation" in req.alloc
    assert "snowfall" in req.restart


def test_halo_width():
    o = Options()
    o.physics.advection = C.ADV_UPWIND
    assert o.halo_width() == 1
    o.physics.advection = C.ADV_MPDATA
    assert o.halo_width() == 2


def test_reference_complete_namelist_parses():
    """The reference's complete_icar_options.nml (every namelist group
    with every documented key) must parse, with representative values
    from each group landing in the right Options fields
    (options_obj.f90:45-86 group list)."""
    import os

    import pytest

    path = "/root/reference/run/complete_icar_options.nml"
    if not os.path.exists(path):
        pytest.skip("reference namelist not available")
    o = Options.from_namelist(path)
    # &parameters
    assert o.domain.dx == 4000.0
    assert o.run.start_date.startswith("2001-04-02")
    assert o.forcing.smooth_wind_distance == 72000
    assert o.forcing.time_varying_z is True
    assert o.forcing.agl_cap == 300
    # &z_info
    # nz=15 in &parameters; dz_levels lists 40 entries and the model
    # uses the first nz of them (models/icar.py dz_levels[:nz])
    assert o.domain.nz == 15
    assert len(o.domain.dz_levels) == 40
    assert o.domain.dz_levels[0] == 50.0
    # &physics
    assert o.physics.microphysics == 1
    assert o.physics.windtype == 1
    # &lt_parameters
    assert o.lt.n_spd_values == 10
    assert o.lt.nsqmax == pytest.approx(-7.42)
    # &mp_parameters
    assert o.mp.Nt_c == pytest.approx(100e6)
    assert o.mp.mu_r == 0.0
    # &cu_parameters
    assert o.cu.tend_qv_fraction == 1.0
    # &output_list
    assert "ta2m" in o.output.names
    # &files_list
    assert o.forcing.init_conditions_file


def test_version_check_rejects_old_namelist_version(tmp_path):
    """version_check stops on mismatched namelist versions and reports the
    change history (options_obj.f90:280-310, model_tracking.f90:73-107)."""
    import pytest
    from icar_tpu.utils.model_tracking import changes_since, check_version

    check_version("2.1")        # reference release: accepted
    check_version("2.1-tpu")    # this build: accepted
    with pytest.raises(ValueError, match="Namelist version: 0.9.3"):
        check_version("0.9.3")
    hist = changes_since("0.9.3")
    assert "0.9.4" in hist and "bias correction" in hist
    assert "0.9.2" not in hist  # only changes SINCE the given version
    assert "unable to find" in changes_since("bogus")


def test_per_physics_options_subfiles(tmp_path):
    """Per-physics namelist groups can live in separate files pointed to by
    <prefix>_options_filename in &parameters (options_obj.f90:64-71), with
    paths resolved relative to the main options file."""
    (tmp_path / "mp.nml").write_text("""
&mp_parameters
  Nt_c = 50.e6
  update_interval = 600
/
""")
    (tmp_path / "rad.nml").write_text("""
&rad_parameters
  update_interval_rrtmg = 1200
/
""")
    main = tmp_path / "options.nml"
    main.write_text("""
&physics
  mp = 1, rad = 2
/
&parameters
  mp_options_filename = "mp.nml"
  rad_options_filename = "rad.nml"
/
&mp_parameters
  Nt_c = 999.e6   ! ignored: the group is redirected to mp.nml
/
""")
    o = Options.from_namelist(str(main))
    assert o.mp.Nt_c == pytest.approx(50e6)
    assert o.mp.update_interval == 600
    assert o.rad.update_interval_rrtmg == 1200

    # pointing the filename at the main options file keeps in-file groups
    main2 = tmp_path / "options2.nml"
    main2.write_text(f"""
&parameters
  mp_options_filename = "{main2}"
/
&mp_parameters
  Nt_c = 77.e6
/
""")
    o2 = Options.from_namelist(str(main2))
    assert o2.mp.Nt_c == pytest.approx(77e6)

"""User tooling: quick-look plotting and restart chaining
(reference: helpers/bin/plot_icar.py, helpers/setup_next_run.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

from icar_tpu.io.netcdf import NCFile, write_vars  # noqa: E402


def _run(script, *args):
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", script), *args],
        capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


def test_plot_icar_quicklook(tmp_path):
    from icar_tpu.io.netcdf import NCFile

    ny, nx = 12, 16
    path = str(tmp_path / "out.nc")
    lat = np.linspace(40, 41, ny)[:, None] + np.zeros((ny, nx))
    lon = np.linspace(-105, -104, nx)[None, :] + np.zeros((ny, nx))
    with NCFile(path, "w") as f:
        f.create_dim("time", 2, unlimited=True)
        f.create_dim("y", ny)
        f.create_dim("x", nx)
        f.create_dim("z", 3)
        f.create_var("lat", ("y", "x"), lat.astype(np.float32))
        f.create_var("lon", ("y", "x"), lon.astype(np.float32))
        f.create_var("precipitation", ("time", "y", "x"),
                     np.random.rand(2, ny, nx).astype(np.float32))
        f.create_var("cloud_water", ("time", "z", "y", "x"),
                     np.random.rand(2, 3, ny, nx).astype(np.float32) * 1e-4)

    png = str(tmp_path / "map.png")
    r = _run("plot_icar.py", path, "-v", "precipitation", "-v", "cloud_water",
             "-v", "not_a_var", "-o", png)
    assert r.returncode == 0, r.stderr
    assert "not_a_var" in r.stderr          # unknown var warned, not fatal
    assert os.path.getsize(png) > 1000


def test_setup_next_run_chains_restart(tmp_path):
    nml = tmp_path / "options.nml"
    nml.write_text(f"""&model_version
    version = "2.1",
/
&physics
    mp = 2,
/
&parameters
    start_date = "2020-12-01 00:00:00",
    end_date = "2020-12-01 03:00:00",
    nz = 5,
    dz_levels = 200.0, 200.0, 200.0, 200.0, 200.0,
/
&output_list
    restart_file = "{tmp_path}/rst_",
    names = "precipitation",
/
""")
    # no checkpoints yet -> refuses
    r = _run("setup_next_run.py", str(nml))
    assert r.returncode == 1

    for t in (3600, 7200, 10800):
        np.savez(tmp_path / f"rst_{t:08d}.npz", t=np.float64(t))
    # -s 1 deletes the newest checkpoint and resumes from the previous one
    r = _run("setup_next_run.py", str(nml), "-s", "1")
    assert r.returncode == 0, r.stderr
    assert "rst_00007200.npz" in r.stdout
    assert not (tmp_path / "rst_00010800.npz").exists()

    text = nml.read_text()
    assert "restart = .True.," in text
    from icar_tpu.config import Options
    o = Options.from_namelist(str(nml))
    assert o.run.restart is True


def test_aggregate_output_merges_steps(tmp_path):
    """classic-async per-step files -> one time-series file
    (analog of helpers/aggregate_parallel_files.py)."""
    from icar_tpu.io.async_writer import AsyncNCWriter
    from icar_tpu.io.netcdf import NCFile

    w = AsyncNCWriter()
    for t in (0.0, 600.0, 1200.0):
        w.write(str(tmp_path / f"out_{int(t):08d}.nc"),
                {"precipitation": (("y", "x"),
                                   np.full((4, 5), t, np.float32))},
                {"model_time": str(t), "dx": "1000.0"})
    assert w.wait() == 0
    w.close()

    out = str(tmp_path / "combined.nc")
    r = _run("aggregate_output.py", str(tmp_path / "out_*.nc"), "-o", out)
    assert r.returncode == 0, r.stderr
    with NCFile(out) as f:
        pr = f.read("precipitation")
        assert pr.shape == (3, 4, 5)
        np.testing.assert_allclose(pr[:, 0, 0], [0.0, 600.0, 1200.0])
        np.testing.assert_allclose(f.read("model_time"), [0, 600, 1200])


def _write_synthetic_wrfout(path, classic=False, nt=2, nz=5, ny=8, nx=10):
    """A minimal wrfout-shaped file (helpers/wrf/wrf_vars.py variable set)."""
    rng = np.random.default_rng(3)
    base_p = 1e5 * np.exp(-np.arange(nz) / 8.0)[None, :, None, None]
    data = {
        "P": (("time", "z", "y", "x"),
              rng.normal(0, 50, (nt, nz, ny, nx)).astype(np.float32)),
        "PB": (("time", "z", "y", "x"),
               np.broadcast_to(base_p, (nt, nz, ny, nx)).astype(np.float32)),
        "PH": (("time", "zi", "y", "x"),
               rng.normal(0, 9.0, (nt, nz + 1, ny, nx)).astype(np.float32)),
        "PHB": (("time", "zi", "y", "x"), np.broadcast_to(
            9.81 * 500.0 * np.arange(nz + 1, dtype=np.float32)
            [None, :, None, None], (nt, nz + 1, ny, nx)).copy()),
        "T": (("time", "z", "y", "x"),
              rng.normal(0, 2, (nt, nz, ny, nx)).astype(np.float32)),
        "QVAPOR": (("time", "z", "y", "x"),
                   np.full((nt, nz, ny, nx), 0.004, np.float32)),
        "QCLOUD": (("time", "z", "y", "x"),
                   np.full((nt, nz, ny, nx), 1e-4, np.float32)),
        "QRAIN": (("time", "z", "y", "x"),
                  np.full((nt, nz, ny, nx), 2e-4, np.float32)),
        "U": (("time", "z", "y", "xs"),
              np.full((nt, nz, ny, nx + 1), 10.0, np.float32)),
        "V": (("time", "z", "ys", "x"),
              np.full((nt, nz, ny + 1, nx), -3.0, np.float32)),
        "TSK": (("time", "y", "x"),
                np.full((nt, ny, nx), 288.0, np.float32)),
        "SWDOWN": (("time", "y", "x"),
                   np.full((nt, ny, nx), 400.0, np.float32)),
        "GLW": (("time", "y", "x"),
                np.full((nt, ny, nx), 300.0, np.float32)),
        "HGT": (("time", "y", "x"),
                np.zeros((nt, ny, nx), np.float32)),
        "XLAND": (("time", "y", "x"), np.broadcast_to(
            (1.0 + (np.arange(nx) % 2))[None, None, :].astype(np.float32),
            (nt, ny, nx)).copy()),
        "XLAT": (("time", "y", "x"), np.broadcast_to(
            np.linspace(40, 41, ny, dtype=np.float32)[None, :, None],
            (nt, ny, nx)).copy()),
        "XLONG": (("time", "y", "x"), np.broadcast_to(
            np.linspace(-106, -105, nx, dtype=np.float32)[None, None, :],
            (nt, ny, nx)).copy()),
        "Times": (("time", "datestrlen"), np.array(
            [list(f"2010-06-0{i + 1}_00:00:00") for i in range(nt)], "S1")),
    }
    if classic:
        from scipy.io import netcdf_file
        f = netcdf_file(path, "w")
        dimsizes = {"time": nt, "z": nz, "zi": nz + 1, "y": ny, "x": nx,
                    "xs": nx + 1, "ys": ny + 1, "datestrlen": 19}
        for d, n in dimsizes.items():
            f.createDimension(d, n)
        for name, (dims, arr) in data.items():
            v = f.createVariable(name, arr.dtype if arr.dtype.kind != "S"
                                 else "S1", dims)
            v[:] = arr
        f.close()
    else:
        write_vars(path, {k: v for k, v in data.items() if k != "Times"})
        # h5py path: append Times as raw char dataset
        import h5py
        with h5py.File(path, "a") as f:
            f.create_dataset("Times", data=data["Times"][1])


@pytest.mark.parametrize("classic", [False, True])
def test_wrf2icar_convert_and_ingest(tmp_path, classic):
    """wrf2icar produces a forcing file icar_tpu can ingest directly
    (helpers/wrf/wrf2icar.py + wrf_vars.py equivalents)."""
    import importlib
    wrf2icar = importlib.import_module("wrf2icar")

    src = str(tmp_path / ("wrf_classic.nc" if classic else "wrf_h5.nc"))
    _write_synthetic_wrfout(src, classic=classic)
    out = str(tmp_path / "forcing.nc")
    wrf2icar.convert([src], out, verbose=False)

    with NCFile(out) as f:
        p = f.read("pressure")
        assert p.shape == (2, 5, 8, 10)
        z = f.read("z")
        # (PH+PHB)/g destaggered: mass levels at 250,750,... +- noise
        assert abs(z[0, 0].mean() - 250.0) < 5.0
        np.testing.assert_allclose(f.read("u"), 10.0, rtol=1e-6)
        np.testing.assert_allclose(f.read("v"), -3.0, rtol=1e-6)
        th = f.read("theta")
        assert abs(th.mean() - 300.0) < 3.0
        qc = f.read("qc")
        np.testing.assert_allclose(qc, 3e-4, rtol=1e-5)
        lm = f.read("landmask")
        assert set(np.unique(lm)) == {0.0, 1.0}
        t = f.read("time")
        np.testing.assert_allclose(t, [0.0, 24.0])
        assert f.read_attr("time", "units").startswith(
            "hours since 2010-06-01")

    # the converted file feeds straight into the forcing reader
    from icar_tpu.config import Options
    from icar_tpu.forcing.boundary import ForcingData
    o = Options()
    o.forcing.boundary_files = [out]
    for slot, name in (("p", "pressure"), ("t", "theta"), ("qv", "qv"),
                       ("u", "u"), ("v", "v"), ("z", "z"), ("lat", "lat"),
                       ("lon", "lon"), ("hgt", "hgt"), ("sst", "tsk"),
                       ("swdown", "swdown"), ("lwdown", "glw")):
        o.forcing.var_names[slot] = name
    fd = ForcingData(o)
    step = fd.read_step(0)
    assert step["p"].shape == (5, 8, 10)
    np.testing.assert_allclose(step["u"], 10.0, rtol=1e-6)
    assert np.all(step["z"] > 0)


def test_reanalysis2icar_pressure_levels(tmp_path):
    """ERA5-style pressure-level file -> forcing (helpers/erai equivalent):
    theta from real T, z from geopotential, qv from specific humidity,
    descending lat/levels flipped ascending."""
    import importlib
    r2i = importlib.import_module("reanalysis2icar")

    nt, nz, ny, nx = 2, 4, 6, 8
    lat = np.linspace(45, 40, ny)            # descending, ERA5-style
    lon = np.linspace(250, 257, nx)
    lev = np.array([300.0, 500, 700, 850])   # hPa, top-down
    rng = np.random.default_rng(5)
    t_real = 250 + 40 * rng.random((nt, nz, ny, nx))
    q_sh = np.full((nt, nz, ny, nx), 0.005)
    gph = 9.81 * np.broadcast_to(
        np.array([9000.0, 5500, 3000, 1500])[None, :, None, None],
        (nt, nz, ny, nx))
    u = np.full((nt, nz, ny, nx), 12.0)
    v = np.full((nt, nz, ny, nx), -2.0)
    src = str(tmp_path / "era.nc")
    write_vars(src, {
        "latitude": (("latitude",), lat.astype(np.float32)),
        "longitude": (("longitude",), lon.astype(np.float32)),
        "level": (("level",), lev.astype(np.float32)),
        "t": (("time", "level", "latitude", "longitude"),
              t_real.astype(np.float32)),
        "q": (("time", "level", "latitude", "longitude"),
              q_sh.astype(np.float32)),
        "z": (("time", "level", "latitude", "longitude"),
              gph.astype(np.float32)),
        "u": (("time", "level", "latitude", "longitude"),
              u.astype(np.float32)),
        "v": (("time", "level", "latitude", "longitude"),
              v.astype(np.float32))})
    out = str(tmp_path / "forcing.nc")
    names = {"u": "u", "v": "v", "t": "t", "q": "q", "z": "z",
             "lev": "level", "lat": "latitude", "lon": "longitude"}
    r2i.convert([src], out, names, verbose=False)

    with NCFile(out) as f:
        p = f.read("pressure")
        assert p.shape == (nt, nz, ny, nx)
        # ascending z: pressure decreasing with k, in Pa
        assert p[0, 0, 0, 0] == 85000.0 and p[0, -1, 0, 0] == 30000.0
        z = f.read("z")
        np.testing.assert_allclose(z[0, :, 0, 0], [1500, 3000, 5500, 9000])
        th = f.read("theta")
        # theta = T * (p0/p)^(R/cp) of the bottom (850 hPa) level
        want = t_real[0, 3, ::-1][0, 0] * (1e5 / 85000.0) ** (287.058 / 1012)
        np.testing.assert_allclose(th[0, 0, 0, 0], want, rtol=1e-5)
        qv = f.read("qv")
        np.testing.assert_allclose(qv, 0.005 / 0.995, rtol=1e-5)
        la = f.read("lat")
        assert la[0, 0] == 40.0 and la[-1, 0] == 45.0   # flipped ascending


def test_extract_daily_precip(tmp_path):
    import importlib
    edp = importlib.import_module("extract_daily_precip")

    ny, nx = 3, 4
    times = np.array([0.0, 43200, 86400, 129600, 172800])
    acc = np.cumsum(np.ones((5, ny, nx)), axis=0) - 1   # +1 mm per frame
    src = str(tmp_path / "out.nc")
    write_vars(src, {
        "model_time": (("time",), times.astype(np.float64)),
        "precipitation": (("time", "y", "x"), acc.astype(np.float32))})
    t, pr = edp.load_steps([src])
    daily = edp.daily_totals(t, pr)
    assert daily.shape == (2, ny, nx)
    np.testing.assert_allclose(daily[0], 2.0)   # frames at 12h & 24h
    np.testing.assert_allclose(daily[1], 2.0)   # frames at 36h & 48h


def test_make_domain_from_dem(tmp_path):
    """DEM -> init-conditions file (helpers/make_domain.py equivalent):
    subset, coarsen, smooth, landmask; the output loads as a model domain."""
    import importlib
    md = importlib.import_module("make_domain")

    ny, nx = 30, 40
    lat = np.linspace(38, 42, ny)
    lon = np.linspace(-109, -104, nx)
    lon2, lat2 = np.meshgrid(lon, lat)
    elev = 1500 + 800 * np.sin(lon2 * 3) * np.cos(lat2 * 2)
    elev[:10, :] = 0.0                    # an ocean strip
    dem = str(tmp_path / "dem.nc")
    write_vars(dem, {"elevation": (("lat", "lon"), elev.astype(np.float32)),
                     "lat": (("lat",), lat.astype(np.float32)),
                     "lon": (("lon",), lon.astype(np.float32))})
    out = str(tmp_path / "domain.nc")
    md.make_domain(dem, out, lat_range=(38.5, 41.5), coarsen=2, smooth=1,
                   verbose=False)
    with NCFile(out) as f:
        hgt = f.read("hgt_hi")
        la = f.read("lat_hi")
        lm = f.read("landmask")
    assert hgt.shape == la.shape == lm.shape
    assert la.min() >= 38.4 and la.max() <= 41.6
    assert set(np.unique(lm)) <= {1.0, 2.0}
    assert (lm == 2.0).any() and (lm == 1.0).any()
    assert hgt.max() > 1000

    # the file is a valid init_conditions_file for load_domain
    from icar_tpu.config import Options
    from icar_tpu.core.driver import load_domain
    o = Options()
    o.forcing.init_conditions_file = out
    terrain, la2, lo2 = load_domain(o)
    assert terrain.shape == hgt.shape


def test_gen_sounding(tmp_path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gen_sounding", os.path.join(REPO, "tools", "gen_sounding.py"))
    gs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gs)
    out = str(tmp_path / "snd.txt")
    gs.main(["285", "6", "--rh", "0.9", "--dz", "500", "--ztop", "15000",
             "-o", out])
    lines = open(out).read().strip().splitlines()
    sfc = [float(x) for x in lines[0].split()]
    assert sfc[0] == 1000.0 and sfc[1] == 285.0
    rows = np.array([[float(x) for x in l.split()] for l in lines[1:]])
    assert rows.shape == (31, 5)
    # theta increases at the prescribed lapse rate; qv decreases upward
    np.testing.assert_allclose(np.diff(rows[:, 1]), 3.0, atol=1e-3)
    assert (np.diff(rows[:, 2]) < 0).all()
    # moist adiabat: theta increases with height above the LCL
    out2 = str(tmp_path / "snd2.txt")
    gs.main(["300", "7", "--moist-adiabat", "--dz", "1000", "-o", out2])
    rows2 = np.array([[float(x) for x in l.split()]
                      for l in open(out2).read().strip().splitlines()[1:]])
    assert rows2[10, 1] > rows2[0, 1] + 20


def test_fix_time(tmp_path):
    import h5py
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "fix_time", os.path.join(REPO, "tools", "fix_time.py"))
    ft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ft)
    # simulate a restart-overlapped time axis: 0..5h then restart at 3h
    t = np.array([0, 3600, 7200, 10800, 14400, 18000,
                  10800, 14400, 18000, 21600], np.float64)
    path = str(tmp_path / "out.nc")
    with h5py.File(path, "w") as f:
        f.create_dataset("model_time", data=t, maxshape=(None,),
                         chunks=True)
        f.create_dataset("precip", data=np.arange(10.0),
                         maxshape=(None,), chunks=True)
    fixed = str(tmp_path / "fixed.nc")
    ft.main([path, "-o", fixed])
    with h5py.File(fixed) as f:
        tn = f["model_time"][...]
    assert (np.diff(tn) > 0).all()
    np.testing.assert_allclose(tn, np.arange(10) * 3600.0)

    ft.main([path, "-o", fixed, "--truncate"])
    with h5py.File(fixed) as f:
        tn = f["model_time"][...]
        pr = f["precip"][...]
    assert (np.diff(tn) > 0).all()
    np.testing.assert_allclose(tn, [0, 3600, 7200, 10800, 14400, 18000,
                                    21600])
    np.testing.assert_allclose(pr, [0, 1, 2, 6, 7, 8, 9])


def test_get_merra_script_and_convert(tmp_path):
    """get_merra emits the authenticated wget script and its --convert
    mode flips lev surface-up and concatenates days (the reference's
    helpers/get_merra.py + its nco ncpdq/ncrcat post-step)."""
    r = _run("get_merra.py", "-s", "2010-01-01", "-e", "2010-01-03")
    assert r.returncode == 0, r.stderr
    lines = [l for l in r.stdout.splitlines() if l.startswith("wget")]
    assert len(lines) == 2                      # one per day
    assert "M2I3NVASM" in lines[0] and "20100101" in lines[0]
    assert "MERRA2_300" in lines[0]             # decade stream number

    # two synthetic daily files, MERRA layout: (time, lev, lat, lon),
    # lev stored top-down
    lev = np.arange(5, dtype=np.float64)
    for day in ("20100101", "20100102"):
        path = tmp_path / f"MERRA2_300.inst3_3d_asm_Nv.{day}.SUB.nc"
        with NCFile(str(path), "w") as f:
            f.create_var("time", ("time",), np.arange(0, 1440, 180.0))
            f.create_var("lat", ("lat",), np.linspace(30, 40, 4))
            f.create_var("lon", ("lon",), np.linspace(-110, -100, 6))
            f.create_var("lev", ("lev",), lev)
            t3 = np.arange(8 * 5 * 4 * 6, dtype=np.float32).reshape(8, 5, 4, 6)
            f.create_var("T", ("time", "lev", "lat", "lon"), t3)
            f.create_var("PS", ("time", "lat", "lon"),
                         np.full((8, 4, 6), 1e5, np.float32))
    out = str(tmp_path / "merra.nc")
    r = _run("get_merra.py", "--convert",
             str(tmp_path / "MERRA2_*.SUB.nc"), "-o", out)
    assert r.returncode == 0, r.stderr
    with NCFile(out) as f:
        T = f.read("T")
        t = f.read("time")
        assert T.shape == (16, 5, 4, 6)         # 2 days concatenated
        # lev flipped: converted level 0 == original top index 4
        ref = np.arange(8 * 5 * 4 * 6, dtype=np.float32).reshape(8, 5, 4, 6)
        np.testing.assert_array_equal(T[0, 0], ref[0, 4])
        assert (np.diff(t) > 0).all()           # monotonic across days
        assert f.read("PS").shape == (16, 4, 6)


def test_reanalysis2icar_dataset_presets(tmp_path):
    """--preset covers the reference's per-dataset converter suites
    (helpers/erai, cesm/ccsm, cmip, + MERRA-2): hybrid-sigma with
    ln(ps) (ERA-I), hyam*P0+hybm*PS (CESM), and direct 3D pressure
    (MERRA-2 PL)."""
    import importlib
    r2i = importlib.import_module("reanalysis2icar")

    nt, nz, ny, nx = 1, 3, 4, 5
    lat = np.linspace(40, 43, ny)
    lon = np.linspace(250, 254, nx)
    rng = np.random.default_rng(6)
    t_real = (250 + 40 * rng.random((nt, nz, ny, nx))).astype(np.float32)
    q = np.full((nt, nz, ny, nx), 0.004, np.float32)
    uu = np.full((nt, nz, ny, nx), 7.0, np.float32)

    # --- CESM: hybrid sigma, Z3 geometric height, surface-up levels
    hyam = np.array([0.0, 0.1, 0.2], np.float32)
    hybm = np.array([0.9, 0.6, 0.3], np.float32)
    ps = np.full((nt, ny, nx), 100000.0, np.float32)
    z3 = np.broadcast_to(np.array([500.0, 3000, 8000], np.float32)
                         [None, :, None, None], (nt, nz, ny, nx))
    src = str(tmp_path / "cesm.nc")
    dims4 = ("time", "lev", "lat", "lon")
    write_vars(src, {
        "lat": (("lat",), lat.astype(np.float32)),
        "lon": (("lon",), lon.astype(np.float32)),
        "hyam": (("lev",), hyam), "hybm": (("lev",), hybm),
        "P0": ((), np.float32(100000.0)),
        "PS": (("time", "lat", "lon"), ps),
        "T": (dims4, t_real), "Q": (dims4, q),
        "U": (dims4, uu), "V": (dims4, uu), "Z3": (dims4, z3.copy())})
    out = str(tmp_path / "cesm_forcing.nc")
    assert r2i.main([src, "-o", out, "--preset", "cesm", "-q"]) == 0
    with NCFile(out) as f:
        p = f.read("pressure")
        # p_k = hyam*P0 + hybm*PS, ascending z (p decreasing)
        np.testing.assert_allclose(p[0, :, 0, 0], [90000, 70000, 50000],
                                   rtol=1e-5)
        # Z3 is geometric height: passed through un-divided
        np.testing.assert_allclose(f.read("z")[0, :, 0, 0],
                                   [500, 3000, 8000], rtol=1e-6)

    # --- ERA-I: GRIB names, ln(ps), geopotential z
    lnps = np.log(ps)[:, None]  # (t, 1, y, x) as the GRIB conversion gives
    srce = str(tmp_path / "erai.nc")
    dims4e = ("time", "lv_HYBL2", "g4_lat_0", "g4_lon_1")
    write_vars(srce, {
        "g4_lat_0": (("g4_lat_0",), lat.astype(np.float32)),
        "g4_lon_1": (("g4_lon_1",), lon.astype(np.float32)),
        "lv_HYBL2_a": (("lv_HYBL2",), hyam * 100000.0),
        "lv_HYBL2_b": (("lv_HYBL2",), hybm),
        "P0": ((), np.float32(1.0)),
        "LNSP_GDS4_HYBL": (("time", "one", "g4_lat_0", "g4_lon_1"),
                           lnps.astype(np.float32)),
        "T_GDS4_HYBL": (dims4e, t_real),
        "Q_GDS4_HYBL": (dims4e, q),
        "U_GDS4_HYBL": (dims4e, uu), "V_GDS4_HYBL": (dims4e, uu),
        "Z_GDS4_HYBL": (dims4e, (z3 * 9.81).astype(np.float32))})
    oute = str(tmp_path / "erai_forcing.nc")
    assert r2i.main([srce, "-o", oute, "--preset", "erai", "-q"]) == 0
    with NCFile(oute) as f:
        np.testing.assert_allclose(f.read("pressure")[0, :, 0, 0],
                                   [90000, 70000, 50000], rtol=1e-5)
        # geopotential divided by g
        np.testing.assert_allclose(f.read("z")[0, :, 0, 0],
                                   [500, 3000, 8000], rtol=1e-5)

    # --- MERRA-2: direct 3D pressure PL, H geometric
    srcm = str(tmp_path / "merra.nc")
    pl = np.broadcast_to(np.array([90000.0, 70000, 50000], np.float32)
                         [None, :, None, None], (nt, nz, ny, nx))
    dims4m = ("time", "lev", "lat", "lon")
    write_vars(srcm, {
        "lat": (("lat",), lat.astype(np.float32)),
        "lon": (("lon",), lon.astype(np.float32)),
        "PL": (dims4m, pl.copy()), "T": (dims4m, t_real),
        "QV": (dims4m, q), "U": (dims4m, uu), "V": (dims4m, uu),
        "H": (dims4m, z3.copy())})
    outm = str(tmp_path / "merra_forcing.nc")
    assert r2i.main([srcm, "-o", outm, "--preset", "merra2", "-q"]) == 0
    with NCFile(outm) as f:
        np.testing.assert_allclose(f.read("pressure")[0, :, 0, 0],
                                   [90000, 70000, 50000])
        np.testing.assert_allclose(f.read("z")[0, :, 0, 0],
                                   [500, 3000, 8000])


@pytest.mark.parametrize("fault", ["no-sedimentation", "one-saturation-trip",
                                   "rain-formation-x2"])
def test_ridge_tolerance_rejects_planted_fault(fault):
    """chip_smoke.RIDGE_TOL rejects each fault that
    tools/ridge_tol_control.py plants in the SB04 scheme (here on the CPU
    at 60x60x20; the tool runs it on the card at full width)."""
    import ridge_tol_control

    [(name, rejected, lines)] = list(
        ridge_tol_control.verdicts((20, 60, 60), names=[fault]))
    assert name == fault
    assert rejected, "\n".join(lines)

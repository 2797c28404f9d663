#!/usr/bin/env python
"""Convert WRF output (wrfout) files into icar_tpu forcing files.

The counterpart of the reference's WRF preprocessing
(/root/reference/helpers/wrf/wrf2icar.py + wrf_vars.py, and the NCO
script helpers/wrf2icar.sh): reads one or more wrfout files, computes
the derived fields ICAR wants, destaggers winds and geopotential to
mass points, and writes a single forcing NetCDF that
``python -m icar_tpu`` ingests with its *default* var_list names.

Field derivations (wrf_vars.py:15-34):
    pressure = P + PB                     [Pa]
    z        = (PH + PHB) / g             geopotential height, destaggered
                                          from interfaces to mass levels
    theta    = T + 300                    perturbation -> full potential T
    qv       = QVAPOR
    qc       = QCLOUD + QRAIN             (merged, as the reference does)
    qi       = QICE + QSNOW + QGRAUP
    u, v     = U, V destaggered to mass points (wrf2icar.sh rotates
               met_em winds earth-relative; wrfout U/V are grid-relative,
               so the companion cosalpha/sinalpha rotation is handled by
               icar_tpu's make_winds_grid_relative path when COSALPHA /
               SINALPHA are present)
    2D       : HGT, XLAT, XLONG, TSK (sst slot), SWDOWN, GLW (lwdown),
               XLAND -> landmask (1=land, 0=water)

Usage:
    python tools/wrf2icar.py wrfout_d01_2000-10-01* -o icar_forcing.nc

Reads NetCDF-4/HDF5 wrfout files via h5py and classic NetCDF-3 via
scipy.io.netcdf_file (WRF writes either, depending on io_form).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GRAVITY = 9.81


class _Reader:
    """Uniform variable access over NetCDF-4 (h5py) or classic NetCDF-3
    (scipy) wrfout files."""

    def __init__(self, path: str):
        self.path = path
        self._h5 = None
        self._sc = None
        try:
            from icar_tpu.io.netcdf import NCFile
            self._h5 = NCFile(path)
        except Exception:
            from scipy.io import netcdf_file
            self._sc = netcdf_file(path, "r", mmap=False)

    def has(self, name: str) -> bool:
        if self._h5 is not None:
            return self._h5.has_var(name)
        return name in self._sc.variables

    def read(self, name: str) -> np.ndarray:
        if self._h5 is not None:
            return np.asarray(self._h5.read(name))
        return np.asarray(self._sc.variables[name][:])

    def close(self):
        if self._h5 is not None:
            self._h5.close()
        else:
            self._sc.close()


def _destagger(a: np.ndarray, axis: int) -> np.ndarray:
    lo = [slice(None)] * a.ndim
    hi = [slice(None)] * a.ndim
    lo[axis] = slice(None, -1)
    hi[axis] = slice(1, None)
    return 0.5 * (a[tuple(lo)] + a[tuple(hi)])


def _parse_times(times: np.ndarray):
    """WRF Times char array (nt, 19) -> list of 'YYYY-MM-DD HH:MM:SS'."""
    out = []
    for row in times:
        s = b"".join(np.asarray(row, "S1").ravel()).decode()
        out.append(s.replace("_", " "))
    return out


def convert(paths, out_path, verbose=True):
    acc: dict = {}
    times: list = []

    def add(name, data):
        acc.setdefault(name, []).append(np.asarray(data, np.float32))

    for path in paths:
        f = _Reader(path)
        if verbose:
            print(f"reading {path}")
        p = f.read("P") + f.read("PB")
        nt = p.shape[0]
        add("pressure", p)
        add("z", _destagger(f.read("PH") + f.read("PHB"), axis=1) / GRAVITY)
        add("theta", f.read("T") + 300.0)
        add("qv", f.read("QVAPOR"))
        qc = f.read("QCLOUD") if f.has("QCLOUD") else np.zeros_like(p)
        if f.has("QRAIN"):
            qc = qc + f.read("QRAIN")
        add("qc", qc)
        if f.has("QICE") or f.has("QSNOW"):
            qi = np.zeros_like(p)
            for n in ("QICE", "QSNOW", "QGRAUP"):
                if f.has(n):
                    qi = qi + f.read(n)
            add("qi", qi)
        add("u", _destagger(f.read("U"), axis=3))
        add("v", _destagger(f.read("V"), axis=2))
        for wrf_name, out_name in (("TSK", "tsk"), ("SWDOWN", "swdown"),
                                   ("GLW", "glw"), ("PBLH", "pblh"),
                                   ("HFX", "hfx"), ("LH", "lh")):
            if f.has(wrf_name):
                add(out_name, f.read(wrf_name))
        if "lat" not in acc:
            acc["lat"] = [f.read("XLAT")[0]]
            acc["lon"] = [f.read("XLONG")[0]]
            acc["hgt"] = [f.read("HGT")[0]]
            if f.has("XLAND"):
                # XLAND: 1=land, 2=water -> ICAR landmask 1=land, 0=water
                acc["landmask"] = [
                    (f.read("XLAND")[0] < 1.5).astype(np.float32)]
            for n in ("COSALPHA", "SINALPHA"):
                if f.has(n):
                    acc[n.lower()] = [f.read(n)[0]]
        if f.has("Times"):
            times.extend(_parse_times(f.read("Times")))
        else:
            times.extend([""] * nt)
        f.close()

    from icar_tpu.io.netcdf import write_vars

    dims4 = ("time", "level", "y", "x")
    dims3 = ("time", "y", "x")
    dims2 = ("y", "x")
    variables = {}
    for name, chunks in acc.items():
        data = (chunks[0] if name in ("lat", "lon", "hgt", "landmask",
                                      "cosalpha", "sinalpha")
                else np.concatenate(chunks, axis=0))
        dims = {4: dims4, 3: dims3, 2: dims2}[data.ndim]
        variables[name] = (dims, np.asarray(data, np.float32))

    # advisory CF time variable (the icar_tpu driver paces forcing by
    # forcing_start_date + inputinterval, but keep the times on record)
    interval = None
    if times and times[0]:
        from icar_tpu.utils.calendar import Time
        t0 = Time.from_string(times[0])
        hours = np.array([(Time.from_string(s) - t0).seconds() / 3600.0
                          for s in times if s], np.float32)
        variables["time"] = (("time",), hours,
                             {"units": f"hours since {times[0]}"})
        if len(hours) > 1:
            interval = float(hours[1] - hours[0]) * 3600.0

    write_vars(out_path, variables,
               attrs={"title": "icar_tpu forcing converted from WRF",
                      "source_files": " ".join(os.path.basename(p)
                                               for p in paths)})
    if verbose:
        nt = len(times)
        print(f"wrote {out_path}: {nt} steps, "
              f"vars: {', '.join(sorted(variables))}")
        print("\nsuggested namelist entries:")
        print("&files_list\n"
              f"  boundary_files = \"{out_path}\"\n/")
        print("&var_list\n"
              "  pvar = \"pressure\", tvar = \"theta\", qvvar = \"qv\",\n"
              "  uvar = \"u\", vvar = \"v\", zvar = \"z\",\n"
              "  latvar = \"lat\", lonvar = \"lon\", hgtvar = \"hgt\",\n"
              "  sst_var = \"tsk\", swdown_var = \"swdown\", "
              "lwdown_var = \"glw\",\n"
              "  landvar = \"landmask\"\n/")
        if times and times[0]:
            print("&parameters\n"
                  f"  forcing_start_date = \"{times[0]}\""
                  + (f"\n  inputinterval = {interval:.0f}"
                     if interval else "") + "\n/")
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="convert WRF wrfout files to an icar_tpu forcing file")
    ap.add_argument("inputs", nargs="+", help="wrfout file(s), in time order")
    ap.add_argument("-o", "--output", default="icar_forcing.nc")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    convert(args.inputs, args.output, verbose=not args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Aggregate per-step output files into one time-series NetCDF file.

The counterpart of the reference's offline output recombination
(/root/reference/helpers/aggregate_parallel_files.py). The reference
writes one file per *image* and stitches the domain back together from
the decomposition attributes; icar_tpu already writes global-domain
files, but the native async engine ("classic-async",
icar_tpu/io/output.py AsyncStepWriter) writes one CDF-2 file per output
*step* — this tool concatenates those along a time axis into a single
NetCDF-4 file equivalent to what the default engine produces.

Usage:
    python tools/aggregate_output.py 'output/icar_out_*.nc' -o combined.nc
"""

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def read_classic(path):
    """Read all variables + global attrs of a classic (CDF-1/2) file."""
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        variables = {n: (v.dimensions, np.asarray(v[:]))
                     for n, v in f.variables.items()}
        attrs = {k: (v.decode() if isinstance(v, bytes) else v)
                 for k, v in f._attributes.items()}
    return variables, attrs


def read_nc4(path):
    """Read all variables + attrs of an h5py-backed NetCDF-4 file."""
    from icar_tpu.io.netcdf import NCFile
    with NCFile(path) as f:
        variables = {}
        for n in f.variables():
            arr = f.read(n)
            variables[n] = ((), arr)
        attrs = {k: f.read_attr(None, k) for k in f.attr_names()}
    return variables, attrs


def aggregate_shards(paths, output):
    """Stitch file-per-shard output (io/output.py ShardedOutputWriter)
    back into one global time-series file using the y_start/x_start
    decomposition attrs — the analog of the reference's
    helpers/aggregate_parallel_files.py using ids/ide/jds/jde."""
    from icar_tpu.io.netcdf import NCFile

    # group by timestamp embedded in the filename suffix
    by_time = {}
    for p in paths:
        stem = os.path.basename(p)
        t = stem.rsplit("_", 1)[-1].replace(".nc", "")
        by_time.setdefault(t, []).append(p)

    times = []
    frames = []          # list of dict name -> (dims, global array)
    gattrs = {}
    for t in sorted(by_time):
        merged = {}
        for p in sorted(by_time[t]):
            # shard files are NetCDF-4 (h5py) from the sync writer or
            # CDF-2 classic from the native async engine
            with open(p, "rb") as fh:
                magic = fh.read(3)
            reader = read_classic if magic == b"CDF" else read_nc4
            variables, attrs = reader(p)
            gattrs = attrs
            y0, x0 = int(attrs["y_start"]), int(attrs["x_start"])
            for name, (_, arr) in variables.items():
                if arr.ndim < 2:
                    continue
                if name not in merged:
                    merged[name] = []
                merged[name].append((y0, x0, arr))
        times.append(float(gattrs.get("model_time", len(times))))
        glob_f = {}
        for name, pieces in merged.items():
            ny = max(y0 + a.shape[-2] for y0, _, a in pieces)
            nx = max(x0 + a.shape[-1] for _, x0, a in pieces)
            lead = pieces[0][2].shape[:-2]
            g = np.zeros(lead + (ny, nx), np.float32)
            for y0, x0, a in pieces:
                g[..., y0:y0 + a.shape[-2], x0:x0 + a.shape[-1]] = a
            glob_f[name] = g
        frames.append(glob_f)

    with NCFile(output, "w") as out:
        out.create_dim("time", len(frames), unlimited=True)
        dims_seen = set()
        first = frames[0]
        for name, arr in first.items():
            dims = tuple(f"d{name}_{i}_{n}" for i, n in
                         enumerate(arr.shape))
            # prefer canonical dim names where unambiguous
            canon = (("lev", "lat", "lon") if arr.ndim == 3
                     else ("lat", "lon"))
            dims = tuple(f"{c}_{n}" for c, n in zip(canon, arr.shape))
            for d, n in zip(dims, arr.shape):
                if d not in dims_seen:
                    dims_seen.add(d)
                    out.create_dim(d, n)
            stacked = np.stack([fr[name] for fr in frames], axis=0)
            out.create_var(name, ("time",) + dims, stacked)
        out.create_var("model_time", ("time",),
                       np.asarray(times, np.float64))
        out.set_attrs({k: v for k, v in gattrs.items()
                       if k not in ("y_start", "x_start", "shard_id")})
    print(f"wrote {output}: {len(frames)} steps from "
          f"{len(paths)} shard files")
    return 0


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pattern", help="glob of per-step files (quote it)")
    p.add_argument("-o", "--output", default="icar_aggregated.nc")
    args = p.parse_args()

    paths = sorted(glob.glob(args.pattern))
    if not paths:
        print(f"no files match {args.pattern}", file=sys.stderr)
        return 1

    from icar_tpu.io.netcdf import NCFile

    # shard files (ShardedOutputWriter) carry decomposition attrs;
    # dispatch to spatial recombination. Shards may be NetCDF-4 (sync
    # writer) or CDF-2 classic (native async engine) — pick the reader
    # by magic bytes.
    try:
        with open(paths[0], "rb") as fh:
            magic = fh.read(3)
        reader = read_classic if magic == b"CDF" else read_nc4
        _, attrs0 = reader(paths[0])
        if "shard_id" in attrs0:
            return aggregate_shards(paths, args.output)
    except Exception:
        pass

    steps = []
    times = []
    attrs = {}
    for i, path in enumerate(paths):
        variables, attrs = read_classic(path)
        steps.append(variables)
        times.append(float(attrs.get("model_time", i)))
    times = np.asarray(times, np.float64)

    first = steps[0]
    with NCFile(args.output, "w") as out:
        out.create_dim("time", len(steps), unlimited=True)
        dims_seen = {}
        for name, (dims, arr) in first.items():
            for d, n in zip(dims, arr.shape):
                if d not in dims_seen:
                    dims_seen[d] = n
                    out.create_dim(d, n)
        out.create_var("model_time", ("time",), times)
        for name, (dims, arr) in first.items():
            stacked = np.stack([s[name][1] for s in steps], axis=0)
            out.create_var(name, ("time",) + tuple(dims), stacked)
        out.set_attrs(attrs)
    print(f"wrote {args.output}: {len(steps)} steps, "
          f"{len(first)} variables")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Repair the time axis of an icar_tpu output file.

The counterpart of /root/reference/helpers/fix_icar_time.py: when a
run is restarted without removing the output file it was restarting
into, the appended frames can carry duplicate or backward-jumping time
stamps. This tool rewrites ``model_time`` as a clean monotonic axis
``t0 + k*dt`` (dt inferred from the median positive step unless given),
or with ``--truncate`` drops every frame at or before the last backward
jump (keeping the post-restart frames, which superseded them).

Usage:
    python tools/fix_time.py icar_out.nc [-o fixed.nc] [--dt SECONDS]
        [--truncate]
"""

import argparse
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None,
                   help="write the fixed file here (default: in place)")
    p.add_argument("--dt", type=float, default=None,
                   help="output interval in seconds (default: inferred)")
    p.add_argument("--truncate", action="store_true",
                   help="drop frames superseded after a restart instead "
                        "of rewriting the axis")
    args = p.parse_args(argv)

    import h5py

    path = args.input
    if args.output and args.output != args.input:
        shutil.copyfile(args.input, args.output)
        path = args.output

    with h5py.File(path, "r+") as f:
        if "model_time" not in f:
            raise SystemExit(f"{args.input}: no model_time variable")
        t = f["model_time"][...].astype(np.float64)
        steps = np.diff(t)
        bad = np.where(steps <= 0)[0]
        if bad.size == 0 and not args.dt:
            print(f"{args.input}: time axis already monotonic "
                  f"({t.size} frames)")
            return
        if args.truncate:
            # keep the frame right before the FIRST overlapped stretch
            # and everything after the last backward jump
            cut = bad[-1] + 1
            keep = np.arange(t.size) >= cut
            # frames before the overlap that are older than the first
            # kept time stay (they were never rewritten)
            keep |= t < t[cut:].min()
            idx = np.where(keep)[0]
            for name, ds in list(f.items()):
                if ds.shape and ds.maxshape and ds.maxshape[0] is None:
                    data = ds[...][idx]
                    ds.resize(idx.size, axis=0)
                    ds[...] = data
            print(f"{args.input}: kept {idx.size}/{t.size} frames")
        else:
            dt = args.dt or float(np.median(steps[steps > 0])) \
                if steps.size else (args.dt or 3600.0)
            t_new = t[0] + dt * np.arange(t.size)
            f["model_time"][...] = t_new
            print(f"{args.input}: rewrote {t.size} frames as t0={t[0]:.0f}"
                  f" + k*{dt:.0f} s ({bad.size} non-monotonic steps fixed)")


if __name__ == "__main__":
    main()

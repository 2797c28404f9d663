#!/usr/bin/env python
"""Quick-look map plots from an icar_tpu output file.

The counterpart of the reference's quick-look plotting helper
(/root/reference/helpers/bin/plot_icar.py): given an output NetCDF file,
render a lat/lon map of one or more variables (surface / column-max for
3D fields) to an image file.

Usage:
    python tools/plot_icar.py output/icar_out_run.nc -v precipitation \
        [-v cloud_water ...] [-t -1] [-o quicklook.png] [--cmin 0 --cmax 50]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("filename")
    p.add_argument("-v", "--var", action="append", default=None,
                   help="variable(s) to map (default: precipitation)")
    p.add_argument("-t", "--time", type=int, default=-1,
                   help="time index (default: last)")
    p.add_argument("-o", "--output", default="icar_quicklook.png")
    p.add_argument("--cmin", type=float, default=None)
    p.add_argument("--cmax", type=float, default=None)
    args = p.parse_args()

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from icar_tpu.io.netcdf import NCFile

    names = args.var or ["precipitation"]
    with NCFile(args.filename) as f:
        lat = f.read("lat") if f.has_var("lat") else None
        lon = f.read("lon") if f.has_var("lon") else None
        fields = {}
        for n in names:
            if not f.has_var(n):
                print(f"warning: {n!r} not in {args.filename}; skipping",
                      file=sys.stderr)
                continue
            a = np.asarray(f.read(n))
            if a.ndim == 4:          # (time, z, y, x) -> column max
                a = a[args.time].max(axis=0)
            elif a.ndim == 3:        # (time, y, x)
                a = a[args.time]
            fields[n] = a
    if not fields:
        print("nothing to plot", file=sys.stderr)
        return 1

    ncol = len(fields)
    fig, axes = plt.subplots(1, ncol, figsize=(6 * ncol, 4.5), squeeze=False)
    for ax, (n, a) in zip(axes[0], fields.items()):
        if lat is not None and lon is not None and lat.shape == a.shape:
            im = ax.pcolormesh(lon, lat, a, shading="auto",
                               vmin=args.cmin, vmax=args.cmax)
            ax.set_xlabel("longitude")
            ax.set_ylabel("latitude")
        else:
            im = ax.imshow(a, origin="lower", vmin=args.cmin, vmax=args.cmax)
        ax.set_title(n)
        fig.colorbar(im, ax=ax, shrink=0.9)
    fig.tight_layout()
    fig.savefig(args.output, dpi=120)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Generate a WRF ``input_sounding``-style text file.

The counterpart of /root/reference/helpers/gen_sounding.py: first
line is ``p_surf[hPa] theta_surf[K] qv_surf[g/kg]``, then one line per
level of ``z[m] theta[K] qv[g/kg] u[m/s] v[m/s]``. Two temperature
profiles: a linear potential-temperature lapse rate (default), or a
pseudo-moist-adiabat above the LCL (Bolton 1980 theta-e inversion,
matching the reference's compT_fr_The iteration).

Usage:
    python tools/gen_sounding.py [t_surf_K] [lapse_K_per_km]
        [--rh 0.95] [--u 10] [--v 0] [--dz 100] [--ztop 25000]
        [--psfc 1000] [--moist-adiabat] [-o sounding.txt]
"""

import argparse
import sys

import numpy as np

RD, CP, G = 287.058, 1012.0, 9.81
EPS = 0.622


def sat_mr(p_hpa, t):
    """Saturation mixing ratio [kg/kg] (Bolton 1980 eqn 10)."""
    es = 6.112 * np.exp(17.67 * (t - 273.15) / (t - 29.65))
    es = np.minimum(es, 0.99 * p_hpa)
    return EPS * es / (p_hpa - es)


def theta_e(pres_pa, temp, mr, tlcl):
    """Equivalent potential temperature (Bolton 1980 eqn 43)."""
    mr = max(mr, 1e-8)
    xx = temp * (100000.0 / pres_pa) ** (0.2854 * (1.0 - 0.28 * mr))
    return xx * np.exp(((3.376 / tlcl) - 0.00254)
                       * (mr * 1000.0) * (1.0 + 0.81 * mr))


def t_lcl(temp, tdew):
    """LCL temperature (Bolton 1980 eqn 15)."""
    denom = 1.0 / (tdew - 56.0) + np.log(temp / tdew) / 800.0
    return 1.0 / denom + 56.0


def t_from_theta_e(thelcl, pres_pa):
    """Temperature on the moist adiabat given theta-e at the LCL
    (compT_fr_The Newton iteration, gen_sounding.py:96-120)."""
    guess = (thelcl - 0.5 * max(thelcl - 270.0, 0.0) ** 1.05) \
        * (pres_pa / 1e5) ** 0.2
    for _ in range(100):
        w1 = sat_mr(pres_pa / 100.0, guess)
        w2 = sat_mr(pres_pa / 100.0, guess + 1.0)
        tenu = theta_e(pres_pa, guess, w1, guess)
        tenup = theta_e(pres_pa, guess + 1.0, w2, guess + 1.0)
        cor = (thelcl - tenu) / (tenup - tenu)
        guess += cor
        if abs(cor) < 0.01:
            break
    return guess


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("t_surf", nargs="?", type=float, default=270.0)
    p.add_argument("lapse", nargs="?", type=float, default=5.0,
                   help="potential-temperature lapse rate [K/km]")
    p.add_argument("--rh", type=float, default=0.95)
    p.add_argument("--u", type=float, default=10.0)
    p.add_argument("--v", type=float, default=0.0)
    p.add_argument("--dz", type=float, default=100.0)
    p.add_argument("--ztop", type=float, default=25000.0)
    p.add_argument("--psfc", type=float, default=1000.0, help="hPa")
    p.add_argument("--moist-adiabat", action="store_true",
                   help="follow a pseudo-adiabat above the LCL")
    p.add_argument("-o", "--output", default="sounding.txt")
    args = p.parse_args(argv)

    z = np.arange(0.0, args.ztop + args.dz, args.dz)
    nz = z.size
    theta = args.t_surf + args.lapse * 1e-3 * z
    pres = np.empty(nz)
    temp = np.empty(nz)
    qv = np.empty(nz)
    pres[0] = args.psfc * 100.0
    temp[0] = args.t_surf
    qv[0] = args.rh * sat_mr(args.psfc, args.t_surf)

    # theta-e of the surface parcel for the moist-adiabat option
    tdew = temp[0] - (temp[0] - 273.15) * (1.0 - args.rh) * 0.2 - \
        (1.0 - args.rh) * 25.0            # rough dewpoint estimate
    tlcl = t_lcl(temp[0], min(tdew, temp[0]))
    the0 = theta_e(pres[0], temp[0], qv[0], tlcl)

    for k in range(1, nz):
        tv = temp[k - 1] * (1.0 + 0.608 * qv[k - 1])
        pres[k] = pres[k - 1] * np.exp(-G * args.dz / (RD * tv))
        if args.moist_adiabat:
            temp[k] = t_from_theta_e(the0, pres[k])
            theta[k] = temp[k] * (1e5 / pres[k]) ** (RD / CP)
        else:
            temp[k] = theta[k] * (pres[k] / 1e5) ** (RD / CP)
        qv[k] = args.rh * sat_mr(pres[k] / 100.0, temp[k])

    with open(args.output, "w") as f:
        f.write(f"{args.psfc:10.2f} {theta[0]:10.3f} "
                f"{qv[0] * 1000:10.5f}\n")
        for k in range(nz):
            f.write(f"{z[k]:10.1f} {theta[k]:10.3f} {qv[k] * 1000:10.5f} "
                    f"{args.u:8.2f} {args.v:8.2f}\n")
    print(f"wrote {args.output}: {nz} levels, p_top="
          f"{pres[-1] / 100:.1f} hPa")


if __name__ == "__main__":
    main()

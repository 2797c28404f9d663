#!/usr/bin/env python
"""Control for chip_smoke.py's ridge tolerance: it must reject a wrong
scheme, not only accept a right one.

    python tools/ridge_tol_control.py [--size 500x500x20]

Runs one ideal-ridge interval (chip_smoke.py's phase 3: the bench's ridge,
upwind + SB04) with a fault planted in the SB04 scheme, on JAX's default
device, and compares it with ``chip_smoke.RIDGE_TOL`` against the same
interval with the correct scheme on the host CPU backend. The faulted runs
use the jnp scheme on every backend (on the GPU the kernel is bit-identical
to it). Prints one verdict line per fault and exits non-zero if any fault
passes the tolerance. The faults:

- ``no-sedimentation``: rain and snow never fall;
- ``one-saturation-trip``: the saturation adjustment stops after one
  halving step (of up to 15), with no revert;
- ``rain-formation-x2``: cloud turns into rain twice as fast.
"""

import argparse
import os
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _one_trip(pressure, temperature, qv, qc, dt):
    """cloud_conversion cut to its first halving step."""
    from icar_tpu.physics import mp_simple as ms
    import jax.numpy as jnp
    vapor2temp = (ms.LH_VAPOR + (373.15 - temperature) * ms.DLHVDT) \
        / ms.HEAT_CAPACITY
    qvs = ms.sat_mr(temperature, pressure)
    sup = qv > qvs
    exc = jnp.where(sup, (qv - qvs) * 0.5,
                    -jnp.minimum((qvs - qv) * 0.5, qc))
    exc = jnp.where(sup | (qc > 0), exc, 0.0)
    return (temperature + exc * vapor2temp, qv - exc,
            jnp.maximum(qc + exc, 0.0), qvs)


def faults():
    """name -> the patches (attribute of physics/mp_simple, value) that
    plant it."""
    from icar_tpu.physics import mp_simple as ms
    return {
        "no-sedimentation": {"_sediment_species": (
            lambda q, qv, t, *a: (q, qv, t, q[0] * 0.0))},
        "one-saturation-trip": {"cloud_conversion": _one_trip},
        "rain-formation-x2": {"RAIN_FORMATION_TC":
                              2 * ms.RAIN_FORMATION_TC},
    }


def faulted_ridge(shape, patches, device=None):
    """The chip_smoke ridge through one interval with ``patches`` planted
    in the jnp SB04 scheme (traced, so the patches hold, during the first
    advance)."""
    import contextlib

    import jax

    import chip_smoke
    from bench import build_model
    from icar_tpu.physics import mp_simple as ms

    jnp_only = lambda *a, mesh=None: ms.mp_simple_jnp(*a)
    with contextlib.ExitStack() as stack:
        if device is not None:
            stack.enter_context(jax.default_device(device))
        stack.enter_context(mock.patch.object(ms, "mp_simple", jnp_only))
        for name, value in patches.items():
            stack.enter_context(mock.patch.object(ms, name, value))
        m = chip_smoke.ridge_model(build_model, shape)
        m.advance(chip_smoke.RIDGE_INTERVAL)
        chip_smoke.sync(m)
    return m


def verdicts(shape, names=None):
    """Each fault's comparison with the correct scheme on the host CPU:
    yields (fault, rejected, report lines)."""
    import jax

    import chip_smoke
    ref = faulted_ridge(shape, {}, jax.devices("cpu")[0])
    for name, patches in faults().items():
        if names is not None and name not in names:
            continue
        m = faulted_ridge(shape, patches)
        lines = [f"substeps {int(m.last_n_substeps)} vs "
                 f"{int(ref.last_n_substeps)}"]
        ok = int(m.last_n_substeps) == int(ref.last_n_substeps)
        for k in chip_smoke.RIDGE_FIELDS:
            field_ok, line = chip_smoke.field_error(
                k, m.field(k), ref.field(k), **chip_smoke.RIDGE_TOL)
            ok &= field_ok
            lines.append(line)
        yield name, not ok, lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="500x500x20")
    args = ap.parse_args()
    nx, ny, nz = (int(v) for v in args.size.split("x"))

    import jax
    import chip_smoke
    d = jax.devices()[0]
    print(f"ridge tolerance control: {nx}x{ny}x{nz} on {d.platform} "
          f"({d.device_kind}) vs the host CPU, RIDGE_TOL "
          f"{chip_smoke.RIDGE_TOL}", flush=True)
    passed = []
    t0 = time.time()
    for name, rejected, lines in verdicts((nz, ny, nx)):
        for line in lines:
            print(f"  {name}: {line}", flush=True)
        print(f"fault {name}: {'rejected' if rejected else 'PASSED'} "
              f"({time.time() - t0:.1f} s)", flush=True)
        if not rejected:
            passed.append(name)
    if passed:
        raise SystemExit(f"the ridge tolerance accepts: {', '.join(passed)}")


if __name__ == "__main__":
    main()

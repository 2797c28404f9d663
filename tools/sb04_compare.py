#!/usr/bin/env python
"""SB04 kernel vs the plain jnp scheme on the GPU: layer and end to end.

    python tools/sb04_compare.py [--size 500x500x20] [--reps 3]

In one process, on one card:

1. ridge intervals (upwind + SB04, ``ICARModel.advance``) with the kernel
   and with the jnp scheme, alternating kernel, jnp, jnp, kernel, in
   grid-points*substeps/s;
2. the SB04 layer alone on the post-spin-up ridge state, the kernel and
   the jnp scheme alternating, in ms per call.

Every timer ends in ``jax.block_until_ready``; the value fetch timed right
after it shows whether that sync waited for the (donated) step. Prints one
line per number, with the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="500x500x20")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--interval", type=float, default=1200.0)
    args = ap.parse_args()
    nx, ny, nz = (int(v) for v in args.size.split("x"))

    import jax
    import numpy as np

    from bench import build_model
    from icar_tpu.ops import sb04_kernel
    from icar_tpu.physics import mp_simple

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX runs on {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"device {dev.device_kind}; card {card}", flush=True)

    def advance(m):
        t0 = time.perf_counter()
        m.advance(args.interval)
        jax.block_until_ready(m.state)
        t1 = time.perf_counter()
        n = int(m.last_n_substeps)
        t2 = time.perf_counter()
        return t1 - t0, t2 - t1, n

    m_k = build_model("ridge", nx, ny, nz)
    m_j = build_model("ridge", nx, ny, nz)
    t_k = advance(m_k)[0]
    jnp_only = lambda *a, mesh=None: mp_simple.mp_simple_jnp(*a)
    with mock.patch.object(mp_simple, "mp_simple", jnp_only):
        t_j = advance(m_j)[0]           # traced and compiled without it
    print(f"first interval incl. compile: kernel {t_k:.2f} s, "
          f"jnp {t_j:.2f} s", flush=True)

    rates = {"kernel": [], "jnp": []}
    for _ in range(args.reps):
        for name, m in (("kernel", m_k), ("jnp", m_j), ("jnp", m_j),
                        ("kernel", m_k)):
            dt, fetch, n = advance(m)
            rates[name].append(nx * ny * nz * n / dt)
            print(f"ridge interval {name}: {n} substeps in {dt:.4f} s = "
                  f"{rates[name][-1]:.6g} gp*steps/s (value fetch after "
                  f"block_until_ready {1e3 * fetch:.3f} ms)", flush=True)

    # the SB04 layer alone, on the spun-up kernel model's state
    s = m_k.state
    n_sub = int(m_k.last_n_substeps)
    dt = np.float32(args.interval / n_sub)
    fields = [s[k] for k in ("pressure", "potential_temperature", "exner",
                             "density", "water_vapor", "cloud_water",
                             "rain_mass", "snow_mass", "precipitation",
                             "snowfall")]
    dz = jax.device_put(np.asarray(m_k.geom.dz_interface, np.float32), dev)
    kern = jax.jit(lambda *a: sb04_kernel.mp_simple(*a[:10], a[10], a[11]))
    ref = jax.jit(mp_simple.mp_simple_jnp)
    layer = {"kernel": [], "jnp": []}
    fn = {"kernel": kern, "jnp": ref}
    for f in fn.values():
        jax.block_until_ready(f(*fields, dt, dz))
    for _ in range(args.reps):
        for name in ("kernel", "jnp", "jnp", "kernel"):
            t0 = time.perf_counter()
            for _ in range(5):
                res = fn[name](*fields, dt, dz)
            jax.block_until_ready(res)
            layer[name].append((time.perf_counter() - t0) / 5 * 1e3)
            print(f"sb04 layer {name}: {layer[name][-1]:.4f} ms/call "
                  f"(dt {dt:.3f} s)", flush=True)
    a, b = kern(*fields, dt, dz), ref(*fields, dt, dz)
    diff = {k: float(np.max(np.abs(np.asarray(x) - np.asarray(y)))
                     / max(float(np.max(np.abs(np.asarray(y)))), 1e-30))
            for k, x, y in zip(("theta", "qv", "qc", "qr", "qs", "rain",
                                "snow"), a, b)}
    print("layer max diff / scale:", diff, flush=True)
    print(f"median ridge: kernel {np.median(rates['kernel']):.6g}, "
          f"jnp {np.median(rates['jnp']):.6g} gp*steps/s; median layer: "
          f"kernel {np.median(layer['kernel']):.4f}, "
          f"jnp {np.median(layer['jnp']):.4f} ms", flush=True)


if __name__ == "__main__":
    main()

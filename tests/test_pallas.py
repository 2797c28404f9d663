"""The SB04 GPU kernel (ops/sb04_kernel.py) against the jnp reference.

The kernel is compiled only for the GPU; here it runs through the Pallas
interpreter (``interpret=True``) and is compared with the jnp scheme
(physics/mp_simple.py) it replaces. The per-cell arithmetic is the same op
for op, so the two agree to a few float32 ulp: XLA may contract a multiply
and an add into one FMA in one compilation and not in the other.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from icar_tpu.ops import sb04_kernel as sk
from icar_tpu.physics import mp_simple

NAMES = ("theta", "qv", "qc", "qr", "qs", "rain", "snow")


def assert_ulp_equal(got, want, msg, rtol=5e-6, atol=1e-8):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


def _fields(seed, nz=10, ny=9, nx=17):
    r = np.random.default_rng(seed)
    z = np.cumsum(np.full(nz, 300.0)) - 150.0
    p = (101325.0 * np.exp(-z / 8000.0))[:, None, None] * np.ones((nz, ny, nx))
    t = (288.0 - 0.0065 * z)[:, None, None] + r.uniform(-10, 10, (nz, ny, nx))
    es = 610.78 * np.exp(17.27 * (t - 273.16) / (t - 35.86))
    qvs = 0.622 * es / (p - es)
    qv = qvs * r.uniform(0.2, 1.5, (nz, ny, nx))
    qc = np.where(r.uniform(size=t.shape) < 0.5,
                  r.uniform(0, 1e-3, t.shape), 0.0)
    f = lambda a: jnp.asarray(a, jnp.float32)
    return f(p), f(t), f(qv), f(qc)


def _scheme_inputs(seed, nz=10, ny=9, nx=17, rain=True, snow=True):
    p, t, qv, qc = _fields(seed, nz, ny, nx)
    r = np.random.default_rng(seed + 1)
    shape = p.shape

    def hydro(on):
        if not on:
            return jnp.zeros(shape, jnp.float32)
        return jnp.asarray(np.where(r.uniform(size=shape) < 0.4,
                                    r.uniform(0, 5e-4, shape), 0.0),
                           jnp.float32)

    qr, qs = hydro(rain), hydro(snow)
    exner = (p / 100000.0) ** np.float32(0.2857)
    theta = t / exner
    rho = p / (np.float32(287.0) * t)
    acc_r = jnp.asarray(r.uniform(0, 3, shape[1:]), jnp.float32)
    acc_s = jnp.asarray(r.uniform(0, 1, shape[1:]), jnp.float32)
    dz = jnp.asarray(np.full(shape, 250.0)
                     * r.uniform(0.6, 1.4, (nz, 1, 1)), jnp.float32)
    return p, theta, exner, rho, qv, qc, qr, qs, acc_r, acc_s, dz


def _kernel_scheme(args, dt, **kw):
    """mp_simple through the kernel, in interpret mode."""
    p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz = args
    return sk.mp_simple(p, theta, exner, rho, qv, qc, qr, qs, rain, snow,
                        dt, dz, interpret=True, **kw)


def _jnp_scheme(args, dt):
    p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz = args
    return mp_simple.mp_simple_jnp(p, theta, exner, rho, qv, qc, qr, qs,
                                   rain, snow, dt, dz)


def _compare(args, dt, label, **kw):
    got = _kernel_scheme(args, np.float32(dt), **kw)
    want = _jnp_scheme(args, np.float32(dt))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, f"{label}: {name} shape"
        assert_ulp_equal(g, w, f"{label}: kernel vs jnp on {name}",
                         rtol=1e-5, atol=1e-8)
    return got, want


def _level_call(fn, n_out, *arrays):
    """Run ``fn`` on per-level lists of one block's columns through a
    throwaway Triton-route pallas_call in interpret mode."""
    nz, ny, nx = arrays[0].shape
    ncol = ny * nx
    flat = [a.reshape(nz, ncol) for a in arrays]

    def kern(*refs):
        ins, outs = refs[:len(flat)], refs[len(flat):]
        res = fn([[r[k] for k in range(nz)] for r in ins])
        for o, v in zip(outs, res):
            for k in range(nz):
                o[k] = v[k]

    return pl.pallas_call(
        kern, backend="triton", interpret=True,
        out_shape=[jax.ShapeDtypeStruct((nz, ncol), jnp.float32)] * n_out,
    )(*flat)


def test_saturation_inline_bit_exact():
    """The kernel's saturation stage equals the jnp cloud_conversion
    (checked in isolation, one level per loop as in the kernel)."""
    p, t, qv, qc = _fields(3)

    def fn(levels):
        ps, ts, qvs, qcs = levels
        outs = [sk._saturation(*a) for a in zip(ps, ts, qvs, qcs)]
        return [list(o) for o in zip(*outs)]

    got = _level_call(fn, 4, p, t, qv, qc)
    want = mp_simple.cloud_conversion(p, t, qv, qc, 40.0)
    for name, g, w in zip(("t", "qv", "qc", "qvsat"), got, want):
        assert_ulp_equal(g.reshape(p.shape), w,
                         f"saturation stage {name} != jnp path")


@pytest.mark.parametrize("snow", [False, True])
def test_sediment_inline_bit_exact(snow):
    """The kernel's sedimentation stage equals the jnp _sediment_species
    (checked in isolation)."""
    r = np.random.default_rng(9)
    nz, ny, nx = 10, 7, 12
    p, t, qv, _ = _fields(9, nz, ny, nx)
    q = jnp.asarray(np.where(r.uniform(size=(nz, ny, nx)) < 0.6,
                             r.uniform(0, 8e-4, (nz, ny, nx)), 0.0),
                    jnp.float32)
    rho = jnp.asarray(r.uniform(0.7, 1.2, (nz, ny, nx)), jnp.float32)
    dz = jnp.asarray(np.full((nz, ny, nx), 150.0)
                     * r.uniform(0.6, 1.4, (nz, 1, 1)), jnp.float32)
    dt = np.float32(60.0)
    fall = mp_simple.SNOW_FALL_RATE if snow else mp_simple.RAIN_FALL_RATE
    evap_base = np.float32(0.93)
    l_heat = (lambda T: -mp_simple.LH_LIQUID
              - (mp_simple.LH_VAPOR + (373.15 - T) * mp_simple.DLHVDT)) \
        if snow else \
        (lambda T: -(mp_simple.LH_VAPOR + (373.15 - T) * mp_simple.DLHVDT))

    M = ny * nx
    flat = lambda a: a.reshape(nz, M)

    def kern(q_ref, qv_ref, t_ref, p_ref, rho_ref, dz_ref,
             q_o, qv_o, t_o, pr_o):
        named = {"p": p_ref, "rho": rho_ref, "dz": dz_ref}
        for k in range(nz):
            q_o[k], qv_o[k], t_o[k] = q_ref[k], qv_ref[k], t_ref[k]

        def load(ref, k):
            return (named[ref] if isinstance(ref, str) else ref)[k]

        def store(ref, k, v):
            ref[k] = v

        pr_o[0] = sk._sediment(q_o, qv_o, t_o, load, store, nz, dt, fall,
                               evap_base, snow)

    got = pl.pallas_call(
        kern, interpret=True, backend="triton",
        out_shape=[jax.ShapeDtypeStruct((nz, M), jnp.float32)] * 3
        + [jax.ShapeDtypeStruct((1, M), jnp.float32)],
    )(flat(q), flat(qv), flat(t), flat(p), flat(rho), flat(dz))
    want = mp_simple._sediment_species(q, qv, t, p, rho, dz, dt, fall,
                                       evap_base, l_heat)
    shapes = ((nz, ny, nx),) * 3 + ((ny, nx),)
    for name, g, w, s in zip(("q", "qv", "t", "precip"), got, want, shapes):
        assert_ulp_equal(g.reshape(s), w,
                         f"sediment stage {name} != jnp path (snow={snow})")


def test_mp_simple_pallas_path_matches_jnp():
    """End-to-end: the whole scheme through the kernel equals the jnp
    path, with the accumulators added as mp_simple adds them."""
    _compare(_scheme_inputs(13), 50.0, "mixed")


@pytest.mark.parametrize("nz,ny,nx,block", [
    (20, 9, 23, 128),     # nz=20 (the bench depth) is not a power of two
    (7, 5, 13, 32),       # 65 columns: two full blocks and one partial
    (3, 1, 1, 64),        # one column, mostly masked lanes
])
def test_kernel_odd_shapes_match_jnp(nz, ny, nx, block):
    _compare(_scheme_inputs(30 + nz, nz, ny, nx), 40.0,
             f"{nz}x{ny}x{nx}/block {block}", block=block)


def test_kernel_all_converged_is_identity_on_saturation():
    """A state already at saturation equilibrium with no hydrometeors:
    the saturation loop exits after one trip and no fall loop runs."""
    p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz = \
        _scheme_inputs(41, rain=False, snow=False)
    t = theta * exner
    args = (p, theta, exner, rho, 0.5 * mp_simple.sat_mr(t, p),
            jnp.zeros_like(qc), qr, qs, rain, snow, dz)
    got, _ = _compare(args, 30.0, "all-converged")
    np.testing.assert_array_equal(np.asarray(got[5]), np.asarray(rain))
    np.testing.assert_array_equal(np.asarray(got[6]), np.asarray(snow))


def test_kernel_non_converging_cells_revert():
    """Cells that stay active through all 15 trips revert to their entry
    state (the reference's diverging-iteration revert): near p ~ e_s the
    halving iteration cannot converge within 15 trips."""
    p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz = \
        _scheme_inputs(43)
    # grossly supersaturated cells: every trip halves an excess far above
    # MAXERR, so 15 trips cannot converge them
    qv = qv.at[:, :2, :3].set(2.0)
    args = (p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz)
    _, qv_k, qc_k = _kernel_scheme(args, np.float32(30.0))[:3]
    _, qv_j, qc_j = _jnp_scheme(args, np.float32(30.0))[:3]
    t0 = theta * exner
    reverted = np.asarray(mp_simple.sat_mr(t0, p))[:, :2, :3]
    assert_ulp_equal(qv_j[:, :2, :3], reverted, "jnp revert")
    assert_ulp_equal(qv_k[:, :2, :3], reverted, "kernel revert")
    _compare(args, 30.0, "revert")


@pytest.mark.parametrize("rain,snow", [(True, False), (False, True)])
def test_kernel_single_species_fall(rain, snow):
    """Rain-only and snow-only states: one fall loop runs, the other
    species' loop is skipped, in both paths."""
    args = _scheme_inputs(50 + rain, nz=12, ny=6, nx=11, rain=rain,
                          snow=snow)
    # cold enough aloft that the snow case keeps its snow
    got, _ = _compare(args, 60.0, f"rain={rain} snow={snow}")
    if rain:
        np.testing.assert_array_equal(np.asarray(got[6]),
                                      np.asarray(args[9]))


@pytest.mark.parametrize("platform,sharded,chosen", [
    ("gpu", False, "kernel"), ("gpu", True, "sharded"),
    ("cpu", False, "jnp"), ("cpu", True, "jnp"), ("cuda", False, "jnp")])
def test_kernel_chosen_only_on_gpu(monkeypatch, platform, sharded, chosen):
    """mp_simple's one dispatch: the kernel (per shard under a mesh) for
    a device whose platform is ``gpu``, the jnp scheme for any other."""
    from icar_tpu.core import state

    calls = []
    monkeypatch.setattr(sk, "mp_simple",
                        lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(sk, "mp_simple_sharded",
                        lambda *a, **k: calls.append("sharded"))
    monkeypatch.setattr(mp_simple, "mp_simple_jnp",
                        lambda *a: calls.append("jnp"))
    device = types.SimpleNamespace(platform=platform)
    mesh = None
    if sharded:
        mesh = types.SimpleNamespace(devices=np.array([device], object))
    else:
        monkeypatch.setattr(state, "compute_device", lambda: device)
    mp_simple.mp_simple(*([None] * 12), mesh=mesh)
    assert calls == [chosen]


def test_mp_simple_uses_jnp_off_gpu(monkeypatch):
    """On this backend mp_simple must not reach the kernel."""
    def boom(*a, **k):
        raise AssertionError("kernel called off the GPU")

    monkeypatch.setattr(sk, "mp_simple", boom)
    args = _scheme_inputs(60, nz=4, ny=3, nx=5)
    p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz = args
    mp_simple.mp_simple(p, theta, exner, rho, qv, qc, qr, qs, rain, snow,
                        np.float32(20.0), dz)


def test_kernel_lowers_for_cuda():
    """The kernel lowers through the Triton route for a CUDA target (the
    Pallas-to-Triton step runs here; the card compiles the result)."""
    args = _scheme_inputs(70, nz=20, ny=4, nx=40)
    p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz = args
    lowered = jax.jit(
        lambda *a: sk.mp_simple(*a[:10], np.float32(30.0), a[10])).trace(
        p, theta, exner, rho, qv, qc, qr, qs, rain, snow, dz).lower(
        lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "triton" in text and "sb04_microphysics" in text

"""Column physics and advection under a mesh vs a single device.

Sharded runs are GSPMD-partitioned jnp: the operators are the same
functions, with their inputs laid out over a ('y', 'x') mesh of virtual
devices, so XLA inserts the halo collectives the stencils need. The SB04
GPU kernel runs per shard through one shard_map (no halo: the scheme is
column-local), exercised here in interpret mode.
"""

import numpy as np

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from icar_tpu import constants as C
from icar_tpu.models.icar import ideal_ridge_model
from icar_tpu.ops import sb04_kernel
from icar_tpu.physics.mp_thompson import rslf


def _mesh(my, mx):
    return Mesh(np.array(jax.devices()[:my * mx]).reshape(my, mx),
                ("y", "x"))


def _gspmd(fn, mesh):
    """``fn`` with every array argument's two trailing dims laid out
    over ``mesh`` inside jit (uneven sizes are padded by GSPMD)."""
    def constrain(a):
        if not hasattr(a, "ndim") or a.ndim < 2:
            return a
        spec = P(*([None] * (a.ndim - 2) + ["y", "x"]))
        return jax.lax.with_sharding_constraint(a, NamedSharding(mesh, spec))

    def wrapped(*args):
        return fn(*jax.tree.map(constrain, args))
    return jax.jit(wrapped)


STACK_NAMES = ("potential_temperature", "water_vapor", "cloud_water",
               "cloud_ice", "rain_mass", "snow_mass", "graupel_mass",
               "ice_number", "rain_number")


def _mixed_stack(seed, nz=12, ny=21, nx=26):
    """Randomized mixed-regime columns as a 9-species Thompson stack."""
    r = np.random.default_rng(seed)
    dz = np.full((nz, ny, nx), 400.0, np.float32)
    z = np.cumsum(dz, axis=0) - 200.0
    p = (1e5 * np.exp(-z / 8000.0)).astype(np.float64)
    t_sfc = r.uniform(250.0, 300.0, (ny, nx))
    t = t_sfc[None] - 0.0065 * z + r.uniform(-3, 3, (nz, ny, nx))
    exner = (p / 1e5) ** (287.04 / 1004.0)
    qvs = np.asarray(rslf(jnp.asarray(p, jnp.float32),
                          jnp.asarray(t, jnp.float32)))
    qv = qvs * r.uniform(0.3, 1.3, (nz, ny, nx))

    def hydro(scale):
        q = r.uniform(0, scale, (nz, ny, nx))
        return np.where(r.uniform(size=q.shape) < 0.6, q, 0.0)

    f = lambda a: np.asarray(a, np.float32)
    stack = np.stack([f(t / exner), f(qv), f(hydro(1.5e-3)),
                      f(hydro(3e-4)), f(hydro(1e-3)), f(hydro(8e-4)),
                      f(hydro(5e-4)), f(hydro(1e6)), f(hydro(5e6))])
    return (jnp.asarray(stack), jnp.asarray(exner, jnp.float32),
            jnp.asarray(p, jnp.float32), jnp.asarray(dz))


def _frac_close(name, g, w, tight=1e-4, tight_frac=0.02,
                flip_frac=0.002):
    """Fractional tolerance: another partitioning fuses the float32
    arithmetic differently, so cells at a process threshold can flip
    branch."""
    g, w = np.asarray(g), np.asarray(w)
    atol = 1e-12 + 1e-6 * float(np.abs(w).max())
    rel = np.abs(g - w) / (np.abs(w) + atol)
    assert float(np.mean(rel > tight)) < tight_frac, \
        f"{name}: bulk tolerance exceeded (max rel {rel.max():.2e})"
    assert float(np.mean(rel > 1e-2)) <= flip_frac, \
        f"{name}: too many branch flips"


def test_thompson_stack_sharded_equiv():
    from icar_tpu.physics.mp_thompson import mp_thompson_stack
    from icar_tpu.physics.thompson_tables import ThompsonParams

    qstack, exner, p, dz = _mixed_stack(3)
    ny, nx = p.shape[1:]
    acc = jnp.zeros((ny, nx), jnp.float32)
    params = ThompsonParams()

    def run(qstack, exner, p, dz, acc):
        return mp_thompson_stack(qstack, STACK_NAMES, exner, p, dz, 60.0,
                                 acc, acc, acc, params=params)

    want = jax.jit(run)(qstack, exner, p, dz, acc)
    got = _gspmd(run, _mesh(2, 2))(qstack, exner, p, dz, acc)
    for n, g, w in zip(("stack", "rain", "snow", "graupel"), got, want):
        _frac_close(n, g, w)


def test_mp_simple_sharded_equiv():
    """The per-shard SB04 kernel (interpret mode) on a 2x2 mesh with a
    domain that does not divide it, against the jnp scheme."""
    from icar_tpu.physics.mp_simple import mp_simple_jnp

    qstack, exner, p, dz = _mixed_stack(5, ny=19, nx=23)
    theta, qv, qc, qr, qs = (qstack[i] for i in (0, 1, 2, 4, 5))
    rho = p / (287.058 * theta * exner)
    ny, nx = p.shape[1:]
    rain = jnp.zeros((ny, nx), jnp.float32) + 0.5
    snow = jnp.zeros((ny, nx), jnp.float32) + 0.1
    want = mp_simple_jnp(p, theta, exner, rho, qv, qc, qr, qs, rain, snow,
                         40.0, dz)
    got = sb04_kernel.mp_simple_sharded(
        _mesh(2, 2), p, theta, exner, rho, qv, qc, qr, qs, rain, snow,
        np.float32(40.0), dz, interpret=True)
    names = ("theta", "qv", "qc", "qr", "qs", "rain", "snow")
    for n, g, w in zip(names, got, want):
        assert g.shape == w.shape, n
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-8, err_msg=n)


@pytest.mark.parametrize("shards", [(2, 2), (1, 4), None])
def test_step_sb04_kernel_matches_jnp_step(monkeypatch, shards):
    """The interval step with the SB04 kernel inside it (interpret mode;
    per shard through the shard_map under a mesh, as on a GPU mesh, with
    the step's traced dt) against the unsharded step with the jnp
    scheme, on a domain the mesh does not divide, with cross-shard
    flow."""
    import functools

    from icar_tpu.forcing.ideal import make_ideal_case
    from icar_tpu.physics import mp_simple

    kw = dict(nx=23, ny=19, nz=8, dx=1000.0, hill_height=800.0,
              u_speed=10.0, rh=1.0, mp=C.MP_SIMPLE, flat_z_height=-2)

    def model():
        m = ideal_ridge_model(**kw)
        m.set_initial_conditions(make_ideal_case(
            m.geom, u_profile=10.0, v_profile=4.0, rh=1.0))
        return m

    ref = model()
    ref.advance(600.0)
    meshes = []
    kernel = functools.partial(mp_simple.mp_simple, interpret=True)

    def traced(*a, mesh=None):
        meshes.append(mesh)
        return kernel(*a, mesh=mesh)

    monkeypatch.setattr(mp_simple, "mp_simple", traced)
    m = model()
    if shards is not None:
        m.attach_mesh(_mesh(*shards))
    m.advance(600.0)
    assert meshes and all(x is m.mesh for x in meshes)
    assert int(m.last_n_substeps) == int(ref.last_n_substeps)
    for k in ("potential_temperature", "water_vapor", "cloud_water",
              "rain_mass", "snow_mass", "precipitation"):
        a, b = ref.field(k), m.field(k)
        assert b.shape == a.shape, k
        np.testing.assert_allclose(
            b, a, rtol=1e-5, atol=1e-6 * max(float(np.abs(a).max()), 1e-9),
            err_msg=f"kernel step diverges on {k}")
    assert float(np.abs(ref.field("cloud_water")).max()) > 0.0


def _advect_operands(adv=C.ADV_UPWIND, mp=C.MP_SIMPLE, ny=32, nx=48):
    m = ideal_ridge_model(nx=nx, ny=ny, nz=10, dx=1000.0,
                          hill_height=700.0, u_speed=10.0, rh=1.0,
                          mp=mp, adv=adv)
    from icar_tpu.forcing.ideal import make_ideal_case
    case = make_ideal_case(m.geom, u_profile=10.0, v_profile=4.0, rh=1.0)
    m.set_initial_conditions(case)
    s = m.state
    g = m.geom
    stack = jnp.stack([s[k] for k in m.advect_names])
    # drop a hydrometeor blob in so non-theta species advect nontrivially
    r = np.random.default_rng(0)
    blob = jnp.asarray(np.where(r.uniform(size=stack.shape) < 0.3,
                                1e-3, 0.0), jnp.float32)
    stack = stack + blob
    args = (s["u"], s["v"], s["w"], 20.0, g.dx,
            jnp.asarray(g.jacobian_u), jnp.asarray(g.jacobian_v),
            jnp.asarray(g.jacobian_w), jnp.asarray(g.jacobian),
            jnp.asarray(g.advection_dz))
    return m, stack, args


@pytest.mark.parametrize("my,mx", [(2, 2), (1, 4)])
def test_advect_upwind_sharded_equiv(my, mx):
    from icar_tpu.ops.advection import advect_upwind

    m, stack, (u, v, w, dt, dx, ju, jv, jw, jc, dz) = _advect_operands()
    floors = np.asarray([0.0 if k != "potential_temperature" else -np.inf
                         for k in m.advect_names], np.float32)

    def run(stack, u, v, w, ju, jv, jw, jc, dz):
        return advect_upwind(stack, u, v, w, dt, dx, ju, jv, jw, jc, None,
                             dz, floors=floors, near_end=jnp.float32(1.0))

    args = (stack, u, v, w, ju, jv, jw, jc, dz)
    want = jax.jit(run)(*args)
    got = _gspmd(run, _mesh(my, mx))(*args)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-6, atol=1e-9,
        err_msg=f"sharded upwind diverges on {my}x{mx} mesh")


def test_advect_mpdata_sharded_equiv():
    from icar_tpu.ops.mpdata import advect_mpdata

    m, stack, (u, v, w, dt, dx, ju, jv, jw, jc, dz) = _advect_operands(
        adv=C.ADV_MPDATA, mp=C.MP_THOMPSON)

    def run(stack, u, v, w, ju, jv, jw, jc, dz):
        return advect_mpdata(stack, u, v, w, dt, dx, ju, jv, jw, jc, None,
                             dz, order=2, use_fct=True)

    args = (stack, u, v, w, ju, jv, jw, jc, dz)
    want = jax.jit(run)(*args)
    got = _gspmd(run, _mesh(4, 1))(*args)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-8,
        err_msg="sharded MPDATA diverges")


def test_sharded_step_mpdata_thompson_e2e():
    """End-to-end: the sharded interval step (padded frame) of an
    MPDATA+Thompson model matches the unsharded step."""
    kw = dict(nx=32, ny=32, nz=8, dx=1000.0, hill_height=500.0,
              u_speed=10.0, rh=1.0, mp=C.MP_THOMPSON, adv=C.ADV_MPDATA,
              flat_z_height=-2)
    m1 = ideal_ridge_model(**kw)
    m2 = ideal_ridge_model(**kw)
    m2.attach_mesh(_mesh(4, 1))
    m1.advance(300.0)
    m2.advance(300.0)
    assert int(m1.last_n_substeps) == int(m2.last_n_substeps)
    for k in ("potential_temperature", "water_vapor", "cloud_water",
              "rain_mass", "snow_mass", "precipitation"):
        a = np.asarray(m1.field(k))
        b = np.asarray(m2.field(k))
        np.testing.assert_allclose(
            b, a, rtol=1e-5, atol=1e-6 * max(float(np.abs(a).max()), 1e-9),
            err_msg=f"sharded step diverges on {k}")

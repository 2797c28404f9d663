"""The sharded ridge interval (upwind + SB04) vs the single-device one.

The ideal-ridge configuration runs the general interval step under a
('y', 'x') mesh of virtual devices: fields live in the uniform padded
frame (parallel/mesh.py), GSPMD partitions the stencils and inserts their
halo exchanges, and the CFL dt is a global reduction, so the substep count
matches the single-device run exactly and the fields agree to float32
fusion-order tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from icar_tpu.core.step import make_step_fn
from icar_tpu.models.icar import ideal_ridge_model

PROGNOSTICS = ("potential_temperature", "water_vapor", "cloud_water",
               "rain_mass", "snow_mass")


def _ymesh(n):
    return Mesh(np.array(jax.devices()[:n]).reshape(n, 1), ("y", "x"))


def _mesh2d(my, mx):
    return Mesh(np.array(jax.devices()[:my * mx]).reshape(my, mx),
                ("y", "x"))


def _models(ny=40, n_shards=4, mesh=None, nx=64, v_speed=None):
    kw = dict(nx=nx, ny=ny, nz=12, dx=1000.0, hill_height=800.0,
              u_speed=11.0, rh=1.0)
    m1 = ideal_ridge_model(**kw)
    m2 = ideal_ridge_model(**kw)
    if v_speed is not None:
        # nonzero cross-shard y-flow: the ridge case is constant in y, so
        # with v == 0 every halo value is multiplied by zero winds — a
        # wrong halo row would pass
        from icar_tpu.forcing.ideal import make_ideal_case
        for m in (m1, m2):
            case = make_ideal_case(m.geom, u_profile=11.0,
                                   v_profile=v_speed, rh=1.0)
            m.set_initial_conditions(case)
    m2.attach_mesh(mesh if mesh is not None else _ymesh(n_shards))
    return m1, m2


def _step_pair(m1, m2, end, dq1=None, dq2=None):
    forced = dq1 is not None
    fn1 = make_step_fn(m1.options, m1.geom, m1.advect_names, forced)
    fn2 = make_step_fn(m2.options, m2.geom, m2.advect_names, forced,
                       mesh=m2.mesh, natural_shapes=m2._natural_shapes)
    s1, _, n1 = fn1({k: jnp.array(v) for k, v in m1.state.items()},
                    dq1 or {}, jnp.float32(0.0), jnp.float32(end),
                    m1._time_aux(), m1.geom_args())
    s2, _, n2 = fn2({k: jnp.array(v) for k, v in m2.state.items()},
                    dq2 or {}, jnp.float32(0.0), jnp.float32(end),
                    m2._time_aux(), m2.geom_args())
    assert int(n1) == int(n2), "sharded substep count differs"
    return s1, s2, int(n1)


def _assert_match(s1, s2, names, label):
    for k in names:
        a = np.asarray(s1[k])
        b = np.asarray(s2[k])[..., :a.shape[-2], :a.shape[-1]]
        scale = max(float(np.abs(a).max()), 1e-12)
        np.testing.assert_allclose(
            b, a, rtol=1e-5, atol=1e-6 * scale,
            err_msg=f"{label}: sharded step diverges on {k}")


@pytest.mark.parametrize("n_shards", [4, 3])
def test_sharded_fast_path_bit_exact(n_shards):
    m1, m2 = _models(n_shards=n_shards)
    s1, s2, n = _step_pair(m1, m2, 1800.0)
    assert n >= 5
    _assert_match(s1, s2, PROGNOSTICS + ("precipitation", "snowfall"),
                  f"{n_shards}-shard y mesh")


@pytest.mark.parametrize("my,mx,ny,nx,v", [
    (2, 2, 40, 64, 6.0),      # 2D mesh, cross-shard flow on BOTH axes
    (1, 4, 32, 64, 0.0),      # x-only decomposition
    (2, 2, 32, 128, 6.0),     # nx a multiple of the mesh: no pad columns
])
def test_sharded_fast_path_2d_mesh_bit_exact(my, mx, ny, nx, v):
    """2D (y AND x decomposed) meshes, the shape make_mesh produces for
    square domains."""
    m1, m2 = _models(ny=ny, nx=nx, mesh=_mesh2d(my, mx),
                     v_speed=(v or None))
    s1, s2, n = _step_pair(m1, m2, 1200.0)
    assert n >= 4
    if v:
        # the flow must actually cross shard boundaries for this test to
        # exercise the halos
        assert float(jnp.max(jnp.abs(s1["v"]))) > 1.0
    _assert_match(s1, s2, PROGNOSTICS + ("precipitation", "snowfall"),
                  f"{my}x{mx} mesh")


def test_sharded_fast_path_cross_flow_y_mesh():
    """y-mesh with nonzero v: real cross-shard y-fluxes cross the halo
    rows every substep."""
    m1, m2 = _models(ny=40, n_shards=4, v_speed=5.0)
    s1, s2, n = _step_pair(m1, m2, 1200.0)
    assert n >= 4
    assert float(jnp.max(jnp.abs(s1["v"]))) > 1.0
    _assert_match(s1, s2, PROGNOSTICS, "cross-flow y mesh")


def test_sharded_fast_path_with_forcing():
    """Boundary-ring forcing relaxation of an advected species under the
    mesh: the ring must be the GLOBAL domain boundary."""
    m1, m2 = _models(ny=32, n_shards=4)
    tq = np.zeros((12, 32, 64), np.float32) + 1e-7
    from icar_tpu.parallel.mesh import pad_field
    nyp, nxp = m2._padded_sizes
    s1, s2, _ = _step_pair(
        m1, m2, 900.0, {"water_vapor": jnp.asarray(tq)},
        {"water_vapor": jnp.asarray(pad_field(tq, nyp, nxp))})
    _assert_match(s1, s2, PROGNOSTICS, "forced")


def test_model_advance_uses_sharded_fast_path():
    """End-to-end: a y-mesh ridge model advances and matches the
    unsharded model."""
    m1, m2 = _models(ny=32, n_shards=2)
    m1.advance(1200.0)
    m2.advance(1200.0)
    assert int(m1.last_n_substeps) == int(m2.last_n_substeps)
    for k in ("cloud_water", "precipitation"):
        np.testing.assert_allclose(
            np.asarray(m1.field(k)), np.asarray(m2.field(k)),
            rtol=1e-5, atol=1e-9, err_msg=k)

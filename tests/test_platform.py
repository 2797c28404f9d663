"""Where the program runs: the compile cache, the CLI's device, the bench's
peak table, and the kernel on the card.

The last test needs an NVIDIA GPU: it carries the ``gpu`` marker and
skips elsewhere (run it with ``JAX_PLATFORMS=cuda,cpu python -m pytest
tests/ -m gpu``).
"""

import os
import types

import numpy as np
import pytest

import icar_tpu


def test_cache_honours_env_dir():
    """With JAX_COMPILATION_CACHE_DIR set, the package sets no cache
    directory of its own (JAX reads the variable itself)."""
    env = {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}
    assert icar_tpu.compilation_cache_dir(env, "cuda") is None
    assert icar_tpu.compilation_cache_dir(env, "") is None


@pytest.mark.parametrize("platforms", ["", "cuda", "cuda,cpu"])
def test_cache_default_is_fixed_in_checkout(platforms):
    path = icar_tpu.compilation_cache_dir({}, platforms)
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        icar_tpu.__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert path == icar_tpu.DEFAULT_CACHE_DIR


def test_cache_skipped_on_cpu_only_sessions():
    assert icar_tpu.compilation_cache_dir({}, "cpu") is None


def test_cli_reports_device_and_has_no_fallback(monkeypatch):
    """The CLI names the device it runs on, and a backend that fails to
    start fails the run — there is no quiet fallback to the CPU."""
    import jax

    from icar_tpu.core import driver
    assert not hasattr(driver, "_ensure_backend")

    def no_backend(*a, **k):
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "devices", no_backend)
    with pytest.raises(RuntimeError, match="Unable to initialize"):
        driver.main(["options.nml"])


def test_cli_prints_platform(capsys, tmp_path):
    from icar_tpu.core import driver
    with pytest.raises(FileNotFoundError):
        driver.main([str(tmp_path / "missing.nml")])
    out = capsys.readouterr().out
    assert "running on cpu (cpu), 8 device(s)" in out


def test_cli_usage_without_options(capsys):
    from icar_tpu.core import driver
    assert driver.main([]) == 1
    assert driver.main(["x.nml", "--profile"]) == 1
    assert "usage" in capsys.readouterr().out


def _device(kind):
    return types.SimpleNamespace(device_kind=kind, platform="gpu")


def test_peak_table_knows_the_h100():
    import bench
    assert bench.peak_for(_device("NVIDIA H100 80GB HBM3")) == 3350.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe"])
def test_peak_table_raises_on_unknown_kind(kind):
    import bench
    with pytest.raises(KeyError, match="no published bandwidth"):
        bench.peak_for(_device(kind))


@pytest.fixture()
def gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return jax.devices()[0]


@pytest.mark.gpu
def test_sb04_kernel_compiled_matches_jnp(gpu):
    """The SB04 kernel as compiled for the card against the jnp scheme
    on the card (chip_smoke.py makes the same check at full width)."""
    import jax.numpy as jnp

    from icar_tpu.ops import sb04_kernel
    from icar_tpu.physics import mp_simple

    r = np.random.default_rng(1)
    nz, ny, nx = 20, 37, 53
    z = np.cumsum(np.full(nz, 400.0)) - 200.0
    p = (101325.0 * np.exp(-z / 8000.0))[:, None, None] * np.ones((nz, ny, nx))
    t = (288.0 - 0.0065 * z)[:, None, None] + r.uniform(-5, 5, p.shape)
    exner = (p / 1e5) ** 0.2857
    f = lambda a: jnp.asarray(a, jnp.float32)
    args = [f(p), f(t / exner), f(exner), f(p / (287.0 * t)),
            f(np.full(p.shape, 8e-3)), f(r.uniform(0, 1e-3, p.shape)),
            f(r.uniform(0, 5e-4, p.shape)), f(r.uniform(0, 5e-4, p.shape)),
            f(np.zeros((ny, nx))), f(np.zeros((ny, nx)))]
    dz = f(np.full(p.shape, 400.0))
    got = sb04_kernel.mp_simple(*args, np.float32(30.0), dz)
    want = mp_simple.mp_simple_jnp(*args, np.float32(30.0), dz)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        scale = float(np.abs(w).max()) or 1.0
        assert float(np.mean(np.abs(g - w) > 1e-5 * scale)) <= 1e-3

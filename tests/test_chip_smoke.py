"""chip_smoke.py's device gate and the compile-cache rule on the CPU, and
its GPU phases as ``gpu``-marked tests (they skip without a GPU)."""

import os

import pytest

import chip_smoke
from oddio_tpu.utils import cache


def test_device_phase_exits_nonzero_on_cpu():
    """No GPU: the smoke test stops with a message, never falls back."""
    with pytest.raises(SystemExit) as e:
        chip_smoke.phase_device()
    assert e.value.code not in (0, None)
    assert "GPU" in str(e.value.code)


@pytest.mark.parametrize("env", [None, "/data/jax-cache"])
def test_compile_cache_dir_rule(env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache lives
    at one fixed path inside the checkout."""
    environ = {} if env is None else {"JAX_COMPILATION_CACHE_DIR": env}
    got = cache.compile_cache_dir(environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == (env or os.path.join(root, ".jax_cache"))


def test_use_compile_cache_sets_nothing_when_env_set(monkeypatch):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/data/jax-cache")
    cache.use_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.gpu
def test_golden_scenes_on_gpu(gpu):
    chip_smoke.phase_golden()


@pytest.mark.gpu
def test_full_width_scenes_on_gpu(gpu):
    chip_smoke.phase_full_width()


@pytest.mark.gpu
def test_ring_read_kernel_on_gpu(gpu):
    chip_smoke.phase_ring_read()

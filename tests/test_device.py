"""Compile-cache placement and device naming (utils/device.py)."""

import os

import jax
import pytest

from opencl_montecarlo_path_tracing_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore JAX's cache directory after the test."""
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_cache_env_set_is_left_to_jax(monkeypatch, cache_config, tmp_path):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None   # nothing set


def test_cache_env_unset_uses_checkout_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.configure_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_cache_dir_is_fixed_and_ignored(monkeypatch, cache_config):
    """The same path on every call (the path is part of the cache key),
    and git never commits it."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert device.configure_compile_cache() == device.configure_compile_cache()
    with open(os.path.join(REPO, ".gitignore")) as fp:
        assert ".jax_cache/" in fp.read().split()


def test_device_info_names_the_device():
    info = device.device_info()
    assert info["platform"] == "cpu"
    assert info["count"] == len(jax.devices())
    assert set(info) == {"platform", "kind", "count", "card"}

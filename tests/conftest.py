"""Test config: force CPU JAX with a virtual 8-device mesh.

Multi-chip hardware is unavailable in CI; sharding tests run on a
host-platform mesh (SURVEY.md section 4 implication (4)).
"""
import os

# JAX_PLATFORMS=cpu from the environment, JAX_PLATFORM_NAME and the config
# update below all pin the CPU backend.
os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REFERENCE_DIR = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_DIR)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound accumulated in-process XLA executables: with ~196 tests in
    one process the LAST compile segfaulted twice inside XLA:CPU
    backend_compile_and_load (reproducible near the end of the suite,
    125 GB free RAM, any-order tail tests pass standalone - a
    long-lived-JIT native bug, not a test bug).  Dropping the jit cache
    per MODULE keeps the executable count bounded; modules re-compile
    their own programs anyway."""
    yield
    import jax
    jax.clear_caches()

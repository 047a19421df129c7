"""Subprocess worker for the 2-process jax.distributed test
(tests/test_multihost.py).  argv: process_id num_processes port out_path.

Each process owns 2 virtual CPU devices (XLA_FLAGS set by the parent);
jax.distributed wires them into one 4-device global set, and the stock
spp-sharded renderer runs over the GLOBAL mesh - the same code path a
multi-host launch uses (parallel/multihost.py docstring)."""

import sys

import numpy as np
import jax

# the workers run on the CPU whatever accelerator the host has
jax.config.update("jax_platforms", "cpu")


def main():
    pid, nproc, port, out_path = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    from opencl_montecarlo_path_tracing_tpu.parallel import multihost
    multihost.initialize(coordinator_address=f"localhost:{port}",
                         num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 2 * nproc, jax.device_count()
    # idempotent: a second call must be a clean no-op
    multihost.initialize(coordinator_address=f"localhost:{port}",
                         num_processes=nproc, process_id=pid)

    from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        make_spp_mesh, render_super_sharded)
    from tests.test_render_super import small_scene

    scene = small_scene()
    film = render_super_sharded(make_key(31), scene, 8, 8,
                                spp=jax.device_count(),
                                mesh=make_spp_mesh())
    film = np.asarray(film)
    if multihost.is_primary():
        np.save(out_path, film)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()

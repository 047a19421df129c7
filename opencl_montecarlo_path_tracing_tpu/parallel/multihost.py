"""Multi-host launch support.

The reference is strictly single-process/single-device (one in-order
cl_command_queue, ocl_boiler.h:150).  The rebuild's multi-host story is the
standard JAX one: every host runs the same program, `jax.distributed`
wires the hosts into one global device set, and the SPMD renderers in
parallel/mesh.py work unchanged because they only consume a Mesh built
from ``jax.devices()`` (all devices, across hosts).

Typical launch (one process per host):

    from opencl_montecarlo_path_tracing_tpu.parallel import multihost, mesh
    multihost.initialize("host0:1234", num_processes=2, process_id=0)
    m = mesh.make_spp_mesh()                # global mesh over all devices
    film = mesh.render_super_sharded(key, scene, 1024, 1024, 4096, m)
    # film is replicated; host 0 writes the PAM file

The film psum rides NVLink between the cards of one host and the network
across hosts; there are no other collectives in the pipeline (SURVEY.md
section 2.11 table, last row).  A cluster with no environment that JAX
can read needs the explicit coordinator address, process count and id.
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize with explicit or env-driven parameters.

    No-op when already initialized.  With no arguments (env-driven mode) a
    missing-environment ValueError is also swallowed - that is the normal
    single-process case.  With EXPLICIT arguments every failure propagates:
    a wrong coordinator address or process id must not silently degrade a
    multi-host launch to N independent single-process renders."""
    if jax.distributed.is_initialized():
        return  # idempotent (works even after the backend came up)
    env_driven = (coordinator_address is None and num_processes is None
                  and process_id is None)
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        # env-driven mode also tolerates the backend-order guard ("must be
        # called before any JAX calls") - that is the normal call pattern
        # for a single-process session that already touched the backend
        if not env_driven and "already initialized" not in str(e).lower():
            raise
    except ValueError:
        if not env_driven:
            raise


def is_primary() -> bool:
    return jax.process_index() == 0

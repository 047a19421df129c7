"""Multi-host rendering is real: 2 OS processes, jax.distributed, one
global 4-device mesh, films match the single-process render.

The reference is strictly single-process (one cl_command_queue,
ocl_boiler.h:150); this pins the rebuild's pod-launch story
(parallel/multihost.py) end to end without multi-host hardware."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]



def test_two_process_distributed_render(tmp_path):
    nproc = 2
    port = _free_port()
    out = tmp_path / "film.npy"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORM_NAME"] = "cpu"
    # append to the caller's PYTHONPATH, never overwrite it
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port),
             str(out)],
            env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nproc)
    ]
    logs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=540)
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log}"
    assert out.exists(), "primary process wrote no film"

    film = np.load(out)
    # reference result in THIS process (8 virtual devices, plain jit)
    from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu.models.super import render_super
    from tests.test_render_super import small_scene
    single = np.asarray(render_super(make_key(31), small_scene(), 8, 8,
                                     spp=4))
    np.testing.assert_allclose(film, single, rtol=0, atol=2e-3)


def test_initialize_explicit_bad_args_raise():
    """Explicit-arg failures must propagate (no silent single-process
    degradation); see parallel/multihost.py::initialize."""
    from opencl_montecarlo_path_tracing_tpu.parallel import multihost
    # num_processes without coordinator_address is invalid (ValueError);
    # in a process whose backend is already up it is the backend-order
    # guard (RuntimeError) - either way it must NOT be swallowed
    with pytest.raises((ValueError, RuntimeError)):
        multihost.initialize(coordinator_address=None, num_processes=2,
                             process_id=0)

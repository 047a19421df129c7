"""Benchmark: every integrator at its standard configuration, one device.

Renders each variant and reports camera-path throughput (Mpaths/s) with
the device it ran on: JAX's platform, device kind and device count, and
the card's name and power limit as nvidia-smi reports them (a card set
below its maximum power runs slower under load).  Default mode (and
BENCH_VARIANT=all) prints one JSON line per row, with the headline
``super`` row (the demo scene at 1024^2 x 1024 spp) LAST.  The process
exits nonzero if any row crashed.

BENCH_VARIANT=<name> runs a single row.  Env knobs: BENCH_SIZE /
BENCH_SPP (override the per-row config), BENCH_REPEATS (default 3),
BENCH_BUDGET_S (wall-clock budget for the non-headline rows, default
3000; 0 disables).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# standard (size, spp) per row (PERF.md, Cells).  Insertion order is run
# order; "super" (the headline) must stay LAST.
STD_CONFIG = {
    "simple": (1024, 256),
    "nodof": (512, 64),
    "bidirectional": (512, 256),
    "metropolis": (512, 256),
    "metropolis_vlpgrid": (512, 256),
    "trianglegrid": (512, 64),
    "super_largemesh": (512, 4),
    "super_stream": (512, 4),
    "bidirectional_dense": (512, 256),
    "super_sharded": (1024, 1024),
    "super": (1024, 1024),
}


def make_render(variant: str, scene, size: int, spp: int):
    """Returns render(key) -> film/image for one variant at (size, spp)."""
    if variant == "super":
        from opencl_montecarlo_path_tracing_tpu.models.super import render_super
        return lambda k: render_super(k, scene, size, size, spp=spp)
    if variant == "super_largemesh":
        from opencl_montecarlo_path_tracing_tpu.models.super import render_super
        from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
            large_mesh_scene)
        big = large_mesh_scene()
        return lambda k: render_super(k, big, size, size, spp=spp)
    if variant == "super_stream":
        # 2*512*256 = 262144 triangles: four times the reference's
        # MAX_TRIANGLES (trianglegrid CLSuperPathTracer.c:15)
        from opencl_montecarlo_path_tracing_tpu.models.super import render_super
        from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
            large_mesh_scene)
        big = large_mesh_scene(n_major=512, n_minor=256)
        return lambda k: render_super(k, big, size, size, spp=spp)
    if variant == "super_sharded":
        # the SHARDED program on a 1-device mesh: same headline workload,
        # but through shard_map (per-device spp window + film psum) - the
        # composition the multi-device path depends on (sharded ==
        # unsharded film is checked by chip_smoke.py --devices 4)
        from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
            make_spp_mesh, render_super_sharded)
        mesh = make_spp_mesh(1)
        return lambda k: render_super_sharded(k, scene, size, size, spp,
                                              mesh)
    if variant == "simple":
        from opencl_montecarlo_path_tracing_tpu.models.simple import render_simple
        return lambda k: render_simple(k, size, size, spp=spp)
    if variant == "nodof":
        from opencl_montecarlo_path_tracing_tpu.models.sample_parallel import (
            render_sample_parallel)
        sg = max(2, int(round(spp ** 0.5)))
        return lambda k: render_sample_parallel(k, scene, size, size,
                                                sample_grid=sg)
    if variant == "trianglegrid":
        # the reference grid variant exists to accelerate TraceRay over a
        # big mesh (trianglegrid pathtracer.ocl:157-198, MAX_TRIANGLES
        # 65536), so the row renders the VISIBLE 20k ripple sheet through
        # the uniform-grid DDA (ops/grid.py)
        from opencl_montecarlo_path_tracing_tpu.models.trianglegrid import (
            render_trianglegrid)
        from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
            large_mesh_scene)
        big = large_mesh_scene()
        return lambda k: render_trianglegrid(k, big, size, size, spp=spp)
    if variant == "bidirectional":
        from opencl_montecarlo_path_tracing_tpu.models.bidirectional import (
            render_bidirectional)
        return lambda k: render_bidirectional(k, scene, size, size, spp=spp)
    if variant == "bidirectional_dense":
        from opencl_montecarlo_path_tracing_tpu.models.bidirectional import (
            render_bidirectional)
        from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
            dense_vlp_scene)
        dense = dense_vlp_scene()
        return lambda k: render_bidirectional(k, dense, size, size, spp=spp)
    if variant in ("metropolis", "metropolis_vlpgrid"):
        from opencl_montecarlo_path_tracing_tpu.models.metropolis import (
            render_metropolis)
        grid = variant.endswith("vlpgrid")
        return lambda k: render_metropolis(k, scene, size, size, spp=spp,
                                           use_grid=grid)
    raise SystemExit(f"unknown BENCH_VARIANT {variant}")


def spp_of(variant: str, spp: int) -> int:
    """Effective paths-per-pixel (nodof's sample grid is spp rounded to a
    square)."""
    if variant == "nodof":
        sg = max(2, int(round(spp ** 0.5)))
        return sg * sg
    return spp


def spp_of(variant: str, spp: int) -> int:
    """Effective paths-per-pixel (nodof's sample grid is spp rounded to a
    square)."""
    if variant == "nodof":
        sg = max(2, int(round(spp ** 0.5)))
        return sg * sg
    return spp


def bench_one(variant: str, scene, tag: str, size: int, spp: int,
              repeats: int, device: dict | None = None) -> dict:
    import jax
    from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu.utils.device import device_info

    device = device or device_info()
    render = make_render(variant, scene, size, spp)
    # compile + warm up (same static config as the timed runs)
    t0 = time.perf_counter()
    jax.block_until_ready(render(make_key(0)))
    first = time.perf_counter() - t0

    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        film = jax.block_until_ready(render(make_key(1 + i)))
        times.append(time.perf_counter() - t0)
    best = min(times)
    paths = size * size * spp_of(variant, spp)
    return {
        "metric": f"{variant}_pathtracer_throughput",
        "value": round(paths / best / 1e6, 2),
        "unit": "Mpaths/s",
        "config": f"{size}x{size} spp={spp_of(variant, spp)} scene={tag}",
        "render_s": best,
        "first_call_s": first,
        "film_mean": round(float(np.asarray(film, np.float64).mean()), 4),
        "platform": device["platform"],
        "device_kind": device["kind"],
        "device_count": device["count"],
        "card": device["card"],
    }


def main():
    from opencl_montecarlo_path_tracing_tpu.scene.builtin import demo_scene
    from opencl_montecarlo_path_tracing_tpu.utils.device import (
        configure_compile_cache, device_info)

    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    variant = os.environ.get("BENCH_VARIANT", "all")
    configure_compile_cache()
    device = device_info()
    scene, tag = demo_scene()

    if variant == "all":
        # Wall-clock budget for the NON-headline rows: once it is spent,
        # the remaining rows are SKIPPED (explicit "skipped" records - not
        # silent) so the headline super row always renders and prints last.
        budget = float(os.environ.get("BENCH_BUDGET_S", "3000"))
        t_start = time.monotonic()
        crashed = False
        for v, (std_size, std_spp) in STD_CONFIG.items():
            size = int(os.environ.get("BENCH_SIZE", str(std_size)))
            spp = int(os.environ.get("BENCH_SPP", str(std_spp)))
            elapsed = time.monotonic() - t_start
            if v != "super" and budget > 0 and elapsed > budget:
                rec = {"metric": f"{v}_pathtracer_throughput",
                       "skipped": True,
                       "reason": f"BENCH_BUDGET_S {budget:.0f}s exceeded "
                                 f"({elapsed:.0f}s elapsed) - skipping so "
                                 "the headline row still runs"}
                print(json.dumps(rec), flush=True)
                continue
            try:
                rec = bench_one(v, scene, tag, size, spp, repeats, device)
            except Exception as e:  # noqa: BLE001 - a crashed row must
                # not take down the later rows (the headline prints last);
                # it still fails the run
                crashed = True
                rec = {"metric": f"{v}_pathtracer_throughput", "value": 0.0,
                       "unit": "Mpaths/s",
                       "error": f"{type(e).__name__}: {e}"[:300]}
            print(json.dumps(rec), flush=True)
        return 1 if crashed else 0

    if variant == "super":
        size = int(os.environ.get("BENCH_SIZE", "1024"))
        spp = int(os.environ.get("BENCH_SPP", "1024"))
    else:
        std_size, std_spp = STD_CONFIG.get(variant, (512, 64))
        size = int(os.environ.get("BENCH_SIZE", str(std_size)))
        spp = int(os.environ.get("BENCH_SPP", str(std_spp)))
    rec = bench_one(variant, scene, tag, size, spp, repeats, device)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())

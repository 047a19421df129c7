"""Time the fused super kernel against the XLA wavefront, on one device.

Calls the two film functions directly - ops/pallas_super.py::
film_super_kernel and models/common.py::accumulate_spp over
models/super.py::sample_super - on the same scene and key, so the render
path's routing plays no part.  For each configuration it prints one JSON
line per function: compile time, the median and spread of the render
time, paths/s, and the kernel film's agreement with the XLA film.

    python tools/kernel_vs_xla.py                      # both configs
    python tools/kernel_vs_xla.py --config headline --spp 16 \\
        --tiles 128x4,256x4                            # tile sweep

Configurations: ``headline`` is the demo scene at 1024^2 x 1024 spp;
``largemesh`` is the 20,736-triangle ripple sheet at 512^2 x 4 spp.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

from opencl_montecarlo_path_tracing_tpu.core.quirks import DEFAULT  # noqa: E402
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key  # noqa: E402
from opencl_montecarlo_path_tracing_tpu.models import common as C  # noqa: E402
from opencl_montecarlo_path_tracing_tpu.models.super import sample_super  # noqa: E402
from opencl_montecarlo_path_tracing_tpu.ops import pallas_super as K  # noqa: E402
from opencl_montecarlo_path_tracing_tpu.ops.intersect import prep_scene  # noqa: E402
from opencl_montecarlo_path_tracing_tpu.scene import builtin  # noqa: E402
from opencl_montecarlo_path_tracing_tpu.utils.device import (  # noqa: E402
    configure_compile_cache, device_info)
from opencl_montecarlo_path_tracing_tpu.utils.metrics import film_agreement  # noqa: E402

CONFIGS = {
    "headline": (lambda: builtin.demo_scene()[0], 1024, 1024),
    "largemesh": (builtin.large_mesh_scene, 512, 4),
}


def timed(fn, key, repeats: int):
    """(compile seconds, [render seconds], film) for a jitted fn(key)."""
    t0 = time.perf_counter()
    compiled = fn.lower(key).compile()
    compile_s = time.perf_counter() - t0
    film = jax.block_until_ready(compiled(key))      # warm-up
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        film = jax.block_until_ready(compiled(key))
        times.append(time.perf_counter() - t0)
    return compile_s, times, film


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=sorted(CONFIGS) + ["both"],
                    default="both")
    ap.add_argument("--spp", type=int, help="override the config's spp")
    ap.add_argument("--size", type=int, help="override the config's size")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--tiles", default=f"{K._BLOCK}x{K._NUM_WARPS}",
                    help="comma list of kernel BLOCKxWARPS to time")
    ap.add_argument("--no-xla", action="store_true",
                    help="time only the kernel")
    args = ap.parse_args(argv)
    configure_compile_cache()
    dev = device_info()
    print(f"# device {dev}", flush=True)
    names = sorted(CONFIGS) if args.config == "both" else [args.config]
    key = make_key(1)
    for name in names:
        make_scene, size, spp = CONFIGS[name]
        size = args.size or size
        spp = args.spp or spp
        scn = prep_scene(make_scene())
        paths = size * size * spp
        base = {"config": name, "size": size, "spp": spp,
                "triangles": int(scn.tri_v0.shape[0]),
                "platform": dev["platform"], "kind": dev["kind"],
                "card": dev["card"]}
        xla_film = None
        if not args.no_xla:
            xla = jax.jit(lambda k: C.accumulate_spp(
                functools.partial(sample_super, k, scn, DEFAULT,
                                  C.MAX_BOUNCES), size, size, spp))
            c_s, times, xla_film = timed(xla, key, args.repeats)
            med = statistics.median(times)
            print(json.dumps(dict(base, fn="xla", compile_s=c_s,
                                  render_s=med, render_s_all=times,
                                  mpaths_s=paths / med / 1e6)), flush=True)
        for tile in args.tiles.split(","):
            block, warps = (int(v) for v in tile.split("x"))
            kern = jax.jit(lambda k, b=block, w=warps: K.film_super_kernel(
                k, scn, size, size, spp, block=b, num_warps=w))
            c_s, times, film = timed(kern, key, args.repeats)
            med = statistics.median(times)
            rec = dict(base, fn="kernel", block=block, num_warps=warps,
                       compile_s=c_s, render_s=med, render_s_all=times,
                       mpaths_s=paths / med / 1e6,
                       finite=bool(np.isfinite(np.asarray(film)).all()))
            if xla_film is not None:
                rec["vs_xla"] = film_agreement(film, xla_film)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

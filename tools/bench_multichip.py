"""Multi-device scaling harness: the sharded renderers at 1, 2, 4... devices.

The distributed layer (parallel/mesh.py: spp sharding, 2-D rows x spp,
sharded VLP light passes, film psum over the mesh) is checked for
correctness against the single-device film by ``chip_smoke.py --devices
4``; this tool measures its throughput:

    python tools/bench_multichip.py                 # all device counts
    python tools/bench_multichip.py --json out.json # machine-readable

Device counts are discovered from jax.devices(), rows are powers of two
up to that count, and every row is emitted as one JSON line.

Measured per device count n (powers of 2 up to len(jax.devices())):
  strong scaling - the FIXED headline workload (--size^2 x --spp camera
    paths, the demo scene) sharded over an n-device 1-D spp mesh; ideal =
    n-fold speedup over n=1.
  weak scaling - --spp samples PER DEVICE (total spp = n * --spp-local);
    ideal = flat time as n grows.
  2-D mesh - the strong workload on an (n/2 rows x 2 spp) mesh when
    n >= 4 (the rows x spp composition the CLI's --shard RxS uses).
  bidirectional - strong scaling of the VLP integrator whose LIGHT pass
    is sharded too (emission window per device + all_gather).

Smoke-testable on the virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/bench_multichip.py --size 64 --spp 16 --repeats 1

(CPU-mesh timings validate the harness; device numbers come only from a
run on the cards.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench(fn, key, repeats: int) -> float:
    """Min-of-repeats seconds, each up to device completion."""
    import jax
    jax.block_until_ready(fn(key))  # compile + warm
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(key))
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=1024,
                    help="image size (headline 1024)")
    ap.add_argument("--spp", type=int, default=1024,
                    help="TOTAL spp for the strong-scaling rows")
    ap.add_argument("--spp-local", type=int, default=128,
                    help="per-device spp for the weak-scaling rows")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--n-vlp", type=int, default=512)
    ap.add_argument("--max-devices", type=int, default=0,
                    help="cap the device-count sweep (0 = all)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write all rows to PATH as a JSON array")
    ns = ap.parse_args(argv)

    import jax
    from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        make_mesh_2d, make_spp_mesh, render_bidirectional_sharded,
        render_super_sharded, render_super_sharded_2d)
    from opencl_montecarlo_path_tracing_tpu.scene.builtin import demo_scene

    ndev = len(jax.devices())
    if ns.max_devices:
        ndev = min(ndev, ns.max_devices)
    counts = []
    n = 1
    while n <= ndev:
        counts.append(n)
        n *= 2
    backend = jax.default_backend()
    print(f"# backend={backend} devices={ndev} sweep={counts}",
          file=sys.stderr)

    scene, tag = demo_scene()
    key = make_key(0)
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    base_s = {}
    for n in counts:
        mesh = make_spp_mesh(n)
        size, spp = ns.size, ns.spp
        if spp % n:
            spp = (spp // n) * n or n

        # strong scaling: fixed total workload over n devices
        s = bench(lambda k: render_super_sharded(k, scene, size, size, spp,
                                                 mesh), key, ns.repeats)
        if n == 1:
            base_s["strong"] = s
        mp = size * size * spp / s / 1e6
        emit({"mode": "strong", "variant": "super", "mesh": f"1d-spp{n}",
              "n_devices": n, "config": f"{size}x{size} spp={spp}",
              "scene": tag, "ms": round(s * 1e3, 2),
              "mpaths_per_s": round(mp, 2),
              "mpaths_per_s_per_chip": round(mp / n, 2),
              "speedup_vs_1": round(base_s["strong"] / s, 3)
              if base_s.get("strong") else None})

        # weak scaling: per-device work constant
        wspp = ns.spp_local * n
        sw = bench(lambda k: render_super_sharded(k, scene, size, size,
                                                  wspp, mesh), key,
                   ns.repeats)
        if n == 1:
            base_s["weak"] = sw
        mpw = size * size * wspp / sw / 1e6
        emit({"mode": "weak", "variant": "super", "mesh": f"1d-spp{n}",
              "n_devices": n, "config": f"{size}x{size} spp={wspp}",
              "scene": tag, "ms": round(sw * 1e3, 2),
              "mpaths_per_s": round(mpw, 2),
              "mpaths_per_s_per_chip": round(mpw / n, 2),
              "efficiency_vs_1": round(base_s["weak"] / sw, 3)
              if base_s.get("weak") else None})

        # 2-D rows x spp mesh (the --shard RxS composition)
        if n >= 4 and size % (n // 2) == 0:
            mesh2 = make_mesh_2d(n // 2, 2)
            s2 = bench(lambda k: render_super_sharded_2d(
                k, scene, size, size, spp, mesh2), key, ns.repeats)
            mp2 = size * size * spp / s2 / 1e6
            emit({"mode": "strong", "variant": "super",
                  "mesh": f"2d-{n//2}x2", "n_devices": n,
                  "config": f"{size}x{size} spp={spp}", "scene": tag,
                  "ms": round(s2 * 1e3, 2), "mpaths_per_s": round(mp2, 2),
                  "mpaths_per_s_per_chip": round(mp2 / n, 2)})

        # VLP integrator with the sharded light pass (all_gather)
        nv = ns.n_vlp - ns.n_vlp % n or n
        sb = bench(lambda k: render_bidirectional_sharded(
            k, scene, size, size, spp, mesh, n_vlp=nv), key, ns.repeats)
        mpb = size * size * spp / sb / 1e6
        emit({"mode": "strong", "variant": "bidirectional",
              "mesh": f"1d-spp{n}", "n_devices": n,
              "config": f"{size}x{size} spp={spp} n_vlp={nv}",
              "scene": tag, "ms": round(sb * 1e3, 2),
              "mpaths_per_s": round(mpb, 2),
              "mpaths_per_s_per_chip": round(mpb / n, 2)})

    if ns.json:
        with open(ns.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"# wrote {len(rows)} rows to {ns.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

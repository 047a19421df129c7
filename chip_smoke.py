"""Smoke run of the path tracer on an NVIDIA GPU, in one process.

    python chip_smoke.py               # one card
    python chip_smoke.py --devices 4   # the sharded renderers on four cards

One card:
  1. name the device (JAX's platform, device kind and count; nvidia-smi's
     card name and power limit) and refuse to go on unless JAX's backend
     is the GPU - JAX falls back to the CPU with only a warning;
  2. render the headline - ``super`` on the demo scene at 1024^2 x 1024
     spp - through ``api.render`` and through the CLI, check the film is
     finite and the PAM file reads back, and print paths/s;
  3. compare the fused kernel (ops/pallas_super.py) with the XLA
     wavefront at 1024^2 x 64 spp on the demo scene and at 512^2 x 4 on
     the 20,736-triangle sheet (at least 99.5% of pixels within 1e-4 of
     the film maximum, film means within 1e-5 relative), and the XLA
     wavefront with the NumPy oracle (models/oracle_super.py) on a
     content band 512 wide, 16 rows, 4 spp (RGBA8 within 1 on at least
     99.5% of pixels);
  4. run every other integrator once at its bench.py configuration, with
     compile time reported apart from render time.

Four cards (``--devices 4``): render_super_sharded on a 4-device spp
mesh, render_super_sharded_2d on a 2x2 mesh and render_bidirectional_
sharded with the sharded light pass, each compared with the single-device
film (max |difference| <= 1e-5 of the film maximum: the psum
reassociates the sum).

Every phase raises on failure.  The last line of standard output is
``{"ok": true, "device": {...}}`` and is printed only when every phase
passed.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

HEADLINE = (1024, 1024)          # size, spp of the headline render
KERNEL_VS_XLA = [("demo", 1024, 64), ("sheet", 512, 4)]
ORACLE_BAND = (512, 300, 16, 4)  # width, first row, rows, spp
SHARDED = (512, 64, 64)          # size, spp, VLPs per light (4 cards)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="1: the one-card phases; 4: only the sharded "
                         "renderers against the single-device film")
    return ap.parse_args(argv)


def require_gpu(backend: str) -> None:
    """Stop unless JAX runs on the GPU."""
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is {backend!r}, not "
                         "'gpu' - no accelerator, or its plugin failed")


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def log(**rec) -> None:
    print(json.dumps(rec), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def timed(fn):
    """(result, seconds) of fn() up to device completion."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def first_and_steady(fn):
    """Run fn twice: the first call compiles, the second is the render.
    Returns (result, compile seconds, render seconds)."""
    _, first = timed(lambda: fn(0))
    out, steady = timed(lambda: fn(1))
    return out, max(first - steady, 0.0), steady


def phase_headline(card):
    import numpy as np
    from opencl_montecarlo_path_tracing_tpu import api
    from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
        demo_scene, write_scene_files)
    from opencl_montecarlo_path_tracing_tpu.utils import cli, pam

    size, spp = HEADLINE
    scene, tag = demo_scene()
    film, compile_s, render_s = first_and_steady(
        lambda seed: api.render("super", scene, size, size, spp=spp,
                                seed=seed))
    film = np.asarray(film)
    check(film.shape == (size, size, 3), f"film shape {film.shape}")
    check(bool(np.isfinite(film).all()), "headline film not finite")
    log(phase="headline", entry="api.render", scene=tag, size=size, spp=spp,
        compile_s=compile_s, render_s=render_s,
        mpaths_s=size * size * spp / render_s / 1e6, card=card)

    with tempfile.TemporaryDirectory() as tmp:
        scene_dir = os.path.join(tmp, "scene")
        write_scene_files(scene, scene_dir)
        out = os.path.join(tmp, "result.ppm")
        t0 = time.perf_counter()
        rc = cli.main(["super", str(size), str(size), "--spp", str(spp),
                       "--seed", "1", "--scene-dir", scene_dir,
                       "--out", out])
        cli_s = time.perf_counter() - t0
        check(rc == 0, f"cli.main returned {rc}")
        img = pam.load_pam(out)
        data = np.asarray(img.data)
    check((img.width, img.height) == (size, size), "PAM size")
    check(int(data[..., 3].min()) == 255, "PAM alpha")
    from opencl_montecarlo_path_tracing_tpu.utils.metrics import (
        rgba8_agreement)
    same = rgba8_agreement(data, pam.film_to_rgba8(film))
    check(same >= 0.99, f"CLI image vs api.render image: {same}")
    log(phase="headline", entry="cli.main", size=size, spp=spp,
        wall_s_with_compile=cli_s, rgba8_within_1_of_api=same, card=card)


def phase_compare(card):
    import numpy as np
    import jax
    from opencl_montecarlo_path_tracing_tpu.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu.models import common as C
    from opencl_montecarlo_path_tracing_tpu.models.oracle_super import (
        render_oracle_super)
    from opencl_montecarlo_path_tracing_tpu.models.super import sample_super
    from opencl_montecarlo_path_tracing_tpu.ops.intersect import prep_scene
    from opencl_montecarlo_path_tracing_tpu.ops.pallas_super import (
        film_super_kernel)
    from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
        demo_scene, large_mesh_scene)
    from opencl_montecarlo_path_tracing_tpu.utils.metrics import (
        film_agreement, rgba8_agreement)
    from opencl_montecarlo_path_tracing_tpu.utils.pam import film_to_rgba8

    scenes = {"demo": demo_scene()[0], "sheet": large_mesh_scene()}
    key = make_key(5)

    def xla_film(scn, width, spp, row_offset=0, rows=None):
        return jax.jit(lambda k: C.accumulate_spp(
            functools.partial(sample_super, k, scn, DEFAULT, C.MAX_BOUNCES),
            width, width, spp, row_offset=row_offset, rows=rows))(key)

    for name, size, spp in KERNEL_VS_XLA:
        scn = prep_scene(scenes[name])
        ref, xla_s = timed(lambda: xla_film(scn, size, spp))
        got, kern_s = timed(lambda: jax.jit(lambda k: film_super_kernel(
            k, scn, size, size, spp))(key))
        agree = film_agreement(got, ref)
        log(phase="kernel_vs_xla", scene=name,
            triangles=int(scn.tri_v0.shape[0]), size=size, spp=spp,
            xla_s_with_compile=xla_s, kernel_s_with_compile=kern_s,
            card=card, **agree)
        check(agree["within"] >= 0.995, f"kernel vs XLA ({name}): {agree}")
        check(agree["mean_rel"] <= 1e-5, f"kernel vs XLA ({name}): {agree}")

    width, row0, rows, spp = ORACLE_BAND
    scene = scenes["demo"]
    scn = prep_scene(scene)
    band = np.asarray(jax.jit(lambda k: C.accumulate_spp(
        functools.partial(sample_super, k, scn, DEFAULT, C.MAX_BOUNCES),
        width, row0 + rows, spp, row_offset=row0, rows=rows))(key))
    oracle = render_oracle_super(scene, width, rows, spp=spp, key=key,
                                 row_offset=row0)
    check(float(oracle.var()) > 1e-4, "oracle band holds no content")
    same = rgba8_agreement(film_to_rgba8(band), film_to_rgba8(oracle))
    log(phase="xla_vs_oracle", width=width, row_offset=row0, rows=rows,
        spp=spp, rgba8_within_1=same, card=card)
    check(same >= 0.995, f"XLA vs oracle: {same}")


def phase_integrators(card):
    import numpy as np
    import bench
    from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu.scene.builtin import demo_scene

    scene, _ = demo_scene()
    for variant, (size, spp) in bench.STD_CONFIG.items():
        if variant == "super":
            continue    # the headline phase ran it
        render = bench.make_render(variant, scene, size, spp)
        out, compile_s, render_s = first_and_steady(
            lambda seed: render(make_key(seed)))
        out = np.asarray(out)
        check(bool(np.isfinite(out).all()), f"{variant} output not finite")
        paths = size * size * bench.spp_of(variant, spp)
        log(phase="integrator", variant=variant, size=size,
            spp=bench.spp_of(variant, spp), compile_s=compile_s,
            render_s=render_s, mpaths_s=paths / render_s / 1e6, card=card)


def phase_sharded(card):
    import numpy as np
    from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
    from opencl_montecarlo_path_tracing_tpu.models.bidirectional import (
        render_bidirectional)
    from opencl_montecarlo_path_tracing_tpu.models.super import render_super
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        make_mesh_2d, make_spp_mesh, render_bidirectional_sharded,
        render_super_sharded, render_super_sharded_2d)
    from opencl_montecarlo_path_tracing_tpu.scene.builtin import demo_scene

    size, spp, n_vlp = SHARDED
    scene, _ = demo_scene()
    key = make_key(7)
    spp_mesh = make_spp_mesh(4)
    cases = [
        ("super_sharded[spp=4]",
         lambda: render_super_sharded(key, scene, size, size, spp, spp_mesh),
         lambda: render_super(key, scene, size, size, spp)),
        ("super_sharded_2d[2x2]",
         lambda: render_super_sharded_2d(key, scene, size, size, spp,
                                         make_mesh_2d(2, 2)),
         lambda: render_super(key, scene, size, size, spp)),
        ("bidirectional_sharded[spp=4, sharded light pass]",
         lambda: render_bidirectional_sharded(key, scene, size, size, spp,
                                              spp_mesh, n_vlp=n_vlp),
         lambda: render_bidirectional(key, scene, size, size, spp,
                                      n_vlp=n_vlp)),
    ]
    for name, sharded_fn, single_fn in cases:
        sharded, sharded_s = timed(sharded_fn)
        single, single_s = timed(single_fn)
        sharded = np.asarray(sharded)
        single = np.asarray(single)
        scale = float(np.abs(single).max())
        diff = float(np.abs(sharded - single).max())
        log(phase="sharded", case=name, size=size, spp=spp,
            max_abs_diff=diff, film_max=scale,
            sharded_s_with_compile=sharded_s,
            single_s_with_compile=single_s, card=card)
        check(bool(np.isfinite(sharded).all()), f"{name} not finite")
        check(diff <= 1e-5 * scale, f"{name}: max |diff| {diff} > 1e-5 x "
                                    f"{scale}")


def main(argv=None) -> int:
    ns = parse_args(argv)
    import jax
    devs = jax.devices()
    platform, kind = devs[0].platform, devs[0].device_kind
    print(f"# JAX: platform={platform} device_kind={kind} "
          f"count={len(devs)}", flush=True)
    require_gpu(jax.default_backend())
    if len(devs) < ns.devices:
        raise SystemExit(f"chip_smoke: --devices {ns.devices} needs "
                         f"{ns.devices} devices; JAX sees {len(devs)}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from opencl_montecarlo_path_tracing_tpu.utils.device import (
        configure_compile_cache, nvidia_smi)
    smi = nvidia_smi()
    card = smi.splitlines()[0] if smi else None
    print(f"# nvidia-smi: {smi}", flush=True)
    configure_compile_cache()
    t0 = time.perf_counter()
    if ns.devices == 4:
        phase_sharded(card)
    else:
        phase_headline(card)
        phase_compare(card)
        phase_integrators(card)
    print(f"# all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(smi, flush=True)
    print(result_line(platform, kind, len(devs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

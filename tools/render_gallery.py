"""Render every variant at the reference's default config.

Writes renders/<variant>.png (+ .ppm PAM) and renders/RENDERS.md listing
them: end-to-end evidence that each integrator runs the reference's own
scenes at the reference's default settings.  Wall times are printed with
the device they ran on; speed is measured by bench.py.
"""

import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.scene import load_scene
from opencl_montecarlo_path_tracing_tpu.utils import pam

REF = "/root/reference"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "renders")


def save(name, film_or_rgba, w, h, is_rgba=False):
    os.makedirs(OUT, exist_ok=True)
    rgba = film_or_rgba if is_rgba else pam.film_to_rgba8(np.asarray(film_or_rgba))
    pam.save_pam(os.path.join(OUT, f"{name}.ppm"),
                 pam.ImgInfo(width=w, height=h, channels=4, data=rgba))
    pam.save_png(os.path.join(OUT, f"{name}.png"), rgba)


def main():
    key = make_key(20260816)
    w = h = 512
    rows = []

    device = jax.devices()[0].device_kind

    def run(name, fn, paths):
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        rows.append(name)
        print(f"{name}: {dt:.1f}s wall on {device}, compile included",
              flush=True)
        return out

    from opencl_montecarlo_path_tracing_tpu.models.simple import render_simple
    film = run("simple (512^2, 64 spp)",
               lambda: np.asarray(render_simple(key, w, h, spp=64)),
               w * h * 64)
    save("simple", film, w, h)

    sc = load_scene(os.path.join(REF, "CLSuperPathTracer"))
    from opencl_montecarlo_path_tracing_tpu.models.super import render_super
    film = run("super (512^2, 64 spp)",
               lambda: np.asarray(render_super(key, sc, w, h, spp=64)),
               w * h * 64)
    save("super", film, w, h)

    torus = load_scene(os.path.join(REF, "CLSuperPathTracer"),
                       triangles="torus.txt")
    film = run("super torus mesh (512^2, 64 spp)",
               lambda: np.asarray(render_super(key, torus, w, h, spp=64)),
               w * h * 64)
    save("super_torus", film, w, h)

    from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
        large_mesh_scene)
    big = large_mesh_scene()   # 20736-tri VISIBLE ripple sheet (round 4)
    film = run("super largemesh 20k ripple sheet (512^2, 16 spp)",
               lambda: np.asarray(render_super(key, big, w, h, spp=16)),
               w * h * 16)
    save("super_largemesh", film, w, h)

    from opencl_montecarlo_path_tracing_tpu.models.sample_parallel import (
        render_sample_parallel)
    img = run("nodof sample-parallel (512^2, 8x8 samples)",
              lambda: np.asarray(render_sample_parallel(key, sc, w, h,
                                                        sample_grid=8)),
              w * h * 64)
    save("nodof", img, w, h, is_rgba=True)

    scg = load_scene(os.path.join(REF, "CLSuperPathTracer_trianglegrid"))
    from opencl_montecarlo_path_tracing_tpu.models.trianglegrid import (
        render_trianglegrid)
    film = run("trianglegrid (256^2, 8 spp)",
               lambda: np.asarray(render_trianglegrid(key, scg, 256, 256,
                                                      spp=8)),
               256 * 256 * 8)
    save("trianglegrid", film, 256, 256)

    scb = load_scene(os.path.join(REF, "CLSuperBidirectionalPathTracer"))
    from opencl_montecarlo_path_tracing_tpu.models.bidirectional import (
        render_bidirectional)
    film = run("bidirectional (512^2, 64 spp, 512 VLP/light)",
               lambda: np.asarray(render_bidirectional(key, scb, w, h,
                                                       spp=64, n_vlp=512)),
               w * h * 64)
    save("bidirectional", film, w, h)

    scm = load_scene(os.path.join(REF, "CLSuperMetropolisPathTracer"))
    from opencl_montecarlo_path_tracing_tpu.models.metropolis import (
        render_metropolis)
    film = run("metropolis (512^2, 64 spp, 512 seeds, 8 rounds)",
               lambda: np.asarray(render_metropolis(key, scm, w, h, spp=64,
                                                    n_seedpaths=512,
                                                    mutation_rounds=8)),
               w * h * 64)
    save("metropolis", film, w, h)

    scv = load_scene(os.path.join(REF, "CLSuperMetropolisPathTracer_vlpgrid"))
    film = run("metropolis_vlpgrid (512^2, 64 spp)",
               lambda: np.asarray(render_metropolis(key, scv, w, h, spp=64,
                                                    n_seedpaths=512,
                                                    mutation_rounds=8,
                                                    use_grid=True)),
               w * h * 64)
    save("metropolis_vlpgrid", film, w, h)

    from opencl_montecarlo_path_tracing_tpu.models.oracle import render_oracle
    film = run("simplecpu oracle (256^2, 64 spp, NumPy host)",
               lambda: render_oracle(256, 256, spp=64, seed=1),
               256 * 256 * 64)
    save("simplecpu", film, 256, 256)

    with open(os.path.join(OUT, "RENDERS.md"), "w") as fp:
        fp.write("# Render gallery (reference scenes, reference default "
                 "configs)\n\nWritten by tools/render_gallery.py.\n\n")
        for name in rows:
            fp.write(f"- {name}\n")
        fp.write("\nImages: PNG previews + byte-exact PAM (P7) outputs.\n")
    print("wrote", os.path.join(OUT, "RENDERS.md"))


if __name__ == "__main__":
    main()

"""Command-line parity with the reference binaries.

Each reference variant is a standalone binary taking positional args and
reading scene text files from the current directory (SURVEY.md section 2 CLI
table).  Here every variant is a subcommand with the same positionals:

    python -m opencl_montecarlo_path_tracing_tpu simplecpu [w] [h]
    python -m ... simple        [w] [h] [lws0]
    python -m ... super         [w] [h]
    python -m ... superlmem     [w] [h]
    python -m ... nodof         [w] [h]
    python -m ... trianglegrid  [w] [h] [CELL_SIZE_MODIFIER]
    python -m ... bidirectional [w] [h] [N_VLP_per_light]
    python -m ... metropolis    [w] [h] [nseedpaths] [mutation_rounds]
    python -m ... metropolis_vlpgrid [w] [h] [nseedpaths] [mutation_rounds]
                                     [CELL_SIZE_MODIFIER]

Keyword options extend the reference surface: --scene-dir, --spp, --seed,
--out, --quirks {default,reference}, --triangles-file (the torus swap),
--checkpoint/--spp-per-step (resumable accumulation), --profile-stages
(per-stage timing of the VLP pipelines), --dynamic-grid-res (the vlpgrid
reference-parity grid mode), --shard N|RxS (multi-device rendering over a
jax.sharding.Mesh - spp or rows x spp, VLP light passes sharded too).  The lws0 positional of the simple
tracer is accepted and ignored (XLA picks its own block sizes); device
selection honours PT_PLATFORM / PT_DEVICE like the reference's OCL_PLATFORM
/ OCL_DEVICE env vars (ocl_boiler.h:54-131).

Output: a PAM (P7) RGBA file (default result.ppm) plus a per-stage timing
report in the reference's format (e.g. CLSuperPathTracer.c:321-325).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _select_device():
    # PT_* preferred; the reference's OCL_DEVICE index (ocl_boiler.h:100)
    # is honoured as a drop-in alias. OCL_PLATFORM selected a platform by
    # INDEX in the reference; here platforms are named backends, so a
    # non-numeric OCL_PLATFORM is accepted as a name and a numeric one is
    # ignored (there is exactly one platform per backend).
    platform = os.environ.get("PT_PLATFORM")
    if not platform:
        ocl_p = os.environ.get("OCL_PLATFORM", "")
        if ocl_p and not ocl_p.isdigit():
            platform = ocl_p
    device = os.environ.get("PT_DEVICE") or os.environ.get("OCL_DEVICE")
    import jax
    if platform:
        jax.config.update("jax_platforms", platform)
    devs = jax.devices()
    idx = int(device) if device else 0
    if idx >= len(devs):
        print(f"no device {idx}; have {len(devs)}", file=sys.stderr)
        sys.exit(1)
    if idx != 0:
        jax.config.update("jax_default_device", devs[idx])
    print(f"Using device: {devs[idx]}")
    return devs[idx]


def _positional(args, i, default, cast=int):
    return cast(args[i]) if len(args) > i else default


def _staged_vlp_render(timer, key, scene, w, h, spp, quirks, kind,
                       n_vlp=512, n_seed=512, rounds=8, use_grid=False,
                       grid_modifier=3.0, dynamic_res=False):
    """Run the VLP pipeline stage by stage with a device sync per stage -
    observability parity with the reference's per-stage event report (e.g.
    CLSuperMetropolisPathTracer_vlpgrid/...c:673-705: light pass, metropolis
    pass, min/max reduction, grid init, render).

    ``dynamic_res`` (the --dynamic-grid-res parity mode) expands the mlt
    grid pipeline to the reference's exact 7-stage vlpgrid report
    (.c:691-705): the seed and Metropolis light kernels timed separately,
    the device box reduction, the BLOCKING host box read (.c:609), the
    box-derived grid init, the render, and the render read (timed by the
    caller)."""
    import jax
    from ..ops.intersect import prep_scene
    from ..ops import vlp as vlpmod

    scn = prep_scene(scene)
    nlights = int(scn.lights.shape[0])
    if kind == "bpt":
        emit = jax.jit(lambda k: vlpmod.emit_vlps(k, scn, n_vlp, quirks))
        vlps = timer.run("light tracer", lambda: emit(key),
                         items=n_vlp * nlights,
                         item_label="VLPs",
                         data_size=n_vlp * nlights * 16)
    elif dynamic_res and use_grid:
        # reference stage 1+2: the two light kernels timed separately
        # (lightTracer then MetropolisLightTracer, .c:691-694)
        from ..models.metropolis import mlt_seed, mlt_mutate_emit
        seedfn = jax.jit(lambda k: mlt_seed(k, scn, n_seed, quirks))
        seed_state = timer.run(
            "light paths random sampling", lambda: seedfn(key),
            items=n_seed * nlights, item_label="random light paths",
            data_size=n_seed * nlights * 64)
        mut = jax.jit(lambda k, s: mlt_mutate_emit(
            k, scn, n_seed, rounds, quirks, seed_state=s))
        vlps = timer.run(
            "light paths metropolis sampling",
            lambda: mut(key, seed_state),
            items=n_seed * nlights * 4, item_label="virtual lights",
            data_size=n_seed * nlights * 4 * 16)
    else:
        from ..models.metropolis import mlt_vlps
        emit = jax.jit(lambda k: mlt_vlps(k, scn, n_seed, rounds, quirks))
        vlps = timer.run("light tracer + metropolis", lambda: emit(key),
                         items=n_seed * nlights,
                         item_label="paths",
                         data_size=n_seed * nlights * 64)

    grid = None
    if use_grid and dynamic_res:
        nv = int(vlps.shape[0])
        # reference stages 3-5: device box reduction, BLOCKING host box
        # read, box-derived grid init (.c:595-648)
        bounds = jax.jit(vlpmod.vlp_bounds)
        bb = timer.run("VLPs min/max reduction (compute bounding box)",
                       lambda: bounds(vlps), items=nv,
                       item_label="virtual lights", data_size=nv * 16)
        t0 = time.perf_counter()
        vmin, vmax = (np.asarray(b) for b in bb)
        timer.record("Read VLPs bounding box",
                     (time.perf_counter() - t0) * 1e3,
                     items=1, item_label="box", data_size=32)
        res = vlpmod.vlp_grid_dynamic_res(vmin, vmax, nv, grid_modifier)
        print("VLPs grid size: %d x %d x %d" % res)
        build = jax.jit(lambda v: vlpmod.build_vlp_grid(v, res))
        grid = timer.run("init VLPs grid", lambda: build(vlps),
                         items=int(np.prod(res)), item_label="cells",
                         data_size=int(np.prod(res)) * 63 * 4)
    elif use_grid:
        res = vlpmod.vlp_grid_static_res(int(vlps.shape[0]), grid_modifier)
        build = jax.jit(lambda v: vlpmod.build_vlp_grid(v, res))
        grid = timer.run("min/max reduction + VLPs grid init",
                         lambda: build(vlps),
                         items=int(np.prod(res)), item_label="cells",
                         data_size=int(np.prod(res)) * 63 * 4)

    from ..models.bidirectional import film_bidirectional
    render = jax.jit(lambda k, v, g: film_bidirectional(
        k, scn, w, h, spp, 0, spp, n_vlp, quirks, use_grid=use_grid,
        precomputed_vlps=v, precomputed_grid=g))
    return timer.run("rendering", lambda: render(key, vlps, grid),
                     items=w * h, item_label="pixels", data_size=w * h * 4)


def _sharded_cli_render(ns, timer, key, scene, w, h, quirks, pos, seed=0):
    """--shard dispatch to the parallel/mesh.py renderers (beyond the
    reference surface: the reference is single-device, ocl_boiler.h:150).
    Composes with --checkpoint for the 1-D spp-sharded variants (each
    window is rendered by the sharded program; the traced spp_offset means
    all windows share one compile).
    Returns (film, img); (None, None) after printing an error."""
    import jax
    from .. import parallel as par
    from ..parallel.mesh import (render_bidirectional_sharded_2d,
                                 render_metropolis_sharded_2d)
    spec = ns.shard.lower()
    try:
        if "x" in spec:
            ry, sp = (int(x) for x in spec.split("x"))
            n, two_d = ry * sp, True
        else:
            ry, sp = None, int(spec)
            n, two_d = sp, False
    except ValueError:
        print(f"error: bad --shard spec {ns.shard!r} (want N or RxS)",
              file=sys.stderr)
        return None, None
    if len(jax.devices()) < n:
        print(f"error: --shard {ns.shard} needs {n} devices; "
              f"have {len(jax.devices())}", file=sys.stderr)
        return None, None
    v = ns.variant
    spp = ns.spp
    if two_d and v not in ("super", "superlmem", "bidirectional",
                           "metropolis", "metropolis_vlpgrid"):
        print(f"error: 2-D --shard is not supported for {v} "
              "(use the 1-D N form)", file=sys.stderr)
        return None, None
    if ns.checkpoint and (two_d or v == "nodof"):
        print("error: --checkpoint composes with the 1-D spp-sharded "
              f"--shard forms only (not {'2-D meshes' if two_d else v})",
              file=sys.stderr)
        return None, None
    label = f"rendering (sharded {ns.shard})"
    try:
        if v == "nodof":
            mesh = par.make_spp_mesh(n, axis="y")
            img = timer.run(
                "rendering+reduction (sharded rows)",
                lambda: par.render_sample_parallel_sharded(
                    key, scene, w, h, sample_grid=8, mesh=mesh,
                    quirks=quirks),
                items=w * h * 64, item_label="samples",
                data_size=w * h * 64 * 16)
            return None, np.asarray(img)
        mesh = par.make_mesh_2d(ry, sp) if two_d else par.make_spp_mesh(n)
        # each variant becomes a window function (step, offset, total) so
        # the plain render (one full window) and --checkpoint (resumable
        # windows) share one dispatch
        if v in ("super", "superlmem"):
            if two_d:
                fn = lambda: par.render_super_sharded_2d(
                    key, scene, w, h, spp, mesh, quirks)
            else:
                winfn = lambda s, off, tot: par.render_super_sharded(
                    key, scene, w, h, s, mesh, quirks,
                    spp_offset=off, spp_total=tot)
        elif v == "simple":
            winfn = lambda s, off, tot: par.render_simple_sharded(
                key, w, h, s, mesh, quirks, spp_offset=off, spp_total=tot)
        elif v == "trianglegrid":
            mod = _positional(pos, 2, 3.0, float)
            winfn = lambda s, off, tot: par.render_trianglegrid_sharded(
                key, scene, w, h, s, mesh, cell_size_modifier=mod,
                quirks=quirks, spp_offset=off, spp_total=tot)
        elif v == "bidirectional":
            n_vlp = _positional(pos, 2, 512)
            if two_d:
                fn = lambda: render_bidirectional_sharded_2d(
                    key, scene, w, h, spp, mesh, n_vlp=n_vlp, quirks=quirks)
            else:
                winfn = lambda s, off, tot: par.render_bidirectional_sharded(
                    key, scene, w, h, s, mesh, n_vlp=n_vlp, quirks=quirks,
                    spp_offset=off, spp_total=tot)
        else:   # metropolis / metropolis_vlpgrid
            n_seed = _positional(pos, 2, 512)
            rounds = _positional(pos, 3, 8)
            mod = _positional(pos, 4, 3.0, float)
            use_grid = v.endswith("vlpgrid")
            kw = dict(n_seedpaths=n_seed, mutation_rounds=rounds,
                      quirks=quirks, use_grid=use_grid, grid_modifier=mod)
            if two_d:
                fn = lambda: render_metropolis_sharded_2d(
                    key, scene, w, h, spp, mesh, **kw)
            else:
                winfn = lambda s, off, tot: par.render_metropolis_sharded(
                    key, scene, w, h, s, mesh, spp_offset=off,
                    spp_total=tot, **kw)
        if ns.checkpoint:
            from .checkpoint import render_resumable
            t0 = time.perf_counter()
            ck = render_resumable(
                lambda k, s_, ww, hh, spp, spp_offset, spp_total:
                    winfn(spp, spp_offset, spp_total),
                key, scene, w, h, ns.spp, checkpoint_path=ns.checkpoint,
                spp_per_step=ns.spp_per_step, seed=seed)
            timer.record(f"{label} (checkpointed, {ck.spp_done} spp)",
                         (time.perf_counter() - t0) * 1e3,
                         items=w * h, item_label="pixels",
                         data_size=w * h * 4)
            return ck.film, None
        if not two_d:
            fn = lambda: winfn(spp, 0, None)
        film = timer.run(label, fn, items=w * h, item_label="pixels",
                         data_size=w * h * 4)
        return film, None
    except ValueError as e:   # indivisible spp/rows etc.
        print(f"error: --shard {ns.shard}: {e}", file=sys.stderr)
        return None, None


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog="opencl_montecarlo_path_tracing_tpu",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("variant", choices=[
        "simplecpu", "simple", "super", "superlmem", "nodof", "trianglegrid",
        "bidirectional", "metropolis", "metropolis_vlpgrid"])
    ap.add_argument("positionals", nargs="*")
    ap.add_argument("--scene-dir", default=".")
    ap.add_argument("--triangles-file", default="triangles.txt",
                    help="alternate mesh in the same format (the reference "
                         "ships torus.txt to swap in by renaming)")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--quirks", choices=["default", "reference"],
                    default="default")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="accumulate the film in spp windows, checkpointing "
                         "to PATH after each; re-running resumes where it "
                         "left off (bit-identical sample content)")
    ap.add_argument("--spp-per-step", type=int, default=64,
                    help="window size for --checkpoint")
    ap.add_argument("--pam-maxval", type=int, choices=[255, 65535],
                    default=255,
                    help="output sample depth: 255 = the reference's RGBA8; "
                         "65535 writes 16-bit PAM (the reference IO layer "
                         "round-trips it, pamalign.h:156-166/226-231, but "
                         "its tracers never emit it)")
    ap.add_argument("--shard", default=None, metavar="N|RxS",
                    help="render through the multi-device sharded path "
                         "(parallel/mesh.py): N shards the spp axis over N "
                         "devices; RxS shards image rows x spp over a 2-D "
                         "mesh (super/bidirectional/metropolis[_vlpgrid]; "
                         "other variants support the 1-D form).  The VLP "
                         "variants shard their light pass too.  Requires "
                         "enough JAX devices; composes with --checkpoint "
                         "(1-D forms); incompatible with --profile-stages")
    ap.add_argument("--dynamic-grid-res", action="store_true",
                    help="metropolis_vlpgrid only: derive the VLP grid "
                         "resolution from the reduced bounding box with "
                         "one blocking host read, exactly as the "
                         "reference does (vlpgrid .c:609, :629-636); the "
                         "default static resolution keeps the pipeline "
                         "device-resident under one jit")
    ap.add_argument("--profile-stages", action="store_true",
                    help="time the VLP pipeline stage by stage (light pass, "
                         "box reduction + grid init, render), mirroring the "
                         "reference's per-stage event report; the default "
                         "fuses everything into one program")
    ns = ap.parse_args(argv)
    pos = ns.positionals

    from ..core.quirks import DEFAULT, REFERENCE, REFERENCE_LMEM
    from ..core.rng import make_key
    from .pam import ImgInfo, save_pam, film_to_rgba8
    from .profiling import StageTimer

    # superlmem + reference quirks additionally reproduces the lmem
    # binaries' shadow-trace &t aliasing (core/quirks.py::shadow_carry_t)
    if ns.quirks == "reference":
        quirks = REFERENCE_LMEM if ns.variant == "superlmem" else REFERENCE
    else:
        quirks = DEFAULT
    # the reference seeds from time/pid/clock/rdtsc (CLSuperPathTracer.c:209)
    seed = ns.seed if ns.seed is not None else (time.time_ns() & 0x7FFFFFFF)
    key = make_key(seed)
    print(f"Seed: {seed}")

    w = _positional(pos, 0, 512)
    h = _positional(pos, 1, 512)
    timer = StageTimer()
    out_name = ns.out or ("resultCPU.ppm" if ns.variant == "simplecpu"
                          else "result.ppm")

    # camera printout parity (CLSuperPathTracer.c:251)
    from ..core.camera import make_camera
    cam = make_camera(z_sign=1.0 if ns.variant == "simplecpu" else -1.0)
    print("Cam values:\nCam_forward %f %f %f\nCam_up %f %f %f\n"
          "Cam_right %f %f %f\n eye_offset %f %f %f"
          % (*cam.forward, *cam.up, *cam.right, *cam.eye_offset))

    if ns.variant == "simplecpu":
        from ..models.oracle import render_oracle
        w = _positional(pos, 0, 256)
        h = _positional(pos, 1, 256)
        t0 = time.perf_counter()
        film = render_oracle(w, h, spp=ns.spp, seed=seed, gpu_layout=False)
        timer.record("rendering (host)", (time.perf_counter() - t0) * 1e3,
                     items=w * h, item_label="float", data_size=w * h * 4)
    else:
        from .device import configure_compile_cache
        configure_compile_cache()
        _select_device()
        from ..scene.scene import load_scene

        def run_maybe_resumable(name, render_fn, scene_arg, **kw):
            """Either one fused render or checkpointed spp windows."""
            if not ns.checkpoint:
                return timer.run(
                    name,
                    lambda: render_fn(key, scene_arg, w, h, spp=ns.spp,
                                      quirks=quirks, **kw),
                    items=w * h, item_label="pixels", data_size=w * h * 4)
            from .checkpoint import render_resumable
            t0 = time.perf_counter()
            ck = render_resumable(render_fn, key, scene_arg, w, h, ns.spp,
                                  checkpoint_path=ns.checkpoint,
                                  spp_per_step=ns.spp_per_step, seed=seed,
                                  quirks=quirks, **kw)
            timer.record(f"{name} (checkpointed, {ck.spp_done} spp)",
                         (time.perf_counter() - t0) * 1e3,
                         items=w * h, item_label="pixels",
                         data_size=w * h * 4)
            return ck.film

        if ns.shard and (ns.profile_stages or ns.dynamic_grid_res):
            print("error: --shard is incompatible with "
                  "--profile-stages / --dynamic-grid-res", file=sys.stderr)
            return 1
        if ns.variant == "simple":
            from ..models.simple import render_simple
            if ns.shard:
                film, _ = _sharded_cli_render(ns, timer, key, None, w, h,
                                              quirks, pos, seed=seed)
                if film is None:
                    return 1
            else:
                film = run_maybe_resumable(
                    "rendering",
                    lambda k, _scene, ww, hh, **kw: render_simple(k, ww, hh,
                                                                  **kw),
                    None)
        else:
            try:
                scene = load_scene(ns.scene_dir, triangles=ns.triangles_file)
            except FileNotFoundError as e:
                # the reference crashes on a missing scene file (e.g. the
                # NoDoF variant opens a non-existent planes.txt, SURVEY.md
                # section 2 #7); fail with a message instead
                print(f"error: missing scene file: {e.filename} "
                      f"(looked in {ns.scene_dir!r}; need spheres.txt, "
                      "squares.txt, triangles.txt, lights.txt)",
                      file=sys.stderr)
                return 1
            print(f"Number of triangles: {scene.n_triangles}")
            print(f"Number of lights: {scene.n_lights}")
            if ns.shard:
                film, img = _sharded_cli_render(ns, timer, key, scene, w, h,
                                                quirks, pos, seed=seed)
                if film is None and img is None:
                    return 1
            elif ns.variant in ("super", "superlmem"):
                from ..models.super import render_super
                film = run_maybe_resumable("rendering", render_super, scene)
            elif ns.variant == "nodof":
                from ..models.sample_parallel import render_sample_parallel
                img = timer.run(
                    "rendering+reduction",
                    lambda: render_sample_parallel(key, scene, w, h,
                                                   sample_grid=8,
                                                   quirks=quirks),
                    items=w * h * 64, item_label="samples",
                    data_size=w * h * 64 * 16)
                film = None
            elif ns.variant == "trianglegrid":
                from ..models.trianglegrid import render_trianglegrid
                mod = _positional(pos, 2, 3.0, float)
                film = run_maybe_resumable("grid init + rendering",
                                           render_trianglegrid, scene,
                                           cell_size_modifier=mod)
            elif ns.variant == "bidirectional":
                n_vlp = _positional(pos, 2, 512)
                if ns.profile_stages:
                    film = _staged_vlp_render(
                        timer, key, scene, w, h, ns.spp, quirks,
                        kind="bpt", n_vlp=n_vlp)
                else:
                    from ..models.bidirectional import render_bidirectional
                    film = run_maybe_resumable("light pass + rendering",
                                               render_bidirectional, scene,
                                               n_vlp=n_vlp)
            elif ns.variant in ("metropolis", "metropolis_vlpgrid"):
                n_seed = _positional(pos, 2, 512)
                rounds = _positional(pos, 3, 8)
                mod = _positional(pos, 4, 3.0, float)
                use_grid = ns.variant.endswith("vlpgrid")
                if ns.profile_stages:
                    film = _staged_vlp_render(
                        timer, key, scene, w, h, ns.spp, quirks,
                        kind="mlt", n_seed=n_seed, rounds=rounds,
                        use_grid=use_grid, grid_modifier=mod,
                        dynamic_res=ns.dynamic_grid_res)
                else:
                    from ..models.metropolis import render_metropolis
                    film = run_maybe_resumable(
                        "light pass + metropolis + rendering",
                        render_metropolis, scene, n_seedpaths=n_seed,
                        mutation_rounds=rounds, use_grid=use_grid,
                        grid_modifier=mod,
                        dynamic_grid_res=ns.dynamic_grid_res)

    # Quantise on DEVICE when the film is still device-resident (as the
    # reference kernels do — convert_uchar4 in pathtracer.ocl:240): the
    # host transfer is then 4 bytes/px RGBA8 instead of 12 bytes/px f32,
    # which dominates per-call latency at CLI sizes.  Checkpoint-resumed
    # films arrive as host numpy and take the host path (bit-identical:
    # tests/test_pam.py pins device == host quantisation).
    import jax as _jax
    on_device = isinstance(film, _jax.Array) if ns.variant != "nodof" \
        else False
    if ns.variant == "nodof":
        rgba = np.asarray(img)
        if ns.pam_maxval == 65535:
            # the nodof reduce kernel emits RGBA8 (reduce4img_lmem,
            # ...NoDoF/pathtracer.ocl:268-271); widen exactly (255 -> 65535)
            rgba = rgba.astype(np.uint16) * np.uint16(257)
    elif ns.pam_maxval == 65535:
        if on_device:
            from ..ops.reduce import quantize_film16
            rgba = np.asarray(_jax.jit(quantize_film16)(film))
        else:
            from .pam import film_to_rgba16
            rgba = film_to_rgba16(np.asarray(film))
    elif on_device:
        from ..ops.reduce import quantize_film
        if ns.profile_stages:
            # reference stage: the blocking render map/read
            # (clEnqueueMapBuffer d_render, e.g. vlpgrid .c:662-668)
            rgba = timer.run(
                "read render data",
                lambda: np.asarray(
                    _jax.jit(quantize_film, static_argnames="wrap")(
                        film, wrap=quirks.wrap_uint8)),
                items=w * h * 4, item_label="uchar", data_size=w * h * 4)
        else:
            rgba = np.asarray(
                _jax.jit(quantize_film, static_argnames="wrap")(
                    film, wrap=quirks.wrap_uint8))
    else:
        rgba = film_to_rgba8(np.asarray(film), wrap=quirks.wrap_uint8)
    t0 = time.perf_counter()
    save_pam(out_name, ImgInfo(width=w, height=h, channels=4,
                               maxval=ns.pam_maxval,
                               depth=8 if ns.pam_maxval == 255 else 16,
                               data=rgba))
    timer.record("write render data", (time.perf_counter() - t0) * 1e3,
                 items=w * h * 4, item_label="uchar",
                 data_size=w * h * 4 * (1 if ns.pam_maxval == 255 else 2))
    print(f"\nSuccessfully created render image {out_name} in the current "
          "directory\n")
    timer.print_report()
    return 0


if __name__ == "__main__":
    sys.exit(main())

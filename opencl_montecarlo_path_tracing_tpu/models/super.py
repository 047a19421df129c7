"""Wavefront equivalent of CLSuperPathTracer / CLSuperPathTracer_lmem.

Reference: CLSuperPathTracer/pathtracer.ocl - adds squares, triangles
(Moller-Trumbore), multiple point lights with inverse-square falloff and
soft shadows, 5-material shading; scene from text files.  The _lmem variant
(SURVEY.md section 2 #6) differs only in work-group caching (the fused kernel,
ops/pallas_super.py, reads its scene tables through the cache), and in an
accidental aliasing of the running hit distance into the shadow trace
(CLSuperPathTracer_lmem/pathtracer.ocl:178), reproduced behind
``quirks.shadow_carry_t`` (CLI ``superlmem --quirks reference``).

Estimator details preserved (pathtracer.ocl:139-218):
 * per light: jittered direction, lambertian factor, hard shadow test with an
   *uncapped* shadow ray (a hit beyond the light still occludes, ocl:180),
   inverse-square clamp min(I/d^2, 1)
 * total_illumination accumulates ACROSS bounces without reset (declared
   outside the loop, ocl:153), is clamped to 1 and divided by 4 each bounce
 * materials: 1 floor checker, 3 diffuse (2,3,2), 4 facing-ratio (scalar
   broadcast onto rgb), 2 mirror bounce (dead code on the shipped scenes -
   spheres are material 3 here)
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from ..core.camera import make_camera, primary_rays
from ..ops.intersect import SceneArrays, prep_scene, trace_ray, any_hit
from ..ops import pallas_super as _kernel
from ..scene.scene import Scene
from . import common as C


def illum_direct(key, scn: SceneArrays, quirks: Quirks, tri_override,
                 b, x, normal, shading, total_illum, ray_id, t_hit=None):
    """Direct illumination with jittered soft shadows - the super tracer's
    light loop (pathtracer.ocl:167-191).  Returns the updated cross-bounce
    total_illumination and the last light direction (consumed by the mirror
    branch's highlight, ocl:211).

    All shadow rays are batched into ONE occlusion trace so the (expensive)
    primitive scan is instantiated once per bounce.  Under
    ``quirks.shadow_carry_t`` (the _lmem binaries' ``&t`` aliasing,
    CLSuperPathTracer_lmem/pathtracer.ocl:178) the traces are instead
    sequential per light: each starts from the carried distance ``t_hit``
    (the primary hit's t) and, when actually executed (lamb >= 0 - the
    reference short-circuits ``lamb_f < 0 || TraceRay(...)``), overwrites
    the carry with its own closest hit.
    """
    nlights = int(scn.lights.shape[0])
    last_ldir = jnp.zeros_like(x)  # overwritten by any light w/ intensity != 0
    ldirs = []
    for i in range(nlights):
        lp = scn.lights[i, :3]
        u1, u2 = rngmod.rand2(
            key, ray_id,
            C.SITE_LIGHT0 + b * np.uint32(C.SITE_STRIDE_BOUNCE) + np.uint32(i))
        jitter = jnp.stack([u1, u2, jnp.zeros_like(u1)], axis=-1)
        # reference skips lights with intensity == 0 (ocl:171) BEFORE
        # updating light_dir; scenes ship none, and intensity is a
        # host-static scalar here, so the draw above matches draw order.
        ldirs.append(C.normalize(lp + jitter - x))
    if nlights and quirks.shadow_carry_t:
        t_run = (jnp.broadcast_to(jnp.float32(1e9), x.shape[:-1])
                 if t_hit is None else t_hit)
        occ_rows = []
        for i in range(nlights):
            tr_s = trace_ray(x, ldirs[i], scn, t_init=t_run, quirks=quirks,
                             sphere_material=3, tri_override=tri_override)
            occ_rows.append(tr_s.material != 0)
            lamb = C.dot(ldirs[i], normal)
            t_run = jnp.where(lamb < 0, t_run, tr_s.t)
        occ_all = jnp.stack(occ_rows, axis=0)
    elif nlights:
        xs = jnp.concatenate([x] * nlights, axis=0)
        ds = jnp.concatenate(ldirs, axis=0)
        if tri_override is None:
            occ_all = any_hit(xs, ds, scn, quirks=quirks)
        else:
            occ_all = trace_ray(xs, ds, scn, quirks=quirks,
                                sphere_material=3,
                                tri_override=tri_override).material != 0
        occ_all = occ_all.reshape(nlights, -1)
    for i in range(nlights):
        lp = scn.lights[i, :3]
        intensity = scn.lights[i, 3]
        ldir = ldirs[i]
        lamb = C.dot(ldir, normal)
        occ = occ_all[i].reshape(lamb.shape)
        dist2 = jnp.sum((lp - x) ** 2, axis=-1)
        contrib = jnp.where(
            (lamb < 0) | occ, 0.0,
            lamb * jnp.minimum(intensity / dist2, 1.0))
        total_illum = jnp.where(shading, total_illum + contrib, total_illum)
        last_ldir = ldir

    total_illum = jnp.where(shading, jnp.minimum(total_illum, 1.0) / 4.0,
                            total_illum)
    return total_illum, last_ldir


def sample_super(key, scn: SceneArrays, quirks: Quirks, max_bounces: int,
                 s, ii, jj, ray_id, tri_override=None, illum_fn=None):
    """One camera sample per pixel on the full scene; returns (R, 3).

    ``tri_override`` replaces the brute-force triangle scan (e.g. with the
    uniform-grid DDA, models/trianglegrid.py); shadow rays then also use it,
    matching the reference where the grid serves every TraceRay
    (trianglegrid/pathtracer.ocl:245).

    ``illum_fn(b, x, normal, shading, total_illum, ray_id, t_hit) ->
    (total_illum, last_ldir)`` replaces the direct-light loop - the
    bidirectional/metropolis integrators plug their VLP gathers in here
    (models/bidirectional.py, models/metropolis.py); ``t_hit`` is the
    primary trace's hit distance (consumed only by the _lmem
    ``shadow_carry_t`` quirk)."""
    r1, r2, r3, r4 = rngmod.randn_draws(key, ray_id, C.SITE_CAMERA, 4)
    cam = make_camera(z_sign=-1.0)
    o, d = primary_rays(cam, ii, jj, r1, r2, r3, r4)

    R = ray_id.shape
    zero3 = jnp.zeros(R + (3,), jnp.float32)
    state = (
        jnp.ones(R, bool),         # alive
        o, d,
        zero3,                     # colorFact
        jnp.ones(R, jnp.float32),  # divFact
        jnp.zeros(R, jnp.float32), # total_illumination (carried across bounces)
        zero3,                     # result
    )
    if illum_fn is None:
        illum_fn = functools.partial(illum_direct, key, scn, quirks,
                                     tri_override)

    def step(b, state):
        alive, o, d, color_fact, div, total_illum, result = state
        tr = trace_ray(o, d, scn, quirks=quirks, sphere_material=3,
                       tri_override=tri_override)
        m = jnp.where(alive, tr.material, -1)

        sky = color_fact + C.sky_color(d[..., 2]) / div[..., None]
        result = jnp.where((m == 0)[..., None], sky, result)

        x = o + d * tr.t[..., None]
        shading = alive & (tr.material != 0)

        total_illum, last_ldir = illum_fn(b, x, tr.normal, shading,
                                          total_illum, ray_id, tr.t)

        fl = color_fact + C.floor_color(x) * total_illum[..., None] / div[..., None]
        result = jnp.where((m == 1)[..., None], fl, result)

        df = color_fact + C.DIFFUSE * total_illum[..., None] / div[..., None]
        result = jnp.where((m == 3)[..., None], df, result)

        # facing ratio: scalar max(0, n.-d)/divFact broadcast onto rgb
        # (pathtracer.ocl:204 adds a float to a float4)
        fr = color_fact + (jnp.maximum(0.0, C.dot(tr.normal, -d)) / div)[..., None]
        result = jnp.where((m == 4)[..., None], fr, result)

        # mirror bounce (dead on shipped scenes; kept for parity, ocl:209-216)
        bounce = m == 2
        half = C.reflect(d, tr.normal)
        spec = C.pow99(C.dot(last_ldir, half) * (total_illum > 0))
        hl = spec[..., None] * (div[..., None] if quirks.specular_divfact_multiply
                                else 1.0 / div[..., None])
        color_fact = jnp.where(bounce[..., None], color_fact + hl, color_fact)
        o = jnp.where(bounce[..., None], x, o)
        d = jnp.where(bounce[..., None], half, d)
        div = jnp.where(bounce, div * 2.0, div)
        alive = alive & bounce
        return alive, o, d, color_fact, div, total_illum, result

    # the super family's mirror branch is unreachable (spheres are material
    # 3, pathtracer.ocl:103), so no ray survives bounce 1: run exactly one
    # iteration instead of relying on dynamic loop termination.
    final = C.bounce_loop(step, state, min(max_bounces, 1))
    alive, _, _, color_fact, _, _, result = final
    return jnp.where(alive[..., None], color_fact, result)


def film_super(key, scn: SceneArrays, width, height, spp, spp_offset,
               spp_total, quirks, max_bounces=C.MAX_BOUNCES,
               row_offset=0, rows=None):
    """Unjitted film body (pre-ambient (rows, W, 3) float32).

    ``scn`` is a *numpy* SceneArrays whose values are baked into the trace
    as literals (the key to fusing the primitive scan - see ops/intersect).
    ``spp_offset``/``row_offset`` may be traced values - the sharded
    renderers pass axis_index-derived offsets (parallel/mesh.py).

    Programs lowered for CUDA run the covered family (ops/pallas_super.py
    ``supported``) as one fused Pallas kernel; every other platform, and
    every render outside that family, runs the XLA wavefront below.  The
    choice is made when the program is lowered (``platform_dependent``)."""
    def xla():
        sample_fn = functools.partial(sample_super, key, scn, quirks,
                                      max_bounces)
        return C.accumulate_spp(sample_fn, width, height, spp,
                                spp_offset=spp_offset, spp_total=spp_total,
                                row_offset=row_offset, rows=rows)

    if not _kernel.supported(scn, max_bounces):
        return xla()

    def fused():
        return _kernel.film_super_kernel(key, scn, width, height, spp,
                                         spp_offset, spp_total, quirks,
                                         row_offset, rows)

    return jax.lax.platform_dependent(cuda=fused, default=xla)


# compiled-render cache: the scene is a compile-time constant, so jitted
# programs are cached per (scene fingerprint, render config)
_COMPILED: dict = {}


def render_super(key, scene: Scene | SceneArrays, width: int = 512,
                 height: int = 512, spp: int = 64,
                 spp_offset: int = 0, spp_total: int | None = None,
                 quirks: Quirks = DEFAULT, max_bounces: int = C.MAX_BOUNCES):
    """Render the full scene; returns the pre-ambient float film (H, W, 3)."""
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if spp_total is None:
        spp_total = spp
    cfg = (scn.fingerprint(), width, height, spp, spp_offset, spp_total,
           quirks, max_bounces)
    fn = _COMPILED.get(cfg)
    if fn is None:
        fn = jax.jit(lambda k: film_super(k, scn, width, height, spp,
                                          spp_offset, spp_total, quirks,
                                          max_bounces))
        _COMPILED[cfg] = fn
    return fn(key)

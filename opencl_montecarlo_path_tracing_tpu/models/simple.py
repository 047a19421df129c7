"""Wavefront equivalent of CLSimplePathTracer (and the CPU oracle's scene).

Reference: CLSimplePathTracer/spt.ocl - per-pixel megakernel, 64 spp, 5
unrolled bounces, bitmap spheres are mirrors (material 2, spt.ocl:68), floor
is a lambertian checkerboard, sky above.  Single implicit jittered light at
(9 + r1, 9 + r2, 16) (spt.ocl:99).

Here: one ray batch per sample and a static 5-iteration bounce loop with
live masks (spheres genuinely multi-bounce; 5 matches the reference's
recursion cap, spt.ocl:89).
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
from ..scene.scene import simple_scene
from . import common as C


def _sample(key, scn: SceneArrays, quirks: Quirks, max_bounces: int,
            s, ii, jj, ray_id):
    """One sample for every pixel; returns (R, 3) color."""
    r1, r2, r3, r4 = rngmod.randn_draws(key, ray_id, C.SITE_CAMERA, 4)
    cam = make_camera(z_sign=-1.0)
    o, d = primary_rays(cam, ii, jj, r1, r2, r3, r4)

    R = ray_id.shape
    zero3 = jnp.zeros(R + (3,), jnp.float32)
    state = (
        jnp.ones(R, bool),        # alive
        o, d,
        zero3,                    # colorFact
        jnp.ones(R, jnp.float32), # divFact
        zero3,                    # result
    )

    def step(b, state):
        alive, o, d, color_fact, div, result = state
        tr = trace_ray(o, d, scn, quirks=quirks, sphere_material=2)
        m = jnp.where(alive, tr.material, -1)

        # miss -> sky (spt.ocl:92-95)
        sky = color_fact + C.sky_color(d[..., 2]) / div[..., None]
        result = jnp.where((m == 0)[..., None], sky, result)

        x = o + d * tr.t[..., None]
        u1, u2 = rngmod.rand2(key, ray_id,
                              C.SITE_LIGHT0 + b * np.uint32(C.SITE_STRIDE_BOUNCE))
        light_pos = jnp.stack([9.0 + u1, 9.0 + u2,
                               jnp.full(u1.shape, 16.0, jnp.float32)], axis=-1)
        ldir = C.normalize(light_pos - x)
        half = C.reflect(d, tr.normal)
        lamb = C.dot(ldir, tr.normal)
        shadowed = any_hit(x, ldir, scn, quirks=quirks)
        lamb = jnp.where((lamb < 0) | shadowed, 0.0, lamb)
        spec = C.pow99(C.dot(ldir, half) * (lamb > 0))

        # floor -> checkerboard * (lamb*0.2 + 0.1) (spt.ocl:112-115)
        fl = color_fact + C.floor_color(x) * (lamb * 0.2 + 0.1)[..., None] / div[..., None]
        result = jnp.where((m == 1)[..., None], fl, result)

        # mirror sphere -> add specular highlight, bounce (spt.ocl:120-125)
        bounce = m == 2
        hl = spec[..., None] * (div[..., None] if quirks.specular_divfact_multiply
                                else 1.0 / div[..., None])
        color_fact = jnp.where(bounce[..., None], color_fact + hl, color_fact)
        o = jnp.where(bounce[..., None], x, o)
        d = jnp.where(bounce[..., None], half, d)
        div = jnp.where(bounce, div * 2.0, div)
        alive = alive & bounce
        return alive, o, d, color_fact, div, result

    alive, _, _, color_fact, _, result = C.bounce_loop(step, state, max_bounces)
    # recursion-cap exhaustion: reference falls off the end of Sample (UB,
    # spt.ocl:89-127); intended math returns the accumulated highlights.
    return jnp.where(alive[..., None], color_fact, result)


def film_simple(key, width, height, spp, spp_offset, spp_total,
                quirks: Quirks = DEFAULT, max_bounces: int = C.MAX_BOUNCES):
    """Unjitted film body (pre-ambient (H, W, 3) float32).

    ``spp_offset`` may be a traced value - the sharded renderer passes an
    axis_index-derived sample-window offset (parallel/mesh.py), exactly as
    film_super does."""
    if spp_total is None:
        spp_total = spp
    scn = prep_scene(simple_scene())
    sample_fn = functools.partial(_sample, key, scn, quirks, max_bounces)
    return C.accumulate_spp(sample_fn, width, height, spp,
                            spp_offset=spp_offset, spp_total=spp_total)


@functools.partial(jax.jit, static_argnames=("width", "height", "spp",
                                             "spp_offset", "spp_total",
                                             "quirks", "max_bounces"))
def render_simple(key, width: int = 512, height: int = 512, spp: int = 64,
                  spp_offset: int = 0, spp_total: int | None = None,
                  quirks: Quirks = DEFAULT, max_bounces: int = C.MAX_BOUNCES):
    """Render the business-card scene; returns the pre-ambient float film
    (H, W, 3).  Finalize with utils.pam.film_to_rgba8."""
    return film_simple(key, width, height, spp, spp_offset, spp_total,
                       quirks, max_bounces)

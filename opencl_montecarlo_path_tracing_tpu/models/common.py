"""Shared wavefront machinery for all integrators.

The reference renders with per-pixel megakernels (64-spp loop x 5-bounce
unrolled recursion per work item, e.g. pathtracer.ocl:220-241).  Here every
integrator is a *wavefront*: one flat ray batch per sample pass, a
``lax.fori_loop`` with a STATIC bounce count and live-ray masks (see
``bounce_loop`` below; callers that know a scene cannot bounce pass
max_bounces=1), and a film accumulator.  Everything stays jit-resident;
there is no host sync per bounce or per sample.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

AMBIENT = np.float32(13.0)    # base radiance (pathtracer.ocl:224)
EXPOSURE = np.float32(3.5)    # per-sample scale (pathtracer.ocl:237)
MAX_BOUNCES = 5               # unrolled recursion depth (pathtracer.ocl:156)
SKY = np.array([0.7, 0.6, 1.0], np.float32)   # pathtracer.ocl:160
FLOOR_RED = np.array([3, 1, 1], np.float32)   # checkerboard (ocl:197)
FLOOR_WHITE = np.array([3, 3, 3], np.float32)
DIFFUSE = np.array([2, 3, 2], np.float32)     # material 3 (ocl:200)

# RNG draw-site map (see core/rng.py): sites must be unique per logical draw.
SITE_CAMERA = 0
SITE_LIGHT0 = 2          # + bounce * 8 + light_index   (light jitter draws)
SITE_STRIDE_BOUNCE = 8   # supports up to 8 lights/bounce (MAX_LIGHTS is 5)


def normalize(v):
    return v / jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def pow99(x):
    """x**99 for float32 via binary exponentiation (99 = 64+32+2+1).

    The reference uses OpenCL pow(x, 99) on a base that can be negative
    (spt.ocl:110); an odd integer power preserves sign, which exp/log-based
    pow does not. 7 multiplies, exact sign semantics.
    """
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    x16 = x8 * x8
    x32 = x16 * x16
    x64 = x32 * x32
    return x64 * x32 * x2 * x


def sky_color(dz):
    """(0.7, 0.6, 1) * (1 - dz)^4 (pathtracer.ocl:160)."""
    f = (1.0 - dz)
    f2 = f * f
    return SKY * (f2 * f2)[..., None]


def floor_color(x):
    """Checkerboard: intersection*0.2, (int)(ceil+ceil)&1 (pathtracer.ocl:196-197)."""
    ip = x * np.float32(0.2)
    sel = (jnp.ceil(ip[..., 0]) + jnp.ceil(ip[..., 1])).astype(jnp.int32) & 1
    return jnp.where((sel == 1)[..., None], FLOOR_RED, FLOOR_WHITE)


def reflect(d, n):
    """half_vec = d - 2 (n.d) n (pathtracer.ocl:210)."""
    return d + n * (dot(n, d) * (-2.0))[..., None]


def pixel_grid(width: int, height: int, row_offset=0, rows: int | None = None):
    """Flattened pixel coordinate arrays (i = x/gid0, j = y/gid1), row-major
    so film.reshape(rows, W) matches img[j*W + i].  ``row_offset`` (may be a
    traced value) and ``rows`` select a horizontal band - the unit of
    image-axis sharding."""
    if rows is None:
        rows = height
    jj, ii = jnp.meshgrid(jnp.arange(rows, dtype=jnp.float32),
                          jnp.arange(width, dtype=jnp.float32), indexing="ij")
    jj = jj + jnp.asarray(row_offset, jnp.float32)
    return ii.reshape(-1), jj.reshape(-1)


def accumulate_spp(sample_fn, width: int, height: int, spp: int,
                   spp_offset: int = 0, spp_total: int | None = None,
                   row_offset=0, rows: int | None = None,
                   unroll: int = 1):
    """Run ``sample_fn(sample_index, i, j, ray_id) -> (R, 3)`` for
    ``spp`` samples and return the pre-ambient film (rows, W, 3) float32
    (sum of samples * EXPOSURE, matching pathtracer.ocl:237).

    ``spp_offset``/``spp_total`` define the global sample-index window and
    ``row_offset``/``rows`` the image band, so a render sharded over spp
    and/or image rows reproduces the single-device image bit-for-bit
    (counter-based RNG keyed on pixel * spp_total + sample).
    """
    if spp_total is None:
        spp_total = spp
    if rows is None:
        rows = height
    ii, jj = pixel_grid(width, height, row_offset, rows)
    pixel_index = (jj * width + ii).astype(jnp.uint32)
    stride = jnp.uint32(spp_total)

    def body(s, film):
        s32 = jnp.uint32(s) + jnp.uint32(spp_offset)
        ray_id = pixel_index * stride + s32
        color = sample_fn(s32, ii, jj, ray_id)
        return film + color

    film = jax.lax.fori_loop(0, spp, body,
                             jnp.zeros((width * rows, 3), jnp.float32),
                             unroll=unroll)
    return (film * EXPOSURE).reshape(rows, width, 3)


def bounce_loop(step_fn, init_state, max_bounces: int = MAX_BOUNCES):
    """for b in range(max_bounces): state = step_fn(b, state) - a fori_loop
    with live-ray masks.

    The trip count is STATIC: a ``while (any(alive))`` condition would put
    a reduction over a loop-carried array into the loop condition, which
    the compiler cannot schedule ahead.  Callers that know a scene cannot
    bounce (the whole "super" family - the mirror branch is dead code,
    SURVEY.md section 2.10) pass max_bounces=1 instead of relying on
    dynamic termination.
    """
    def body(b, state):
        return step_fn(jnp.uint32(b), state)

    return jax.lax.fori_loop(0, max_bounces, body, init_state)

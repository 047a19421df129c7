"""Sample-parallel tracer + on-device film reduction (the NoDoF variant).

Reference: CLSuperPathTracer_lmem_NoDoF (SURVEY.md section 2 #7) restructures
spp as a *spatial* decomposition: gws = (W*8, H*8), one work item computes
ONE sample (pixel = gid >> 3) into a float4 temp buffer, and a second kernel
``reduce4img_lmem`` tree-reduces the 8x8 = 64 samples per pixel, adds the
ambient term and converts to uchar4 (pathtracer.ocl:217-274).

Here, samples are simply a batch axis: this variant materialises the whole
(H*sg, W*sg) sample buffer in one wavefront pass (one camera-jitter draw per
sample - exactly the reference's "no per-spp DoF loop" behaviour, which is
also how every sample behaves in our other integrators) and reduces it with
ops/reduce.py - producer and reducer fused under one jit, no event chain.
The reference's shipped directory opens a non-existent planes.txt
(CLSuperPathTracer.c:303, crashes); we load squares.txt as intended.

RNG streams use the same (pixel*spp + sample) keying as render_super, so at
sample_grid=8 the summed film equals render_super(spp=64) bit-for-bit - a
tested invariant (the reference could not make this claim: its two layouts
produce different images because streams are keyed on work-item ids).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.quirks import Quirks, DEFAULT
from ..ops.intersect import SceneArrays, prep_scene
from ..ops import pallas_super as _kernel
from ..ops.reduce import quantize_film, reduce_samples
from ..scene.scene import Scene
from . import common as C
from .super import sample_super


def sample_buffer(key, scn: SceneArrays, width, height, sample_grid,
                  quirks, max_bounces=C.MAX_BOUNCES, row_offset=0,
                  rows: int | None = None):
    """(rows*sg, W*sg, 3) float32: each slot = Sample(...) * 3.5 for one
    sample of its pixel (pathtracer.ocl:249).

    ``row_offset`` (may be traced) and ``rows`` select a horizontal band of
    *pixel* rows - the unit of image-axis sharding (parallel/mesh.py).  Ray
    ids stay keyed on the global pixel index, so band content is identical
    to the corresponding slice of the full buffer."""
    sg = sample_grid
    spp = sg * sg
    if rows is None:
        rows = height
    bigw, bigh = width * sg, rows * sg
    jj, ii = jnp.meshgrid(jnp.arange(bigh, dtype=jnp.int32),
                          jnp.arange(bigw, dtype=jnp.int32), indexing="ij")
    jj = jj + jnp.asarray(row_offset, jnp.int32) * sg
    px = (ii // sg).astype(jnp.float32).reshape(-1)
    py = (jj // sg).astype(jnp.float32).reshape(-1)
    s = ((ii % sg) + (jj % sg) * sg).astype(jnp.uint32).reshape(-1)
    pixel_index = (py * width + px).astype(jnp.uint32)
    ray_id = pixel_index * jnp.uint32(spp) + s
    colors = sample_super(key, scn, quirks, max_bounces, s, px, py, ray_id)
    return (colors * C.EXPOSURE).reshape(bigh, bigw, 3)


_COMPILED: dict = {}


def render_sample_parallel(key, scene: Scene | SceneArrays, width: int = 512,
                           height: int = 512, sample_grid: int = 8,
                           quirks: Quirks = DEFAULT,
                           max_bounces: int = C.MAX_BOUNCES,
                           return_samples: bool = False):
    """Returns the final (H, W, 4) uint8 image (and optionally the float
    sample buffer). The whole pipeline - sampling and reduction - runs as
    one device program.

    Programs lowered for CUDA (when the full sample buffer is not
    requested) render the film with the fused super kernel
    (ops/pallas_super.py) and quantize it: ray ids are keyed (pixel*spp +
    sample) in both layouts, so the kernel's spp accumulation computes the
    same per-pixel sum as reduce_samples' tree, to float summation order
    (within-pixel reassociation can flip a uint8 on an exact integer
    boundary; tests/test_pallas_super.py pins the <= 1 step bound)."""
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    cfg = (scn.fingerprint(), width, height, sample_grid, quirks,
           max_bounces, return_samples)
    fn = _COMPILED.get(cfg)
    if fn is None:
        def run(k):
            buf = sample_buffer(k, scn, width, height, sample_grid, quirks,
                                max_bounces)
            img = reduce_samples(buf, sample_grid, wrap=quirks.wrap_uint8)
            return (img, buf) if return_samples else img

        def fused(k):
            film = _kernel.film_super_kernel(k, scn, width, height,
                                             sample_grid * sample_grid,
                                             quirks=quirks)
            return quantize_film(film, wrap=quirks.wrap_uint8)

        if return_samples or not _kernel.supported(scn, max_bounces):
            fn = jax.jit(run)
        else:
            fn = jax.jit(lambda k: jax.lax.platform_dependent(
                k, cuda=fused, default=run))
        _COMPILED[cfg] = fn
    return fn(key)

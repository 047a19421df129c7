"""Bidirectional (VPL) tracer - CLSuperBidirectionalPathTracer.

Reference pipeline (SURVEY.md section 3.4): pass 1 ``lightTracer`` emits one
virtual point light per (work item, scene light); pass 2 ``pathTracer``
gathers ALL VLPs per shading point with no shadow rays (the occlusion test
is commented out, bidirectionalpathtracer.ocl:179-182), then subtracts a
soft-shadow correction of 1/nlights per occluded real light (ocl:191-201).
The two passes are chained by an OpenCL event (.c:237-238); here they are
plain function composition inside one jit - the VLP buffer never leaves the
device.

Illumination order per bounce (ocl:166-202): VLP gather accumulates into the
cross-bounce total_illumination, clamp to 1, subtract shadow corrections
(can go negative - faithful), then /= 4.  The correction's shadow ray is
capped at the UN-jittered light distance (t = distanceFromLight before the
jittered direction is traced, ocl:195-197).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from ..ops.intersect import SceneArrays, prep_scene, trace_ray, any_hit
from ..ops import vlp as vlpmod
from ..scene.scene import Scene
from . import common as C
from .super import sample_super


def illum_vlp(key, scn: SceneArrays, quirks: Quirks, vlps, grid,
              tri_override, b, x, normal, shading, total_illum, ray_id,
              t_hit=None):
    """VLP gather + real-light soft-shadow correction (ocl:166-202).

    ``t_hit`` is unused: the bidirectional kernels initialise their shadow
    trace's t to the light distance themselves (ocl:195-197), so there is no
    _lmem-style carry to reproduce here."""
    nlights = int(scn.lights.shape[0])

    if grid is None:
        vi = vlpmod.gather_vlps(x, normal, vlps)
    else:
        vi = vlpmod.gather_vlps_grid(x, normal, vlps, grid)
    total_illum = jnp.where(shading, total_illum + vi, total_illum)
    total_illum = jnp.where(shading, jnp.minimum(total_illum, 1.0),
                            total_illum)

    # soft-shadow correction with the real lights (ocl:191-201)
    last_ldir = jnp.zeros_like(x)
    ldirs = []
    dists = []
    for i in range(nlights):
        lp = scn.lights[i, :3]
        u1, u2 = rngmod.rand2(
            key, ray_id,
            C.SITE_LIGHT0 + b * np.uint32(C.SITE_STRIDE_BOUNCE) + np.uint32(i))
        jitter = jnp.stack([u1, u2, jnp.zeros_like(u1)], axis=-1)
        ldirs.append(C.normalize(lp + jitter - x))
        dists.append(jnp.sqrt(jnp.sum((lp - x) ** 2, axis=-1)))
    if nlights:
        xs = jnp.concatenate([x] * nlights, axis=0)
        ds = jnp.concatenate(ldirs, axis=0)
        tl = jnp.concatenate(dists, axis=0)
        if tri_override is None:
            occ_all = any_hit(xs, ds, scn, t_limit=tl, quirks=quirks)
        else:
            occ_all = trace_ray(xs, ds, scn, t_init=tl, quirks=quirks,
                                sphere_material=3,
                                tri_override=tri_override).material != 0
        occ_all = occ_all.reshape(nlights, -1)
        for i in range(nlights):
            occ = occ_all[i].reshape(x.shape[0])
            total_illum = jnp.where(shading & occ,
                                    total_illum - np.float32(1.0 / nlights),
                                    total_illum)
            last_ldir = ldirs[i]

    total_illum = jnp.where(shading, total_illum / 4.0, total_illum)
    return total_illum, last_ldir


def film_bidirectional(key, scn: SceneArrays, width, height, spp, spp_offset,
                       spp_total, n_vlp, quirks,
                       max_bounces=C.MAX_BOUNCES, use_grid: bool = False,
                       grid_modifier: float = 3.0, precomputed_vlps=None,
                       precomputed_grid=None, row_offset=0, rows=None):
    """Both passes under one program: emit VLPs, (optionally) build the VLP
    grid on device, render.  ``precomputed_vlps``/``precomputed_grid`` let a
    caller stage the pipeline (per-stage profiling parity with the
    reference's event timing); by default everything fuses into one jit."""
    vlps = (precomputed_vlps if precomputed_vlps is not None
            else vlpmod.emit_vlps(key, scn, n_vlp, quirks))
    grid = precomputed_grid
    if use_grid and grid is None:
        res = vlpmod.vlp_grid_static_res(int(vlps.shape[0]), grid_modifier)
        grid = vlpmod.build_vlp_grid(vlps, res)
    illum = functools.partial(illum_vlp, key, scn, quirks, vlps, grid, None)
    sample_fn = functools.partial(sample_super, key, scn, quirks, max_bounces,
                                  illum_fn=illum)
    return C.accumulate_spp(sample_fn, width, height, spp,
                            spp_offset=spp_offset, spp_total=spp_total,
                            row_offset=row_offset, rows=rows)


_COMPILED: dict = {}


def render_bidirectional(key, scene: Scene | SceneArrays, width: int = 512,
                         height: int = 512, spp: int = 64,
                         n_vlp: int = 512,
                         spp_offset: int = 0, spp_total: int | None = None,
                         quirks: Quirks = DEFAULT,
                         max_bounces: int = C.MAX_BOUNCES,
                         use_grid: bool = False,
                         grid_modifier: float = 3.0):
    """Render with VPL light transport; returns the pre-ambient film.
    ``n_vlp`` mirrors the reference CLI's N_VLP-per-light (default 512,
    .c:246)."""
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if spp_total is None:
        spp_total = spp
    cfg = (scn.fingerprint(), width, height, spp, spp_offset, spp_total,
           n_vlp, quirks, max_bounces, use_grid, grid_modifier)
    fn = _COMPILED.get(cfg)
    if fn is None:
        fn = jax.jit(lambda k: film_bidirectional(
            k, scn, width, height, spp, spp_offset, spp_total, n_vlp,
            quirks, max_bounces, use_grid, grid_modifier))
        _COMPILED[cfg] = fn
    return fn(key)

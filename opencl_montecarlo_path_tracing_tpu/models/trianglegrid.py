"""Uniform-grid accelerated tracer (CLSuperPathTracer_trianglegrid).

Reference pipeline (SURVEY.md section 3.3): parse triangles + global AABB ->
host computes grid resolution (cbrt heuristic) -> device ``initTrianglesGrid``
scatters triangles with atomics -> pathTracer runs a 3-D DDA inside TraceRay.

Rebuild: the grid is built once per scene by a deterministic sort-based
binning (ops/grid.py, no atomics), then every TraceRay (primary and shadow)
walks it with the masked-DDA traversal.  Estimator math is identical to the
super tracer; CLI adds CELL_SIZE_MODIFIER (default 3.0,
trianglegrid/CLSuperPathTracer.c:383-398).
"""

from __future__ import annotations

import functools

import jax

from ..core.quirks import Quirks, DEFAULT
from ..ops.intersect import SceneArrays, prep_scene
from ..ops import grid as gridmod
from ..scene.scene import Scene
from . import common as C
from .super import sample_super


def film_trianglegrid(key, scn: SceneArrays, grid, width, height, spp,
                      spp_offset, spp_total, quirks,
                      max_bounces=C.MAX_BOUNCES):
    tri_override = functools.partial(
        _override, scn=scn, grid=grid, quirks=quirks)
    sample_fn = functools.partial(sample_super, key, scn, quirks, max_bounces,
                                  tri_override=tri_override)
    return C.accumulate_spp(sample_fn, width, height, spp,
                            spp_offset=spp_offset, spp_total=spp_total)


def _override(o, d, t, m, nx, ny, nz, needs, *, scn, grid, quirks):
    return gridmod.traverse_triangles(o, d, t, m, nx, ny, nz, needs,
                                      scn, grid, quirks)


_COMPILED: dict = {}


def render_trianglegrid(key, scene: Scene | SceneArrays, width: int = 512,
                        height: int = 512, spp: int = 64,
                        cell_size_modifier: float = 3.0,
                        spp_offset: int = 0, spp_total: int | None = None,
                        quirks: Quirks = DEFAULT,
                        max_bounces: int = C.MAX_BOUNCES,
                        device_build: bool = True):
    """Render via the uniform-grid DDA (ops/grid.py::traverse_triangles);
    returns the pre-ambient film.

    The image is identical to brute force by contract (the reference's
    grid only accelerates TraceRay, it never changes the estimator;
    test_grid.py pins DDA == brute bit-equality).  CELL_SIZE_MODIFIER only
    affects the grid build, never the image.
    """
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if spp_total is None:
        spp_total = spp
    cfg = (scn.fingerprint(), width, height, spp, spp_offset, spp_total,
           quirks, max_bounces, cell_size_modifier, device_build)
    fn = _COMPILED.get(cfg)
    if fn is None:
        def build_and_render(k):
            grid, _box = gridmod.triangle_grid(
                scn, modifier=cell_size_modifier, device=device_build)
            return film_trianglegrid(k, scn, grid, width, height, spp,
                                     spp_offset, spp_total, quirks,
                                     max_bounces)
        fn = jax.jit(build_and_render) if device_build else None
        if fn is None:
            # host build happens once outside jit
            grid, _box = gridmod.triangle_grid(
                scn, modifier=cell_size_modifier, device=False)
            import jax.numpy as jnp
            grid = gridmod.UniformGrid(
                items=jnp.asarray(grid.items), counts=jnp.asarray(grid.counts),
                res=grid.res, vmin=jnp.asarray(grid.vmin),
                cell_size=jnp.asarray(grid.cell_size))
            fn = jax.jit(lambda k: film_trianglegrid(
                k, scn, grid, width, height, spp, spp_offset, spp_total,
                quirks, max_bounces))
        _COMPILED[cfg] = fn
    return fn(key)

"""Fused super sample step: one Pallas kernel, compiled through Triton.

The reference renders each pixel with one OpenCL work-item that runs the
whole spp loop in registers: camera ray, the TraceRay scan over floor,
squares, spheres and triangles, one shadow ray per light, shading
(CLSuperPathTracer/pathtracer.ocl:220-241).  This kernel has the same
shape.  Each program takes a tile of ``block`` pixels and runs, for every
sample: the threefry draws (core/rng.py), the thin-lens camera
(core/camera.py::primary_rays_xyz), the brute-force closest-hit scan, the
shadow rays (uncapped any-hit by default; under the _lmem carry-t quirk,
sequential closest-hit traces seeded with the carried distance) and the
4-material shading.  The film tile stays in registers across the spp loop
and is written to device memory once; no ray state touches HBM.

The scans are the XLA path's own functions (ops/intersect.py::
closest_hit_xyz / occluded_xyz), run here on one tile: the kernel reads
sphere and triangle rows from its inputs by scalar loads inside the scans'
``fori_loop`` (``PrimTables`` accessors), so one code path serves every
mesh size.  Squares and lights are compile-time constants, as they are on
the XLA path.

Arithmetic is approximate, as the compiled PTX shows: divisions lower to
``arith.divf``, which Triton emits as ``div.full.f32`` (within 2 ulp);
square roots call libdevice ``__nv_sqrtf``, which Triton's flags turn
into ``sqrt.approx.f32``; the sphere-normal ``rsqrt`` is
``rsqrt.approx.f32``.  XLA's code for the same operations can differ in
the last bits, so the kernel and XLA films agree to float rounding
except for isolated hit/miss ties at silhouettes and horizons
(chip_smoke.py checks the share).

Covered family (``supported``): direct lighting with at most 8 lights
(the per-bounce RNG site stride, models/common.py), brute-force triangles,
the mirror-free super scene (sphere material 3: no ray survives bounce 1,
models/super.py), every quirk mode.  Renders that plug in another
illumination or triangle stage (VLP gathers, the grid DDA) never reach
it.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..core import rng as rngmod
from ..core.camera import make_camera, primary_rays_xyz
from ..core.quirks import Quirks, DEFAULT
from ..models import common as C
from .intersect import (SceneArrays, PrimTables, closest_hit_xyz,
                        occluded_xyz, _tri_table)

_BLOCK = 256        # pixels per program (two per thread at 4 warps)
_NUM_WARPS = 4
_MAX_LIGHTS = 8     # C.SITE_STRIDE_BOUNCE light draw sites per bounce


def supported(scn: SceneArrays, max_bounces: int) -> bool:
    """Whether the kernel covers a direct-lighting super render of this
    scene: at least one bounce and at most 8 lights (any quirk mode)."""
    return max_bounces >= 1 and scn.lights.shape[0] <= _MAX_LIGHTS


def _sample_xyz(key, tabs: PrimTables, lights, quirks: Quirks, ii, jj,
                ray_id):
    """One camera sample per pixel of the tile; returns (r, g, b).  The
    per-component twin of models/super.py::sample_super restricted to
    the covered family (one effective bounce, divFact 1, colorFact 0)."""
    f32 = np.float32
    r1, r2, r3, r4 = rngmod.randn_draws(key, ray_id, C.SITE_CAMERA, 4)
    ox, oy, oz, dx, dy, dz = primary_rays_xyz(make_camera(z_sign=-1.0),
                                              ii, jj, r1, r2, r3, r4)
    t, m, nx, ny, nz = closest_hit_xyz(ox, oy, oz, dx, dy, dz, tabs,
                                       quirks=quirks, sphere_material=3)
    x = ox + dx * t
    y = oy + dy * t
    z = oz + dz * t
    shading = m != 0

    # direct lighting (models/super.py::illum_direct, bounce 0)
    ti = jnp.zeros_like(t)
    t_run = t
    for i, (lx, ly, lz, li) in enumerate(lights):
        u1, u2 = rngmod.rand2(key, ray_id, C.SITE_LIGHT0 + i)
        vx = (f32(lx) + u1) - x
        vy = (f32(ly) + u2) - y
        vz = f32(lz) - z
        norm = jnp.sqrt(vx * vx + vy * vy + vz * vz)
        ldx, ldy, ldz = vx / norm, vy / norm, vz / norm
        lamb = ldx * nx + ldy * ny + ldz * nz
        if quirks.shadow_carry_t:
            ts, ms, _, _, _ = closest_hit_xyz(x, y, z, ldx, ldy, ldz, tabs,
                                              t_init=t_run, quirks=quirks,
                                              sphere_material=3)
            occ = ms != 0
            t_run = jnp.where(lamb < 0, t_run, ts)
        else:
            occ = occluded_xyz(x, y, z, ldx, ldy, ldz, tabs, quirks=quirks)
        qx, qy, qz = f32(lx) - x, f32(ly) - y, f32(lz) - z
        dist2 = qx * qx + qy * qy + qz * qz
        contrib = jnp.where((lamb < 0) | occ, f32(0.0),
                            lamb * jnp.minimum(f32(li) / dist2, f32(1.0)))
        ti = jnp.where(shading, ti + contrib, ti)
    ti = jnp.where(shading, jnp.minimum(ti, f32(1.0)) / f32(4.0), ti)

    # shading (models/super.py::sample_super step)
    f = f32(1.0) - dz
    f2 = f * f
    f4 = f2 * f2
    sel = (jnp.ceil(x * f32(0.2)) + jnp.ceil(y * f32(0.2))).astype(
        jnp.int32) & 1
    facing = jnp.maximum(f32(0.0), nx * -dx + ny * -dy + nz * -dz)
    rgb = []
    for c in range(3):
        floor = jnp.where(sel == 1, C.FLOOR_RED[c], C.FLOOR_WHITE[c]) * ti
        v = jnp.where(m == 0, C.SKY[c] * f4, f32(0.0))
        v = jnp.where(m == 1, floor, v)
        v = jnp.where(m == 3, C.DIFFUSE[c] * ti, v)
        rgb.append(jnp.where(m == 4, facing, v))
    return rgb


def _kernel(sc_ref, sph_ref, tri_ref, r_ref, g_ref, b_ref, *, width: int,
            spp: int, block: int, squares, n_spheres: int, n_tris: int,
            lights, quirks: Quirks):
    key = (sc_ref[0], sc_ref[1])
    spp_offset = sc_ref[2]
    spp_total = sc_ref[3]
    row_offset = sc_ref[4].astype(jnp.int32)

    p = pl.program_id(0) * block + jax.lax.broadcasted_iota(
        jnp.int32, (block,), 0)
    ii_i = p % width
    jj_i = p // width + row_offset
    ii = ii_i.astype(jnp.float32)
    jj = jj_i.astype(jnp.float32)
    pixel_index = (jj_i * width + ii_i).astype(jnp.uint32)

    tabs = PrimTables(
        squares[0], squares[1],
        n_spheres, lambda i: (sph_ref[i, 0], sph_ref[i, 1], sph_ref[i, 2]),
        n_tris, lambda i: [tri_ref[i, k] for k in range(12)])

    def body(s, acc):
        ray_id = pixel_index * spp_total + (s.astype(jnp.uint32) + spp_offset)
        rgb = _sample_xyz(key, tabs, lights, quirks, ii, jj, ray_id)
        return tuple(a + v for a, v in zip(acc, rgb))

    zero = jnp.zeros((block,), jnp.float32)
    r, g, b = jax.lax.fori_loop(0, spp, body, (zero, zero, zero))
    r_ref[...] = r * C.EXPOSURE
    g_ref[...] = g * C.EXPOSURE
    b_ref[...] = b * C.EXPOSURE


def film_super_kernel(key, scn: SceneArrays, width: int, height: int,
                      spp: int, spp_offset=0, spp_total: int | None = None,
                      quirks: Quirks = DEFAULT, row_offset=0,
                      rows: int | None = None, interpret: bool = False,
                      block: int = _BLOCK, num_warps: int = _NUM_WARPS):
    """Drop-in for models/super.py::film_super on the supported family:
    returns the pre-ambient (rows, W, 3) float32 film.  ``spp_offset``,
    ``row_offset`` and the key may be traced (the sharded renderers pass
    axis_index-derived windows, parallel/mesh.py)."""
    if spp_total is None:
        spp_total = spp
    if rows is None:
        rows = height
    n_pix = width * rows
    n_tiles = -(-n_pix // block)
    u32 = jnp.uint32
    scalars = jnp.stack([
        jnp.asarray(key[0], u32), jnp.asarray(key[1], u32),
        jnp.asarray(spp_offset).astype(u32), jnp.asarray(spp_total, u32),
        jnp.asarray(row_offset).astype(u32), u32(0), u32(0), u32(0)])
    n_spheres = int(scn.sphere_centers.shape[0])
    n_tris = int(scn.tri_v0.shape[0])
    # empty tables still need a row to be a valid kernel input
    sph = scn.sphere_centers if n_spheres else np.zeros((1, 3), np.float32)
    tri = _tri_table(scn) if n_tris else np.zeros((1, 12), np.float32)

    kernel = functools.partial(
        _kernel, width=width, spp=spp, block=block,
        squares=(scn.square_k, scn.square_z), n_spheres=n_spheres,
        n_tris=n_tris, lights=tuple(tuple(float(v) for v in l)
                                    for l in scn.lights),
        quirks=quirks)
    tile = pl.BlockSpec((block,), lambda i: (i,))
    plane = jax.ShapeDtypeStruct((n_tiles * block,), jnp.float32)
    r, g, b = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 3,
        out_specs=[tile] * 3,
        out_shape=[plane] * 3,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=interpret,
        name="super_sample",
    )(scalars, jnp.asarray(sph), jnp.asarray(tri))
    film = jnp.stack([r, g, b], axis=-1)[:n_pix]
    return film.reshape(rows, width, 3)

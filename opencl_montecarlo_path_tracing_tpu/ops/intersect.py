"""Batched primitive intersection (floor / squares / spheres / triangles).

The reference's TraceRay is a per-ray sequential scan over primitive classes
(CLSuperPathTracer/pathtracer.ocl:48-137): floor, then the square bitmap,
then the sphere bitmap, then a Moller-Trumbore loop over triangles, each
accepting a hit only when strictly closer than the best so far.

Here the scene is *static per compile* (shapes and values baked as
literals) and rays are flat float32 arrays.  The squares unroll in Python
over numpy scalar constants; spheres and triangles are ``fori_loop`` scans
whose body broadcasts one table row against the ray arrays, so no
(n_rays x n_prims) intermediate is ever built.  The sequential thread of
the running best-t through every primitive preserves the reference's exact
ordering and strict-< tie semantics.

The scans are written once, on per-component ray arrays, and read the
scene through :class:`PrimTables` row accessors.  The XLA wavefront path
(:func:`trace_ray`, :func:`any_hit`) reads rows from constant tables with
``dynamic_slice``; the fused super kernel (ops/pallas_super.py) runs the
very same functions inside one Pallas program, reading rows from its
kernel inputs.  The division-free triangle scan serves every mesh size;
meshes far past the reference scene's ~100 triangles are better served by
the uniform grid (ops/grid.py).

Semantics preserved exactly (with Quirks toggles, see core/quirks.py):
  floor   (ocl:65-70):   p = -oz/dz, hit if 0.01 < p < t, m=1, n=(0,0,1)
  squares (ocl:73-86):   rd = (4+j-oz)/dz, hit if rd < t and |k-ix|<1 and
                         |iy|<1 (NO positivity check in the reference), m=3
  spheres (ocl:88-108):  |o + t d - c| = 1, nearest root, hit if q > 0 and
                         0.01 < rd < t, m=3, n = normalize(p + d rd)
  triangles (ocl:111-134): Moller-Trumbore, reject |det| < 0.01, u in [0,1],
                         v >= 0, u+v <= 1; hit if rd < t (NO positivity check
                         in the reference), m=4, n = normalize(e0 x e2)
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.quirks import Quirks, DEFAULT
from ..scene.scene import Scene

_EPS = np.float32(0.01)
_BIG = np.float32(1e9)


class SceneArrays(NamedTuple):
    """Host-side SoA scene (numpy); values are baked into jitted renderers
    as literals, so shapes AND contents are static per compile."""
    sphere_centers: np.ndarray  # (Ns, 3)
    square_k: np.ndarray        # (Nq,)
    square_z: np.ndarray        # (Nq,)  plane height = j + 4
    tri_v0: np.ndarray          # (Nt, 3)
    tri_e0: np.ndarray          # (Nt, 3)  v1 - v0
    tri_e2: np.ndarray          # (Nt, 3)  v2 - v0
    tri_n: np.ndarray           # (Nt, 3)  normalize(e0 x e2)
    lights: np.ndarray          # (Nl, 4)

    def fingerprint(self) -> bytes:
        import hashlib
        h = hashlib.sha1()
        for a in self:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.digest()


def prep_scene(scene: Scene) -> SceneArrays:
    f32 = np.float32
    tri = scene.triangles.astype(f32).reshape(-1, 3, 3)
    v0 = tri[:, 0]
    e0 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e0, e2).astype(f32)
    with np.errstate(invalid="ignore", divide="ignore"):
        n = n / np.sqrt((n * n).sum(-1, keepdims=True))
    n = np.nan_to_num(n)
    nq = scene.n_squares
    return SceneArrays(
        sphere_centers=scene.sphere_centers.astype(f32).reshape(-1, 3),
        square_k=(scene.square_kj[:, 0] if nq else np.zeros(0)).astype(f32),
        square_z=(scene.square_kj[:, 1] + 4.0 if nq else np.zeros(0)).astype(f32),
        tri_v0=v0, tri_e0=e0, tri_e2=e2, tri_n=n,
        lights=scene.lights.astype(f32).reshape(-1, 4),
    )


class TraceResult(NamedTuple):
    t: jnp.ndarray         # (R,) hit distance (t_init when miss)
    normal: jnp.ndarray    # (R, 3)
    material: jnp.ndarray  # (R,) int32: 0 miss, 1 floor, 2 mirror-sphere,
                           #             3 square/diffuse-sphere, 4 triangle


class PrimTables(NamedTuple):
    """Where a scan reads the scene.  Squares are static constants;
    ``sphere(i)`` returns the 3 center scalars of sphere ``i`` and
    ``tri(i)`` the 12 scalars of packed triangle row ``i`` (v0, e0, e2,
    unit normal - :func:`_tri_table`).  ``i`` is a traced loop index."""
    square_k: np.ndarray
    square_z: np.ndarray
    n_spheres: int
    sphere: Callable
    n_tris: int
    tri: Callable


def scene_tables(scn: SceneArrays, triangles: bool = True) -> PrimTables:
    """Row accessors over constant device tables (the XLA path)."""
    centers = jnp.asarray(scn.sphere_centers)
    n_tris = int(scn.tri_v0.shape[0]) if triangles else 0
    table = jnp.asarray(_tri_table(scn)) if n_tris else None

    def sphere(i):
        c = jax.lax.dynamic_slice(centers, (i, 0), (1, 3))[0]
        return c[0], c[1], c[2]

    def tri(i):
        return jax.lax.dynamic_slice(table, (i, 0), (1, 12))[0]

    return PrimTables(scn.square_k, scn.square_z,
                      int(scn.sphere_centers.shape[0]), sphere, n_tris, tri)


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def closest_hit_xyz(ox, oy, oz, dx, dy, dz, tabs: PrimTables, t_init=_BIG,
                    quirks: Quirks = DEFAULT, sphere_material: int = 3,
                    tri_override=None):
    """Closest-hit scan on per-component ray arrays; returns
    (t, m, nx, ny, nz) with unit normals.  ``tri_override(t, m, nx, ny,
    nz, needs) -> same`` replaces the brute-force triangle scan."""
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    R = ox.shape

    t = jnp.broadcast_to(jnp.asarray(t_init, jnp.float32), R)
    m = jnp.zeros(R, jnp.int32)
    nx = jnp.zeros(R, jnp.float32)
    ny = jnp.zeros(R, jnp.float32)
    nz = jnp.zeros(R, jnp.float32)
    needs = jnp.zeros(R, bool)   # sphere normals normalised at the end

    inv_dz = one / dz

    # --- floor ---
    p = -oz * inv_dz
    hit = (p > _EPS) & (p < t)
    t = jnp.where(hit, p, t)
    m = jnp.where(hit, 1, m)
    nz = jnp.where(hit, one, nz)

    # --- squares ---
    for k, z in zip(tabs.square_k, tabs.square_z):
        rd = (np.float32(z) - oz) * inv_dz
        ix = ox + dx * rd
        iy = oy + dy * rd
        ok = (rd < t) & (jnp.abs(np.float32(k) - ix) < 1.0) & (jnp.abs(iy) < 1.0)
        if not quirks.accept_negative_t:
            ok = ok & (rd > _EPS)
        t = jnp.where(ok, rd, t)
        m = jnp.where(ok, 3, m)
        nx = jnp.where(ok, zero, nx)
        ny = jnp.where(ok, zero, ny)
        nz = jnp.where(ok, one, nz)
        needs = needs & ~ok

    # --- spheres ---
    if tabs.n_spheres:
        def sphere_body(i, carry):
            t, m, nx, ny, nz, needs = carry
            cx, cy, cz = tabs.sphere(i)
            px, py, pz = ox - cx, oy - cy, oz - cz
            b = _dot3(px, py, pz, dx, dy, dz)
            cc = _dot3(px, py, pz, px, py, pz) - one
            q = b * b - cc
            s = -b - jnp.sqrt(jnp.maximum(q, zero))
            ok = (q > zero) & (s < t) & (s > _EPS)
            t = jnp.where(ok, s, t)
            m = jnp.where(ok, sphere_material, m)
            nx = jnp.where(ok, px + dx * s, nx)
            ny = jnp.where(ok, py + dy * s, ny)
            nz = jnp.where(ok, pz + dz * s, nz)
            needs = needs | ok
            return t, m, nx, ny, nz, needs

        t, m, nx, ny, nz, needs = jax.lax.fori_loop(
            0, tabs.n_spheres, sphere_body, (t, m, nx, ny, nz, needs))

    # --- triangles ---
    if tri_override is not None:
        t, m, nx, ny, nz, needs = tri_override(t, m, nx, ny, nz, needs)
    elif tabs.n_tris:
        # DIVISION-FREE: validity and the running-min comparison are
        # evaluated on det-scaled quantities (sign-adjusted so the
        # denominator is positive); the best distance is carried as a
        # (numerator, denominator) pair and divided once after the loop.
        def tri_body(i, carry):
            bn, bd, m, nx, ny, nz, needs = carry
            r = tabs.tri(i)
            det, un, vn, tn = _mt_quads_scalar(ox, oy, oz, dx, dy, dz, r)
            sg = jnp.where(det >= 0, one, -one)
            dd = det * sg
            un_s = un * sg
            vn_s = vn * sg
            tn_s = tn * sg
            ok = ((dd >= _EPS) & (un_s >= 0.0) & (un_s <= dd)
                  & (vn_s >= 0.0) & (un_s + vn_s <= dd))
            if not quirks.accept_negative_t:
                ok = ok & (tn_s > _EPS * dd)
            ok = ok & (tn_s * bd < bn * dd)
            bn = jnp.where(ok, tn_s, bn)
            bd = jnp.where(ok, dd, bd)
            m = jnp.where(ok, 4, m)
            nx = jnp.where(ok, r[9], nx)
            ny = jnp.where(ok, r[10], ny)
            nz = jnp.where(ok, r[11], nz)
            needs = needs & ~ok
            return bn, bd, m, nx, ny, nz, needs

        bn, bd, m, nx, ny, nz, needs = jax.lax.fori_loop(
            0, tabs.n_tris, tri_body,
            (t, jnp.ones_like(t), m, nx, ny, nz, needs))
        t = bn / bd
    inv_len = jnp.where(
        needs,
        jax.lax.rsqrt(jnp.maximum(_dot3(nx, ny, nz, nx, ny, nz),
                                  jnp.float32(1e-30))),
        one)
    return t, m, nx * inv_len, ny * inv_len, nz * inv_len


def occluded_xyz(ox, oy, oz, dx, dy, dz, tabs: PrimTables, t_limit=_BIG,
                 quirks: Quirks = DEFAULT):
    """Any-hit scan on per-component ray arrays: does any primitive hit
    with t < ``t_limit`` (scalar or per-ray)?"""
    tl = jnp.asarray(t_limit, jnp.float32)
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    inv_dz = one / dz

    p = -oz * inv_dz
    occ = (p > _EPS) & (p < tl)

    for k, z in zip(tabs.square_k, tabs.square_z):
        rd = (np.float32(z) - oz) * inv_dz
        ix = ox + dx * rd
        iy = oy + dy * rd
        ok = (rd < tl) & (jnp.abs(np.float32(k) - ix) < 1.0) & (jnp.abs(iy) < 1.0)
        if not quirks.accept_negative_t:
            ok = ok & (rd > _EPS)
        occ = occ | ok

    if tabs.n_spheres:
        def sphere_body(i, occ):
            cx, cy, cz = tabs.sphere(i)
            px, py, pz = ox - cx, oy - cy, oz - cz
            b = _dot3(px, py, pz, dx, dy, dz)
            cc = _dot3(px, py, pz, px, py, pz) - one
            q = b * b - cc
            s = -b - jnp.sqrt(jnp.maximum(q, zero))
            return occ | ((q > zero) & (s < tl) & (s > _EPS))

        occ = jax.lax.fori_loop(0, tabs.n_spheres, sphere_body, occ)

    if tabs.n_tris:
        # division-free occlusion: all conditions on det-scaled quantities
        def tri_body(i, occ):
            r = tabs.tri(i)
            det, un, vn, tn = _mt_quads_scalar(ox, oy, oz, dx, dy, dz, r)
            sg = jnp.where(det >= 0, one, -one)
            dd = det * sg
            un_s = un * sg
            vn_s = vn * sg
            tn_s = tn * sg
            ok = ((dd >= _EPS) & (un_s >= 0.0) & (un_s <= dd)
                  & (vn_s >= 0.0) & (un_s + vn_s <= dd)
                  & (tn_s < tl * dd))
            if not quirks.accept_negative_t:
                ok = ok & (tn_s > _EPS * dd)
            return occ | ok

        occ = jax.lax.fori_loop(0, tabs.n_tris, tri_body, occ)

    return occ


def trace_ray(o, d, scn: SceneArrays, t_init=_BIG, quirks: Quirks = DEFAULT,
              sphere_material: int = 3, triangles: bool = True,
              tri_override=None) -> TraceResult:
    """Closest-hit query for a ray batch o/d of shape (..., 3).

    ``t_init`` reproduces the lmem variants' caller-initialised max distance
    (SURVEY.md section 2 #6); plain variants pass the default 1e9.
    ``sphere_material`` is 2 (mirror) in the simple tracer (spt.ocl:68) and
    3 (diffuse) in all super tracers (pathtracer.ocl:103).
    ``tri_override(o, d, t, m, nx, ny, nz, needs)`` replaces the triangle
    scan (the uniform-grid DDA, models/trianglegrid.py).
    """
    override = None
    if tri_override is not None:
        def override(*carry):
            return tri_override(o, d, *carry)
    t, m, nx, ny, nz = closest_hit_xyz(
        o[..., 0], o[..., 1], o[..., 2], d[..., 0], d[..., 1], d[..., 2],
        scene_tables(scn, triangles), t_init, quirks, sphere_material,
        override)
    return TraceResult(t=t, normal=jnp.stack([nx, ny, nz], axis=-1),
                       material=m)


def any_hit(o, d, scn: SceneArrays, t_limit=_BIG, quirks: Quirks = DEFAULT,
            triangles: bool = True):
    """Occlusion query: does any primitive hit with t < t_limit?

    Matches the reference's shadow test, which calls full TraceRay and checks
    material != 0 (pathtracer.ocl:180).  The plain super tracer re-initialises
    t to 1e9 inside TraceRay so *any* hit occludes, even beyond the light;
    the bidirectional/metropolis variants pass the light distance as the cap
    - expressed here via ``t_limit`` (scalar or per-ray array).
    """
    return occluded_xyz(o[..., 0], o[..., 1], o[..., 2],
                        d[..., 0], d[..., 1], d[..., 2],
                        scene_tables(scn, triangles), t_limit, quirks)


def _tri_table(scn: SceneArrays) -> np.ndarray:
    """(Nt, 12) packed triangle constants: v0, e0, e2, unit normal."""
    return np.concatenate(
        [scn.tri_v0, scn.tri_e0, scn.tri_e2, scn.tri_n], axis=1
    ).astype(np.float32)


def _mt_quads_scalar(ox, oy, oz, dx, dy, dz, r):
    """Moller-Trumbore det-scaled scalars (det, u*det, v*det, t*det) for one
    packed triangle row against the ray lanes - no divisions."""
    pvx = dy * r[8] - dz * r[7]
    pvy = dz * r[6] - dx * r[8]
    pvz = dx * r[7] - dy * r[6]
    det = _dot3(r[3], r[4], r[5], pvx, pvy, pvz)
    tvx, tvy, tvz = ox - r[0], oy - r[1], oz - r[2]
    un = _dot3(tvx, tvy, tvz, pvx, pvy, pvz)
    qvx = tvy * r[5] - tvz * r[4]
    qvy = tvz * r[3] - tvx * r[5]
    qvz = tvx * r[4] - tvy * r[3]
    vn = _dot3(dx, dy, dz, qvx, qvy, qvz)
    tn = _dot3(r[6], r[7], r[8], qvx, qvy, qvz)
    return det, un, vn, tn


def _mt_test(ox, oy, oz, dx, dy, dz, r, quirks: Quirks):
    """Moller-Trumbore validity + distance for one packed triangle row ``r``
    against the ray lanes.  Returns (ok, rd); caller applies the running-t
    comparison."""
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    v0x, v0y, v0z = r[0], r[1], r[2]
    e0x, e0y, e0z = r[3], r[4], r[5]
    e2x, e2y, e2z = r[6], r[7], r[8]
    # pvec = d x e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = _dot3(e0x, e0y, e0z, pvx, pvy, pvz)
    ok = jnp.abs(det) >= _EPS
    inv = one / jnp.where(ok, det, one)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = _dot3(tvx, tvy, tvz, pvx, pvy, pvz) * inv
    ok = ok & (u >= zero) & (u <= one)
    # qvec = tvec x e0
    qvx = tvy * e0z - tvz * e0y
    qvy = tvz * e0x - tvx * e0z
    qvz = tvx * e0y - tvy * e0x
    v = _dot3(dx, dy, dz, qvx, qvy, qvz) * inv
    ok = ok & (v >= zero) & (u + v <= one)
    rd = _dot3(e2x, e2y, e2z, qvx, qvy, qvz) * inv
    if not quirks.accept_negative_t:
        ok = ok & (rd > _EPS)
    return ok, rd

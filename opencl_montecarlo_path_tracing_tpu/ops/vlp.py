"""Virtual point light (VPL) ops: emission, dense gather, grid gather.

Reference (SURVEY.md section 2 #10/#12):
 * ``lightTracer`` emits one VLP per (work item, light): a uniform-sphere
   direction from the light, one bounce, VLP = (hit position, material-scaled
   intensity / (total_vlp / 512)) (bidirectionalpathtracer.ocl:230-326).
 * The render pass gathers ALL VLPs per shading point with no shadow rays
   (occlusion commented out, ocl:179-182).
 * The vlpgrid variant bins VLPs into a uniform grid (radius heuristic
   16*sqrt(intensity), metropolispathtracer.ocl:551-554) and gathers only
   the shading point's cell (ocl vlpgrid:326-349).

Design: emission is one batched trace over (nlights * n_vlp) rays; the
dense gather is a fused fori scan over VLP blocks with rays on the array
axis (no (rays x VLPs) temporaries); the whole pipeline (emit ->
reduce box -> build grid -> render) stays device-resident - including the
VLP bounding-box reduction the reference reads back to the host
mid-pipeline (vlpgrid .c:609, SURVEY.md section 3.5).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from .intersect import SceneArrays, trace_ray
from . import grid as gridmod

# RNG draw-site bases (see core/rng.py and models/common.py)
SITE_VLP_DIR = 64      # + light index (emission directions)

# material -> VLP base intensity (bidirectionalpathtracer.ocl:265-276)
_BPT_BASE = {1: 70.0, 2: 5.0, 3: 40.0}
# metropolis variant uses different constants and a /256 denominator
# (metropolispathtracer.ocl:416-426)
_MLT_BASE = {1: 400.0, 2: 10.0, 3: 40.0}


def uniform_sphere(u1, u2):
    """Uniform direction on S^2 (same distribution as the reference's
    Marsaglia rejection loop, ocl:318-323, without data-dependent trips)."""
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = (2.0 * np.pi) * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def vlp_from_light_sample(o, direction, light_intensity, scale_den,
                          scn: SceneArrays, quirks: Quirks,
                          base=_BPT_BASE, tri_override=None):
    """SampleFromLightSource (ocl:230-278) batched: trace one ray from the
    light, return (V, 4) = (hit position, scaled intensity); zeros on miss
    or non-emissive material."""
    tr = trace_ray(o, direction, scn, quirks=quirks, sphere_material=3,
                   tri_override=tri_override)
    x = o + direction * tr.t[..., None]
    lamb = jnp.sum(direction * tr.normal, axis=-1)
    dist2 = jnp.sum((o - x) ** 2, axis=-1)
    lamb = jnp.where(lamb < 0, 0.0,
                     lamb * jnp.minimum(light_intensity / dist2, 1.0))
    lamb = jnp.minimum(lamb, 1.0)
    m = tr.material
    base_i = jnp.zeros_like(lamb)
    for mat, val in base.items():
        base_i = jnp.where(m == mat, np.float32(val), base_i)
    intensity = base_i * lamb / np.float32(scale_den)
    hit = m != 0
    pos = jnp.where(hit[..., None], x, 0.0)
    intensity = jnp.where(hit, intensity, 0.0)
    return jnp.concatenate([pos, intensity[..., None]], axis=-1)


def emit_vlps(key, scn: SceneArrays, n_vlp: int, quirks: Quirks = DEFAULT,
              tri_override=None, gi0: int = 0, count: int | None = None):
    """lightTracer pass (ocl:280-326): (nlights * n_vlp, 4) VLPs, laid out
    vlp[gi + l * n_vlp] like the reference's strided write (ocl:324).

    total_vlp scaling: intensity /= (total_vlp / 512) with the reference's
    INTEGER division (ocl:267), guarded to >= 1 (the reference divides by
    zero when total_vlp < 512).

    ``gi0``/``count`` restrict emission to the work-item window
    [gi0, gi0+count) of each light - the sharded light pass
    (parallel/mesh.py) gives each device a disjoint window and
    all-gathers the table.  Every draw keys on the GLOBAL gi (and
    scale_den on the global n_vlp), so a window's rows are bit-identical
    to the same rows of the full emission; ``gi0`` may be a traced
    scalar (device index inside shard_map)."""
    nlights = int(scn.lights.shape[0])
    total_vlp = n_vlp * nlights
    scale_den = max(1, total_vlp // 512)
    if count is None:
        count = n_vlp
    gi = jnp.arange(count, dtype=jnp.uint32) + jnp.uint32(gi0)

    dirs = []
    for l in range(nlights):
        site = SITE_VLP_DIR if quirks.reuse_light_direction else SITE_VLP_DIR + l
        u1, u2 = rngmod.rand2(key, gi, site)
        dirs.append(uniform_sphere(u1, u2))
    out = []
    for l in range(nlights):
        lp = scn.lights[l, :3]
        intensity = scn.lights[l, 3]
        o = jnp.broadcast_to(jnp.asarray(lp, jnp.float32), (count, 3))
        d = dirs[0] if quirks.reuse_light_direction else dirs[l]
        out.append(vlp_from_light_sample(o, d, np.float32(intensity),
                                         scale_den, scn, quirks,
                                         tri_override=tri_override))
    return jnp.concatenate(out, axis=0)


def gather_vlps(x, n, vlps):
    """Dense VLP gather: sum over ALL VLPs of max(lamb, 0) * min(I/d^2, 1)
    with no shadow rays (Sample's VLP loop, ocl:166-187).

    A fori scan over VLP blocks with rays on the array axis: per-VLP
    scalars broadcast against (R,) arrays, so no (rays x VLPs) temporary
    is built (the same structure as the triangle scan in
    ops/intersect.py).
    """
    xx, xy, xz = x[..., 0], x[..., 1], x[..., 2]
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    n_dot_x = nx * xx + ny * xy + nz * xz
    x_sq = xx * xx + xy * xy + xz * xz

    # VLPs are consumed in blocks of _BLK per loop iteration (statically
    # unrolled inside the body) to amortise slice overhead.
    _BLK = 16
    nv = vlps.shape[0]
    pad = (-nv) % _BLK
    vl = jnp.pad(vlps, ((0, pad), (0, 0)))  # padded rows have intensity 0

    def body(i, illum):
        blk = jax.lax.dynamic_slice(vl, (i * _BLK, 0), (_BLK, 4))
        for j in range(_BLK):
            v = blk[j]
            vi = v[3]
            # n.(p-x) and |p-x|^2 expanded so only scalar-broadcast ops run
            lamb_num = (nx * v[0] + ny * v[1] + nz * v[2]) - n_dot_x
            dist2 = jnp.maximum(
                (v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
                - 2.0 * (xx * v[0] + xy * v[1] + xz * v[2]) + x_sq, 1e-12)
            lamb = lamb_num / jnp.sqrt(dist2)
            contrib = jnp.where((vi > 0) & (lamb >= 0),
                                lamb * jnp.minimum(vi / dist2, 1.0), 0.0)
            illum = illum + contrib
        return illum

    return jax.lax.fori_loop(0, (nv + pad) // _BLK, body,
                             jnp.zeros(x.shape[:-1], jnp.float32))


def vlp_bounds(vlps):
    """Device-resident VLP bounding box (replaces the reference's two-stage
    lmem reduction + BLOCKING host read, vlpgrid .c:597-611): each VLP with
    intensity > 0 contributes pos +- 16*sqrt(I)
    (reduceMinAndMax_lmem, metropolispathtracer.ocl:538-578)."""
    vi = vlps[:, 3]
    pos = vlps[:, :3]
    radius = 16.0 * jnp.sqrt(jnp.maximum(vi, 0.0))
    ok = vi > 0
    big = jnp.float32(3.4e38)
    lo = jnp.where(ok[:, None], pos - radius[:, None], big)
    hi = jnp.where(ok[:, None], pos + radius[:, None], -big)
    return jnp.min(lo, axis=0), jnp.max(hi, axis=0)


def vlp_grid_static_res(n_vlp_total: int, modifier: float = 3.0,
                        max_res: int = 24):
    """Static grid resolution for the VLP grid.

    The reference computes the resolution from the reduced bounding box ON
    THE HOST (vlpgrid .c:629-636) - the only mid-pipeline device->host sync
    in the codebase.  Shapes must be static under jit, so the rebuild uses a
    cubic resolution from the (static) VLP count alone and computes the
    (dynamic) cell size on device; the grid stays device-resident end to end.
    """
    r = int(np.floor(np.cbrt(max(1.0, modifier * n_vlp_total))))
    r = max(1, min(r, max_res))
    return (r, r, r)


def vlp_grid_dynamic_res(vmin, vmax, n_vlp_total: int,
                         modifier: float = 3.0, max_res: int = 128):
    """The reference's box-derived grid resolution (vlpgrid
    .c:629-636), HOST math on a reduced bounding box:

        grid_size = vmax - vmin
        cubeRoot  = cbrt(CELL_SIZE_MODIFIER * N_VLP / prod(grid_size))
        res_i     = clamp(floor(grid_size_i * cubeRoot), 1, 128)

    so CELL_SIZE_MODIFIER shapes the partition anisotropically with the
    box, unlike :func:`vlp_grid_static_res`'s count-based cube.  Used by
    the opt-in ``dynamic_grid_res`` parity mode, which reproduces the
    reference's single mid-pipeline device->host sync (the blocking
    box read, .c:609) to obtain ``vmin``/``vmax``."""
    size = np.maximum(np.asarray(vmax, np.float64)
                      - np.asarray(vmin, np.float64), 0.0)
    denom = float(size[0] * size[1] * size[2])
    # degenerate/empty boxes (no live VLPs): the reference would divide
    # by zero; clamp to the 1x1x1 grid
    if not np.isfinite(denom) or denom <= 0.0:
        return (1, 1, 1)
    cube = np.cbrt(modifier * n_vlp_total / denom)
    res = tuple(int(max(1, min(int(np.floor(size[i] * cube)), max_res)))
                for i in range(3))
    return res


def build_vlp_grid(vlps, res, cap: int = gridmod.MAX_NELS_PER_CELL):
    """initVLPsGrid (metropolispathtracer.ocl:626-647) without atomics:
    AABBs = pos +- 16*sqrt(I), per-cell scan build (deterministic)."""
    vmin, vmax = vlp_bounds(vlps)
    cell = (vmax - vmin) / jnp.asarray(res, jnp.float32)
    cell = jnp.maximum(cell, 1e-6)
    vi = vlps[:, 3]
    radius = 16.0 * jnp.sqrt(jnp.maximum(vi, 0.0))
    ok = vi > 0
    # dead VLPs get an empty AABB far outside the grid
    far = jnp.float32(3.0e38)
    amin = jnp.where(ok[:, None], vlps[:, :3] - radius[:, None], far)
    amax = jnp.where(ok[:, None], vlps[:, :3] + radius[:, None], far)
    return gridmod.build_grid_cellscan(amin, amax, vmin, cell, res, cap=cap)


def gather_vlps_grid(x, n, vlps, grid: gridmod.UniformGrid):
    """Grid-limited VLP gather (vlpgrid Sample, metropolispathtracer.ocl
    vlpgrid:326-349): only the shading point's cell contributes; points
    outside the grid get nothing.  NOTE: the reference computes the cell
    index WITHOUT clamping and only checks the flattened index range
    (ocl:327-329), so out-of-box points can alias into valid cells; the
    rebuild bounds-checks each axis (intended math)."""
    rx, ry, rz = grid.res
    c = jnp.floor((x - grid.vmin) / grid.cell_size).astype(jnp.int32)
    in_box = jnp.all((c >= 0) & (c < jnp.asarray(grid.res, jnp.int32)),
                     axis=-1)
    cell = jnp.clip(c[..., 2] * (rx * ry) + c[..., 1] * rx + c[..., 0],
                    0, rx * ry * rz - 1)
    cnt = grid.counts[cell]
    cap = grid.items.shape[1]
    # one (R, cap) row gather for the cell's items, and the referenced VLPs
    # pre-joined per slot as (R, cap, 4) in a single gather - the fori then
    # runs on static column slices (gathers dominate this kernel's cost)
    rows = grid.items[cell]                       # (R, cap)
    vrows = vlps[jnp.maximum(rows, 0)]            # (R, cap, 4)

    def body(kk, illum):
        idx = rows[:, kk]
        v = vrows[:, kk, :]
        live = in_box & (kk < cnt) & (idx >= 0)
        diff = v[:, :3] - x
        dist2 = jnp.maximum(jnp.sum(diff * diff, axis=-1), 1e-12)
        lamb = jnp.sum(diff * n, axis=-1) / jnp.sqrt(dist2)
        contrib = jnp.where(live & (v[:, 3] > 0) & (lamb >= 0),
                            lamb * jnp.minimum(v[:, 3] / dist2, 1.0), 0.0)
        return illum + contrib

    return jax.lax.fori_loop(0, cap, body, jnp.zeros(x.shape[0], jnp.float32))

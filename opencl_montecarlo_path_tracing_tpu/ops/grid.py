"""Uniform-grid acceleration: atomics-free builds + vectorised DDA traversal.

Reference (SURVEY.md section 2 #8, #12):
 * ``initTrianglesGrid`` scatters triangle ids into ``Cell{nels,
   elem_index[62]}`` with ``atomic_inc`` + overflow-drop
   (CLSuperPathTracer_trianglegrid/pathtracer.ocl:285-330), making cell
   contents nondeterministic and, when nels > 62, reading out of bounds in
   ``CellIntersect`` (ocl:90).  The rebuild needs no atomics; it uses a
   sort-based binning (pairs sorted by (cell, item)), which is deterministic
   (ascending item index per cell) and clamps counts to the cap.
 * grid resolution heuristic: res_axis = clamp(floor(size_axis *
   cbrt(modifier * N / volume)), 1, 128) (host, .c:476-483).
 * 3-D DDA cell walk inside TraceRay (ocl:157-198) - here a masked
   ``lax.while_loop`` over ray lanes with a bounded step count.

Two device builds are provided: ``build_grid_pairs`` (pair enumeration with
a static per-item span bound - right for triangles) and
``build_grid_cellscan`` (per-cell scan over items - right for VLPs whose
radius can span the whole grid, metropolispathtracer.ocl:634-646).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..core.quirks import Quirks, DEFAULT
from .intersect import SceneArrays, _tri_table, _mt_test

MAX_NELS_PER_CELL = 62  # reference cap (.ocl:1)
_EPS = np.float32(0.01)


class UniformGrid(NamedTuple):
    items: jnp.ndarray      # (ncells, cap) int32, -1 padded
    counts: jnp.ndarray     # (ncells,) int32 (clamped to cap)
    res: tuple              # static (rx, ry, rz)
    vmin: jnp.ndarray       # (3,) f32 (may be traced - VLP grid)
    cell_size: jnp.ndarray  # (3,) f32 (may be traced)


def grid_resolution(vmin, vmax, n_items: int, modifier: float = 3.0):
    """Host-side resolution heuristic (trianglegrid .c:476-483)."""
    size = np.asarray(vmax, np.float64) - np.asarray(vmin, np.float64)
    vol = float(size[0] * size[1] * size[2])
    if vol <= 0 or n_items == 0:
        return (1, 1, 1)
    cr = np.cbrt(modifier * n_items / vol)
    res = np.floor(size * cr).astype(np.int64)
    return tuple(int(max(1, min(r, 128))) for r in res)


# ---------------------------------------------------------------------------
# builds

def _cell_coords(pos, vmin, cell_size, res):
    """float positions -> clamped integer cell coords (ocl:320-321)."""
    c = jnp.floor((pos - vmin) / cell_size).astype(jnp.int32)
    hi = jnp.asarray(res, jnp.int32) - 1
    return jnp.clip(c, 0, hi)


def build_grid_pairs(aabb_min, aabb_max, vmin, cell_size, res,
                     cap: int = MAX_NELS_PER_CELL,
                     max_span: tuple = (4, 4, 4)) -> UniformGrid:
    """Device build by pair enumeration + sort.

    ``max_span`` is the static per-axis bound on how many cells one item's
    AABB may overlap (computed host-side for static geometry; items
    exceeding it are clipped - callers should size it from the data).
    Deterministic: each cell keeps the ``cap`` lowest item indices.
    """
    n = aabb_min.shape[0]
    rx, ry, rz = res
    ncells = rx * ry * rz
    lo = _cell_coords(aabb_min, vmin, cell_size, res)   # (N, 3)
    hi = _cell_coords(aabb_max, vmin, cell_size, res)   # (N, 3)

    sx, sy, sz = max_span
    offs = np.stack(np.meshgrid(np.arange(sx), np.arange(sy), np.arange(sz),
                                indexing="ij"), -1).reshape(-1, 3)   # (S, 3)
    offs = jnp.asarray(offs, jnp.int32)
    cells = lo[:, None, :] + offs[None, :, :]            # (N, S, 3)
    valid = jnp.all(cells <= hi[:, None, :], axis=-1)    # (N, S)
    cid = (cells[..., 2] * (rx * ry) + cells[..., 1] * rx + cells[..., 0])
    cid = jnp.where(valid, cid, ncells)                  # sentinel
    item = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None],
                            cid.shape)
    # pairs are enumerated item-major, so a stable sort on cell id keeps
    # item indices ascending within each cell (deterministic order)
    order = jnp.argsort(cid.reshape(-1), stable=True)
    cid_s = cid.reshape(-1)[order]
    item_s = item.reshape(-1)[order]
    # rank within cell: position - first occurrence of this cell id
    first = jnp.searchsorted(cid_s, cid_s, side="left")
    rank = jnp.arange(cid_s.shape[0], dtype=jnp.int32) - first.astype(jnp.int32)
    ok = (cid_s < ncells) & (rank < cap)
    tgt_cell = jnp.where(ok, cid_s, ncells)
    items = jnp.full((ncells + 1, cap), -1, jnp.int32)
    items = items.at[tgt_cell, jnp.where(ok, rank, 0)].set(
        jnp.where(ok, item_s, -1), mode="drop")
    counts = jax.ops.segment_sum(
        jnp.where(cid_s < ncells, 1, 0), cid_s.astype(jnp.int32),
        num_segments=ncells + 1)[:ncells]
    counts = jnp.minimum(counts, cap).astype(jnp.int32)
    return UniformGrid(items=items[:ncells], counts=counts, res=res,
                       vmin=jnp.asarray(vmin, jnp.float32),
                       cell_size=jnp.asarray(cell_size, jnp.float32))


def build_grid_cellscan(aabb_min, aabb_max, vmin, cell_size, res,
                        cap: int = MAX_NELS_PER_CELL,
                        cell_chunk: int = 4096) -> UniformGrid:
    """Device build scanning items per cell (handles unbounded spans).

    For each cell, keeps the first ``cap`` items (ascending index) whose
    AABB overlaps the cell - the deterministic analogue of atomic_addVLP
    (metropolispathtracer.ocl:620-646).
    """
    n = aabb_min.shape[0]
    rx, ry, rz = res
    ncells = rx * ry * rz
    lo = _cell_coords(aabb_min, vmin, cell_size, res)
    hi = _cell_coords(aabb_max, vmin, cell_size, res)

    cz, cy, cx = jnp.meshgrid(jnp.arange(rz), jnp.arange(ry), jnp.arange(rx),
                              indexing="ij")
    coords = jnp.stack([cx.reshape(-1), cy.reshape(-1), cz.reshape(-1)],
                       axis=-1).astype(jnp.int32)       # (ncells, 3)

    def chunk_body(coords_c):
        # (C, N) overlap mask
        m = (jnp.all(coords_c[:, None, :] >= lo[None, :, :], axis=-1)
             & jnp.all(coords_c[:, None, :] <= hi[None, :, :], axis=-1))
        rank = jnp.cumsum(m, axis=1) - 1                 # (C, N)
        ok = m & (rank < cap)
        row = jnp.broadcast_to(jnp.arange(coords_c.shape[0])[:, None], m.shape)
        # cap+1 columns: non-members land in the scratch column, not slot 0
        items_c = jnp.full((coords_c.shape[0], cap + 1), -1, jnp.int32)
        items_c = items_c.at[row, jnp.where(ok, rank, cap)].set(
            jnp.where(ok, jnp.arange(n, dtype=jnp.int32)[None, :], -1),
            mode="drop")[:, :cap]
        counts_c = jnp.minimum(jnp.sum(m, axis=1), cap).astype(jnp.int32)
        return items_c, counts_c

    if ncells <= cell_chunk:
        items, counts = chunk_body(coords)
    else:
        pad = (-ncells) % cell_chunk
        coords_p = jnp.pad(coords, ((0, pad), (0, 0)))
        items, counts = jax.lax.map(
            chunk_body, coords_p.reshape(-1, cell_chunk, 3))
        items = items.reshape(-1, cap)[:ncells]
        counts = counts.reshape(-1)[:ncells]
    return UniformGrid(items=items, counts=counts, res=res,
                       vmin=jnp.asarray(vmin, jnp.float32),
                       cell_size=jnp.asarray(cell_size, jnp.float32))


def build_grid_host(aabb_min, aabb_max, vmin, cell_size, res,
                    cap: int = MAX_NELS_PER_CELL) -> UniformGrid:
    """NumPy oracle build (mirrors the reference's disabled host builder,
    trianglegrid .c:233-265, with deterministic ascending-index order)."""
    rx, ry, rz = res
    ncells = rx * ry * rz
    items = np.full((ncells, cap), -1, np.int32)
    counts = np.zeros(ncells, np.int32)
    vmin = np.asarray(vmin, np.float32)
    cell_size = np.asarray(cell_size, np.float32)
    res_a = np.asarray(res, np.int64)
    for i in range(aabb_min.shape[0]):
        lo = np.clip(np.floor((aabb_min[i] - vmin) / cell_size).astype(np.int64),
                     0, res_a - 1)
        hi = np.clip(np.floor((aabb_max[i] - vmin) / cell_size).astype(np.int64),
                     0, res_a - 1)
        for z in range(lo[2], hi[2] + 1):
            for y in range(lo[1], hi[1] + 1):
                for x in range(lo[0], hi[0] + 1):
                    c = z * rx * ry + y * rx + x
                    if counts[c] < cap:
                        items[c, counts[c]] = i
                    counts[c] += 1
    counts = np.minimum(counts, cap)
    return UniformGrid(items=items, counts=counts, res=res,
                       vmin=vmin, cell_size=cell_size)


def grid_stats(grid: UniformGrid) -> dict:
    """Debug statistics - the analog of the reference's (disabled)
    printTrianglesGrid kernel (trianglegrid/pathtracer.ocl:332-346), which
    prints per-cell members and the total nels."""
    counts = np.asarray(grid.counts)
    items = np.asarray(grid.items)
    return {
        "ncells": int(counts.size),
        "total_nels": int(counts.sum()),
        "occupied_cells": int((counts > 0).sum()),
        "max_nels": int(counts.max(initial=0)),
        "mean_nels_occupied": float(counts[counts > 0].mean()) if (counts > 0).any() else 0.0,
        "capacity": int(items.shape[1]),
        "res": tuple(grid.res),
    }


def max_cell_occupancy(amin, amax, vmin, cell_size, res) -> int:
    """Host-side max items per cell (vectorised histogram over cell ranges).
    Used to size the static per-cell capacity: iterating 62 slots per DDA
    step when the densest cell holds 8 wastes ~8x runtime and compile time,
    so the table is shrunk to the true occupancy (results are identical
    whenever occupancy <= the reference cap of 62)."""
    rx, ry, rz = res
    res_a = np.asarray(res, np.int64)
    lo = np.clip(np.floor((amin - vmin) / cell_size).astype(np.int64), 0, res_a - 1)
    hi = np.clip(np.floor((amax - vmin) / cell_size).astype(np.int64), 0, res_a - 1)
    counts = np.zeros((rz, ry, rx), np.int64)
    # difference-array trick: +1 at lo, -1 past hi, then 3-axis cumsum
    diff = np.zeros((rz + 1, ry + 1, rx + 1), np.int64)
    np.add.at(diff, (lo[:, 2], lo[:, 1], lo[:, 0]), 1)
    np.add.at(diff, (hi[:, 2] + 1, lo[:, 1], lo[:, 0]), -1)
    np.add.at(diff, (lo[:, 2], hi[:, 1] + 1, lo[:, 0]), -1)
    np.add.at(diff, (lo[:, 2], lo[:, 1], hi[:, 0] + 1), -1)
    np.add.at(diff, (hi[:, 2] + 1, hi[:, 1] + 1, lo[:, 0]), 1)
    np.add.at(diff, (hi[:, 2] + 1, lo[:, 1], hi[:, 0] + 1), 1)
    np.add.at(diff, (lo[:, 2], hi[:, 1] + 1, hi[:, 0] + 1), 1)
    np.add.at(diff, (hi[:, 2] + 1, hi[:, 1] + 1, hi[:, 0] + 1), -1)
    counts = diff.cumsum(0).cumsum(1).cumsum(2)[:rz, :ry, :rx]
    return int(counts.max(initial=0))


def triangle_grid(scn: SceneArrays, modifier: float = 3.0,
                  cap: int = MAX_NELS_PER_CELL, device: bool = True):
    """Build the triangle grid for a static scene.  Returns (grid, box)
    where box = (vmin, vmax) numpy.  ``cap`` is an upper bound; the actual
    per-cell capacity is the scene's true max occupancy when smaller."""
    v = np.concatenate([scn.tri_v0[:, None, :],
                        (scn.tri_v0 + scn.tri_e0)[:, None, :],
                        (scn.tri_v0 + scn.tri_e2)[:, None, :]], axis=1)
    amin = v.min(axis=1)
    amax = v.max(axis=1)
    vmin = amin.min(axis=0)
    vmax = amax.max(axis=0)
    res = grid_resolution(vmin, vmax, v.shape[0], modifier)
    cell = ((vmax - vmin) / np.asarray(res, np.float32)).astype(np.float32)
    cap = max(1, min(cap, max_cell_occupancy(amin, amax, vmin, cell, res)))
    if device:
        span = np.floor((amax - amin) / np.maximum(cell, 1e-20)).astype(np.int64) + 2
        max_span = tuple(int(min(s, r)) for s, r in zip(span.max(axis=0), res))
        grid = build_grid_pairs(jnp.asarray(amin), jnp.asarray(amax),
                                vmin, cell, res, cap, max_span)
    else:
        grid = build_grid_host(amin, amax, vmin, cell, res, cap)
    return grid, (vmin.astype(np.float32), vmax.astype(np.float32))


# ---------------------------------------------------------------------------
# traversal

def traverse_triangles(o, d, t, m, nx, ny, nz, needs_norm,
                       scn: SceneArrays, grid: UniformGrid,
                       quirks: Quirks = DEFAULT):
    """Walk the grid per ray lane, testing the (<= cap) triangles of each
    visited cell; updates the running (t, m, normal) exactly like the
    brute-force scan.  Faithful to TraceRay's DDA (ocl:157-198) including
    its break conditions (the running-t check happens after stepping
    ``next``, so one extra cell may be visited)."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    R = ox.shape
    rx, ry, rz = grid.res
    vmin = grid.vmin
    vmax = vmin + grid.cell_size * jnp.asarray([rx, ry, rz], jnp.float32)
    table = jnp.asarray(_tri_table(scn))
    cap = grid.items.shape[1]

    # per-axis component arrays: every step is pure elementwise selects on
    # (R,) lanes (compiles far faster than the vectorised
    # argmin/one_hot/take_along_axis formulation)
    one = jnp.float32(1.0)
    vminx, vminy, vminz = vmin[0], vmin[1], vmin[2]
    vmaxx, vmaxy, vmaxz = vmax[0], vmax[1], vmax[2]
    csx, csy, csz = grid.cell_size[0], grid.cell_size[1], grid.cell_size[2]

    invx, invy, invz = one / dx, one / dy, one / dz
    ex0 = jnp.minimum((vminx - ox) * invx, (vmaxx - ox) * invx)
    ex1 = jnp.maximum((vminx - ox) * invx, (vmaxx - ox) * invx)
    ey0 = jnp.minimum((vminy - oy) * invy, (vmaxy - oy) * invy)
    ey1 = jnp.maximum((vminy - oy) * invy, (vmaxy - oy) * invy)
    ez0 = jnp.minimum((vminz - oz) * invz, (vmaxz - oz) * invz)
    ez1 = jnp.maximum((vminz - oz) * invz, (vmaxz - oz) * invz)
    t0 = jnp.maximum(jnp.maximum(ex0, ey0), ez0)
    t1 = jnp.minimum(jnp.minimum(ex1, ey1), ez1)
    active = t0 <= t1   # ray hits the box (ocl:165)

    inside = ((ox >= vminx) & (ox <= vmaxx) & (oy >= vminy) & (oy <= vmaxy)
              & (oz >= vminz) & (oz <= vmaxz))
    px = jnp.where(inside, ox, ox + dx * t0)
    py = jnp.where(inside, oy, oy + dy * t0)
    pz = jnp.where(inside, oz, oz + dz * t0)
    ix = jnp.clip(jnp.floor((px - vminx) / csx).astype(jnp.int32), 0, rx - 1)
    iy = jnp.clip(jnp.floor((py - vminy) / csy).astype(jnp.int32), 0, ry - 1)
    iz = jnp.clip(jnp.floor((pz - vminz) / csz).astype(jnp.int32), 0, rz - 1)
    dlx = (ex1 - ex0) / np.float32(rx)
    dly = (ey1 - ey0) / np.float32(ry)
    dlz = (ez1 - ez0) / np.float32(rz)
    posx, posy, posz = dx > 0, dy > 0, dz > 0
    nxx = jnp.where(posx, ex0 + (ix + 1).astype(jnp.float32) * dlx,
                    ex0 + np.float32(rx) * dlx - ix.astype(jnp.float32) * dlx)
    nxy = jnp.where(posy, ey0 + (iy + 1).astype(jnp.float32) * dly,
                    ey0 + np.float32(ry) * dly - iy.astype(jnp.float32) * dly)
    nxz = jnp.where(posz, ez0 + (iz + 1).astype(jnp.float32) * dlz,
                    ez0 + np.float32(rz) * dlz - iz.astype(jnp.float32) * dlz)
    stx = jnp.where(posx, 1, -1).astype(jnp.int32)
    sty = jnp.where(posy, 1, -1).astype(jnp.int32)
    stz = jnp.where(posz, 1, -1).astype(jnp.int32)
    spx = jnp.where(posx, rx, -1).astype(jnp.int32)
    spy = jnp.where(posy, ry, -1).astype(jnp.int32)
    spz = jnp.where(posz, rz, -1).astype(jnp.int32)

    # STATIC trip count, as in models/common.py::bounce_loop
    max_steps = rx + ry + rz + 2

    # PT_KERNEL_DEBUG=1: the analog of the reference's commented-out DDA
    # printf (ocl:192) - aggregate visit statistics instead of per-work-item
    # lines (utils/debug.py); the counter joins the carry only when enabled
    from ..utils import debug as _dbg
    _debug = _dbg.enabled()

    def body(k, carry):
        if _debug:
            carry, visited = carry[:-1], carry[-1]
        (active, ix, iy, iz, nxx, nxy, nxz,
         t, m, nx, ny, nz, needs) = carry
        cell = jnp.clip(iz * (rx * ry) + iy * rx + ix, 0, rx * ry * rz - 1)
        cnt = grid.counts[cell]
        # pre-join the cell's item rows and their triangle data in two
        # batched gathers (gathers dominate this loop; one gather per slot
        # would multiply their count by the cell capacity)
        rows = grid.items[cell]                      # (R, cap)
        trows = table[jnp.maximum(rows, 0)]          # (R, cap, 12)

        def tri_k(kk, carry2):
            t, m, nx, ny, nz, needs = carry2
            tri = rows[:, kk]
            live = active & (kk < cnt) & (tri >= 0)
            row = trows[:, kk, :]                    # (R, 12)
            ok, rd = _mt_test(ox, oy, oz, dx, dy, dz,
                              tuple(row[..., j] for j in range(12)), quirks)
            ok = live & ok & (rd < t)
            t = jnp.where(ok, rd, t)
            m = jnp.where(ok, 4, m)
            nx = jnp.where(ok, row[..., 9], nx)
            ny = jnp.where(ok, row[..., 10], ny)
            nz = jnp.where(ok, row[..., 11], nz)
            needs = needs & ~ok
            return t, m, nx, ny, nz, needs

        t, m, nx, ny, nz, needs = jax.lax.fori_loop(
            0, cap, tri_k, (t, m, nx, ny, nz, needs))

        # pick the axis with minimal next (branchless selects; ocl:191-193)
        selx = (nxx <= nxy) & (nxx <= nxz)
        sely = ~selx & (nxy <= nxz)
        selz = ~selx & ~sely
        nxx = jnp.where(selx, nxx + dlx, nxx)
        nxy = jnp.where(sely, nxy + dly, nxy)
        nxz = jnp.where(selz, nxz + dlz, nxz)
        next_ax = jnp.where(selx, nxx, jnp.where(sely, nxy, nxz))
        cont = ~(t < next_ax)                        # ocl:195
        ix = jnp.where(cont & selx, ix + stx, ix)
        iy = jnp.where(cont & sely, iy + sty, iy)
        iz = jnp.where(cont & selz, iz + stz, iz)
        at_stop = (jnp.where(selx, ix, jnp.where(sely, iy, iz))
                   == jnp.where(selx, spx, jnp.where(sely, spy, spz)))
        out = (active & cont & ~at_stop, ix, iy, iz, nxx, nxy, nxz,
               t, m, nx, ny, nz, needs)
        if _debug:
            out = out + (visited + jnp.sum(active.astype(jnp.int32)),)
        return out

    carry = (active, ix, iy, iz, nxx, nxy, nxz,
             t, m, nx, ny, nz, needs_norm)
    if _debug:
        carry = carry + (jnp.int32(0),)
    out = jax.lax.fori_loop(0, max_steps, body, carry)
    t, m, nx, ny, nz, needs_norm = out[7], out[8], out[9], out[10], out[11], out[12]
    if _debug:
        _dbg.dprint(
            "[grid DDA] rays={r} entered={e} cells_visited={v} tri_hits={h}",
            r=active.size, e=jnp.sum(active.astype(jnp.int32)),
            v=out[-1], h=jnp.sum((m == 4).astype(jnp.int32)))
    return t, m, nx, ny, nz, needs_norm

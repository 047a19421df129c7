"""Counter-based RNG streams (Threefry-2x32).

The reference decorrelates per-work-item streams by XORing host seeds with a
hash of the flattened global id and then stepping a stateful MWC64X generator
(reference: CLSuperPathTracer/pathtracer.ocl:12-41).  That scheme is stateful
and layout-dependent: re-tiling the NDRange changes every image.  Here every
draw is a pure function of

    (key, ray_id, draw_id)

where ``ray_id`` is the logical sample index (pixel * spp + sample) and
``draw_id`` numbers the draw site (a static small integer per code location,
mixed with the bounce/light indices).  Rendering is therefore bit-identical
across any batch/chunk/shard layout.

The implementation is the standard 20-round Threefry-2x32 block cipher,
vectorised directly on uint32 jnp arrays with no per-element key objects,
so the same functions run in the XLA wavefront and inside the fused super
kernel (ops/pallas_super.py).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_U32 = jnp.uint32


def _rotl(x, r: int):
    r = np.uint32(r)
    return (x << r) | (x >> np.uint32(32 - int(r)))


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32. ``k0``/``k1`` scalars, ``x0``/``x1`` arrays.

    Returns two uint32 arrays with the shape of ``x0 ^ x1`` (broadcast).
    """
    ks0 = jnp.asarray(k0, _U32)
    ks1 = jnp.asarray(k1, _U32)
    ks2 = ks0 ^ ks1 ^ _PARITY
    x0 = jnp.asarray(x0, _U32)
    x1 = jnp.asarray(x1, _U32)

    x0 = x0 + ks0
    x1 = x1 + ks1

    # key injections after each group of 4 rounds:
    # group i (0-based) injects (ks[(i+1)%3], ks[(i+2)%3] + (i+1))
    ks = (ks0, ks1, ks2)
    for i in range(5):
        rots = _ROTATIONS[i % 2]
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def make_key(seed: int):
    """Split a python int seed into the (k0, k1) uint32 key pair."""
    seed = int(seed)
    return (np.uint32(seed & 0xFFFFFFFF), np.uint32((seed >> 32) & 0xFFFFFFFF))


def _bits_to_unit_float(bits):
    # Top 24 bits -> [0, 1) exactly representable in float32.
    return (bits >> np.uint32(8)).astype(jnp.float32) * np.float32(1.0 / (1 << 24))


# Every logical draw site owns a block of 8 counters, so a site can consume
# up to 16 uniforms (2 per threefry block) without colliding with any other
# site.  All public entry points go through this convention.
_SITE_STRIDE = np.uint32(8)


def _block(key, ray_id, raw_counter):
    k0, k1 = key
    rid = jnp.asarray(ray_id, _U32)
    ctr = jnp.asarray(raw_counter, _U32)
    return threefry2x32(k0, k1, rid, ctr)


def rand2(key, ray_id, site_id):
    """Two independent U[0,1) float32 arrays shaped like ``ray_id``.

    ``site_id`` may be a static int or a traced uint32 (e.g. mixing in a
    ``lax.while_loop`` bounce counter).  Distinct sites never collide.
    """
    b0, b1 = _block(key, ray_id, jnp.asarray(site_id, _U32) * _SITE_STRIDE)
    return _bits_to_unit_float(b0), _bits_to_unit_float(b1)


def rand2_bits(key, ray_id, site_id):
    """Raw uint32 pair for callers that need bits (e.g. seeding sub-streams)."""
    return _block(key, ray_id, jnp.asarray(site_id, _U32) * _SITE_STRIDE)


def randn_draws(key, ray_id, site_id, n: int):
    """``n`` independent U[0,1) arrays from one site (n <= 16)."""
    assert n <= 16, "one site owns at most 16 uniforms"
    base = jnp.asarray(site_id, _U32) * _SITE_STRIDE
    out = []
    for j in range((n + 1) // 2):
        b0, b1 = _block(key, ray_id, base + np.uint32(j))
        out.extend([_bits_to_unit_float(b0), _bits_to_unit_float(b1)])
    return out[:n]


# ---------------------------------------------------------------------------
# Pure-NumPy twin - bit-identical streams on the host.
#
# The oracle renderers (models/oracle*.py) use these for their
# common-random-numbers mode: oracle and JAX renders then consume the SAME
# sample values, so their comparison isolates estimator bias from Monte-Carlo
# noise (it is tight at ANY spp, not just asymptotically).  Equality with the
# jnp implementation is pinned by tests/test_rng.py.

def threefry2x32_np(k0, k1, x0, x1):
    """NumPy 20-round Threefry-2x32; same contract as :func:`threefry2x32`."""
    u32 = np.uint32
    ks = [np.asarray(k0, u32), np.asarray(k1, u32)]
    ks.append(ks[0] ^ ks[1] ^ _PARITY)
    x0 = np.asarray(x0, u32)
    x1 = np.asarray(x1, u32)
    with np.errstate(over="ignore"):
        x0 = (x0 + ks[0]).astype(u32)
        x1 = (x1 + ks[1]).astype(u32)
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = (x0 + x1).astype(u32)
                x1 = ((x1 << u32(r)) | (x1 >> u32(32 - r))).astype(u32) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]).astype(u32)
            x1 = (x1 + ks[(i + 2) % 3] + u32(i + 1)).astype(u32)
    return x0, x1


def _bits_to_unit_float_np(bits):
    return ((bits >> np.uint32(8)).astype(np.float32)
            * np.float32(1.0 / (1 << 24)))


def rand2_np(key, ray_id, site_id):
    """NumPy twin of :func:`rand2` (bit-identical)."""
    with np.errstate(over="ignore"):
        ctr = (np.asarray(site_id, np.uint32) * _SITE_STRIDE).astype(np.uint32)
    b0, b1 = threefry2x32_np(key[0], key[1],
                             np.asarray(ray_id, np.uint32), ctr)
    return _bits_to_unit_float_np(b0), _bits_to_unit_float_np(b1)


def randn_draws_np(key, ray_id, site_id, n: int):
    """NumPy twin of :func:`randn_draws` (bit-identical)."""
    assert n <= 16, "one site owns at most 16 uniforms"
    with np.errstate(over="ignore"):
        base = (np.asarray(site_id, np.uint32) * _SITE_STRIDE).astype(np.uint32)
    out = []
    for j in range((n + 1) // 2):
        b0, b1 = threefry2x32_np(key[0], key[1],
                                 np.asarray(ray_id, np.uint32),
                                 (base + np.uint32(j)).astype(np.uint32))
        out.extend([_bits_to_unit_float_np(b0), _bits_to_unit_float_np(b1)])
    return out[:n]

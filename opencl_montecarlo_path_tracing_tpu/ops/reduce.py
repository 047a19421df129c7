"""Film reduction: sample buffer -> final RGBA8 image, device-resident.

Reference: ``reduce4img_lmem`` (CLSuperPathTracer_lmem_NoDoF/pathtracer.ocl:
253-274) tree-reduces each 8x8 work-group tile of the sample buffer in local
memory, adds the ambient term (13,13,13), sets alpha=255 and converts to
uchar4.  Here it is a reshape + sum over the sample-grid axes (XLA emits
the reduction itself; no "local memory" staging is needed) followed by the
quantisation, all inside the same jit.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

AMBIENT = np.float32(13.0)


def quantize_film(film, wrap: bool = False):
    """Pre-ambient (H, W, 3) float film -> (H, W, 4) uint8: + ambient,
    trunc, alpha=255 (reduce4img_lmem's epilogue, ocl:268-271).  ``wrap``
    reproduces the non-saturating convert_uchar4 (ocl:271)."""
    film = film + AMBIENT
    if wrap:
        rgb = jnp.trunc(film).astype(jnp.int32).astype(jnp.uint8)
    else:
        rgb = jnp.clip(jnp.trunc(film), 0.0, 255.0).astype(jnp.uint8)
    h, w, _ = film.shape
    alpha = jnp.full((h, w, 1), 255, jnp.uint8)
    return jnp.concatenate([rgb, alpha], axis=-1)


def quantize_film16(film):
    """Pre-ambient (H, W, 3) float film -> (H, W, 4) uint16 (maxval
    65535): the display scale [0, 255] mapped linearly onto [0, 65535],
    saturating, round-half-even — bit-identical to the host
    utils/pam.py::film_to_rgba16 (the wrap quirk is an 8-bit
    convert_uchar4 artefact with no 16-bit analogue)."""
    film = film + AMBIENT
    rgb = jnp.clip(jnp.round(film * np.float32(65535.0 / 255.0)),
                   0.0, 65535.0).astype(jnp.uint16)
    h, w, _ = film.shape
    alpha = jnp.full((h, w, 1), 65535, jnp.uint16)
    return jnp.concatenate([rgb, alpha], axis=-1)


def reduce_samples(samples, sample_grid: int, wrap: bool = False):
    """(H*sg, W*sg, 3) float32 sample buffer -> (H, W, 4) uint8 image.

    Slot (i, j) of the buffer belongs to pixel (i >> log2(sg), j >> ...)
    exactly like the reference's gid>>3 mapping (ocl:223-224).
    """
    sg = sample_grid
    hh, ww, _ = samples.shape
    h, w = hh // sg, ww // sg
    return quantize_film(samples.reshape(h, sg, w, sg, 3).sum(axis=(1, 3)),
                         wrap=wrap)

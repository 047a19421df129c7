"""Camera model: fixed pinhole basis + per-sample thin-lens DoF jitter.

Faithful to the reference host setup (CLSuperPathTracer/CLSuperPathTracer.c:
236-243) and kernel ray generation (pathtracer.ocl:232-237):

    cam_pos     = (17, 16, 8)
    cam_forward = normalize(-6, -16, 0)
    cam_up      = 0.002 * normalize(cross(z_vect, cam_forward))
    cam_right   = 0.002 * normalize(cross(cam_forward, cam_up))
    eye_offset  = -256 * (cam_up + cam_right) + cam_forward

All GPU variants use z_vect = (0, 0, -1) (CLSuperPathTracer.c:236); the CPU
oracle uses (0, 0, +1) (simpleCPUtracer.cpp:160), which flips up/right and
rotates the image 180 degrees. ``make_camera(z_sign=...)`` selects either.

Per sample, with uniforms r1..r4 (pathtracer.ocl:233-236):

    delta     = cam_up * (r1 - .5) * 99 + cam_right * (r2 - .5) * 99
    origin    = cam_pos + delta
    direction = normalize(-delta + (cam_up*(r3 + i) + cam_right*(j + r4)
                                    + eye_offset) * 16)

where (i, j) are the pixel coordinates (global ids).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Camera:
    pos: np.ndarray
    forward: np.ndarray
    up: np.ndarray
    right: np.ndarray
    eye_offset: np.ndarray
    lens_jitter: float = 99.0
    fov_scale: float = 16.0


def _normalize(x: np.ndarray) -> np.ndarray:
    return (np.float32(1.0) / np.sqrt(np.float32(np.dot(x, x)))) * x


def make_camera(z_sign: float = -1.0) -> Camera:
    """z_sign=-1: GPU-variant basis; z_sign=+1: CPU-oracle basis."""
    f32 = np.float32
    pos = np.array([17, 16, 8], f32)
    z_vect = np.array([0, 0, z_sign], f32)
    forward = _normalize(np.array([-6, -16, 0], f32))
    up = f32(0.002) * _normalize(np.cross(z_vect, forward).astype(f32))
    right = f32(0.002) * _normalize(np.cross(forward, up).astype(f32))
    eye_offset = f32(-256) * (up + right) + forward
    return Camera(pos=pos, forward=forward, up=up, right=right,
                  eye_offset=eye_offset)


def primary_rays_xyz(cam: Camera, i, j, r1, r2, r3, r4):
    """Primary rays as six per-component arrays (ox, oy, oz, dx, dy, dz).

    ``i``/``j`` are pixel-coordinate arrays (float32), ``r1..r4`` uniforms
    with the same shape.  The fused super kernel (ops/pallas_super.py)
    runs this form; it is :func:`primary_rays` up to the summation order
    of the direction's norm (last-ulp differences, pinned by
    tests/test_scene.py)."""
    f32 = np.float32
    lj = f32(cam.lens_jitter)
    fs = f32(cam.fov_scale)
    e1 = (r1 - f32(0.5)) * lj
    e2 = (r2 - f32(0.5)) * lj
    a = r3 + i
    b = j + r4
    o, d = [], []
    for c in range(3):
        delta = f32(cam.up[c]) * e1 + f32(cam.right[c]) * e2
        o.append(f32(cam.pos[c]) + delta)
        d.append(-delta + (f32(cam.up[c]) * a + f32(cam.right[c]) * b
                           + f32(cam.eye_offset[c])) * fs)
    inv_norm = f32(1.0) / jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return (o[0], o[1], o[2],
            d[0] * inv_norm, d[1] * inv_norm, d[2] * inv_norm)


def primary_rays(cam: Camera, i, j, r1, r2, r3, r4):
    """Batched primary ray generation.

    ``i``/``j`` are pixel-coordinate arrays (float32 or int), ``r1..r4``
    uniforms with the same shape. Returns origin/direction as (..., 3).
    """
    i = jnp.asarray(i, jnp.float32)
    j = jnp.asarray(j, jnp.float32)
    up = jnp.asarray(cam.up)
    right = jnp.asarray(cam.right)
    eye = jnp.asarray(cam.eye_offset)
    pos = jnp.asarray(cam.pos)

    lj = np.float32(cam.lens_jitter)
    fs = np.float32(cam.fov_scale)

    delta = (up * ((r1 - np.float32(0.5)) * lj)[..., None]
             + right * ((r2 - np.float32(0.5)) * lj)[..., None])
    origin = pos + delta
    d = (-delta
         + (up * (r3 + i)[..., None] + right * (j + r4)[..., None] + eye) * fs)
    inv_norm = 1.0 / jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
    return origin, d * inv_norm

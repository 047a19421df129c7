import os

import numpy as np
import pytest

from opencl_montecarlo_path_tracing_tpu.scene import (
    load_scene, bitmap_to_spheres, bitmap_to_squares,
)
from opencl_montecarlo_path_tracing_tpu.scene.scene import SIMPLE_G, simple_scene
from opencl_montecarlo_path_tracing_tpu.core.camera import make_camera
from tests.conftest import REFERENCE_DIR, reference_available

SUPER_DIR = os.path.join(REFERENCE_DIR, "CLSuperPathTracer")


def test_bitmap_expansion():
    # spheres.txt of the super scene: 1024 at j=0, 2048 at j=7
    bits = np.zeros(9, np.int64)
    bits[0] = 1 << 10
    bits[7] = 1 << 11
    c = bitmap_to_spheres(bits)
    assert c.shape == (2, 3)
    assert {tuple(v) for v in c.tolist()} == {(10.0, 0.0, 4.0), (11.0, 0.0, 11.0)}
    sq = bitmap_to_squares(bits)
    assert {tuple(v) for v in sq.tolist()} == {(10.0, 0.0), (11.0, 7.0)}


def test_simple_scene_counts():
    s = simple_scene()
    # number of set bits in the business-card bitmap
    assert s.n_spheres == sum(bin(int(g)).count("1") for g in SIMPLE_G)
    assert s.n_squares == 0 and s.n_triangles == 0 and s.n_lights == 0


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_load_reference_super_scene():
    s = load_scene(SUPER_DIR)
    assert s.n_spheres == 2
    assert s.n_squares == 4
    assert s.n_triangles == 96
    assert s.n_lights == 2
    np.testing.assert_allclose(s.lights[0], [10, 4, 10, 200])
    np.testing.assert_allclose(s.lights[1], [15, 2, 7, 150])
    vmin, vmax = s.triangle_aabb()
    assert (vmin < vmax).all()
    # torus.txt alternative mesh parses in the same format
    from opencl_montecarlo_path_tracing_tpu.scene.formats import parse_triangles_file
    torus = parse_triangles_file(os.path.join(SUPER_DIR, "torus.txt"))
    assert torus.shape[1:] == (3, 3) and torus.shape[0] >= 30


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_trianglegrid_scene_lights():
    s = load_scene(os.path.join(REFERENCE_DIR, "CLSuperPathTracer_trianglegrid"))
    np.testing.assert_allclose(s.lights[:, 3], [400, 300])


def test_camera_matches_reference_printout():
    # CPU basis (z_vect=(0,0,1)): values printed in the reference host code
    # comment (CLSimplePathTracer.c:152-157)
    cam = make_camera(z_sign=+1.0)
    np.testing.assert_allclose(cam.up, [0.001873, -0.000702, 0.0], atol=2e-6)
    np.testing.assert_allclose(cam.right, [0.0, 0.0, 0.002], atol=1e-7)
    np.testing.assert_allclose(cam.eye_offset, [-0.830524, -0.756554, -0.512],
                               atol=2e-5)
    # GPU basis is the negation of up/right (z_vect=(0,0,-1))
    gpu = make_camera(z_sign=-1.0)
    np.testing.assert_allclose(gpu.up, -cam.up, atol=1e-7)
    np.testing.assert_allclose(gpu.right, -cam.right, atol=1e-7)


def test_primary_rays_match_oracle_ray_gen():
    """The JAX camera and the independent NumPy oracle generate identical
    rays from identical uniforms."""
    import numpy as np
    from opencl_montecarlo_path_tracing_tpu.core.camera import (
        make_camera, primary_rays,
    )
    from opencl_montecarlo_path_tracing_tpu.models import oracle as O

    f32 = np.float32
    rng = np.random.default_rng(0)
    n = 64
    ii = rng.integers(0, 256, n).astype(f32)
    jj = rng.integers(0, 256, n).astype(f32)
    r = rng.random((4, n), f32)

    cam = make_camera(z_sign=-1.0)
    o_jax, d_jax = primary_rays(cam, ii, jj, r[0], r[1], r[2], r[3])

    # oracle formulation (models/oracle.py render loop)
    z_vec = np.array([0, 0, -1], f32)
    fwd = O._normalize(np.array([-6, -16, 0], f32))
    up = f32(0.002) * O._normalize(np.cross(z_vec, fwd).astype(f32))
    right = f32(0.002) * O._normalize(np.cross(fwd, up).astype(f32))
    eye = f32(-256) * (up + right) + fwd
    pos = np.array([17, 16, 8], f32)
    delta = up * ((r[0] - 0.5) * 99)[:, None] + right * ((r[1] - 0.5) * 99)[:, None]
    o_np = pos + delta
    d_np = O._normalize(-delta + (up * (r[2] + ii)[:, None]
                                  + right * (jj + r[3])[:, None] + eye) * 16)
    np.testing.assert_allclose(np.asarray(o_jax), o_np, atol=1e-5)
    np.testing.assert_allclose(np.asarray(d_jax), d_np, atol=1e-6)


def test_primary_rays_xyz_matches_primary_rays():
    """The per-component camera the fused kernel runs equals the stacked
    camera of the XLA path up to the norm's summation order (1 ulp)."""
    import numpy as np
    from opencl_montecarlo_path_tracing_tpu.core.camera import (
        make_camera, primary_rays, primary_rays_xyz,
    )

    f32 = np.float32
    rng = np.random.default_rng(1)
    n = 256
    ii = rng.integers(0, 1024, n).astype(f32)
    jj = rng.integers(0, 1024, n).astype(f32)
    r = rng.random((4, n), f32)
    cam = make_camera(z_sign=-1.0)
    o, d = primary_rays(cam, ii, jj, *r)
    xyz = primary_rays_xyz(cam, ii, jj, *r)
    np.testing.assert_array_equal(np.stack(xyz[:3], -1), np.asarray(o))
    np.testing.assert_array_max_ulp(np.stack(xyz[3:], -1), np.asarray(d),
                                    maxulp=1)

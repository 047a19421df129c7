"""The division-free triangle scan serves every mesh size: at 2,048
triangles and more it must still equal the NumPy oracle's per-triangle
Moller-Trumbore (models/oracle_super.py::_trace), for closest hit and
for occlusion, in both quirk modes."""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp

from opencl_montecarlo_path_tracing_tpu.core.quirks import DEFAULT, REFERENCE
from opencl_montecarlo_path_tracing_tpu.models.oracle_super import _trace
from opencl_montecarlo_path_tracing_tpu.ops import intersect as I
from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
    demo_scene, ripple_sheet_mesh)


def _scene_and_rays(n_rays=256, seed=4):
    scene = dataclasses.replace(demo_scene(prefer_reference=False)[0],
                                triangles=ripple_sheet_mesh(32, 32))
    assert scene.triangles.shape[0] >= 2048
    rng = np.random.default_rng(seed)
    tri = scene.triangles
    # aim at random triangle centroids from around the camera, so most
    # rays hit the sheet and some graze or miss it
    target = tri[rng.integers(0, tri.shape[0], n_rays)].mean(axis=1)
    target += rng.normal(0, 0.5, target.shape).astype(np.float32)
    o = (np.array([17, 16, 8], np.float32)
         + rng.normal(0, 1.0, (n_rays, 3)).astype(np.float32))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return scene, o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("quirks", [DEFAULT, REFERENCE],
                         ids=["default", "reference"])
def test_closest_hit_matches_oracle(quirks):
    scene, o, d = _scene_and_rays()
    m_ref, t_ref, n_ref = _trace(o, d, scene, quirks)
    tr = I.trace_ray(jnp.asarray(o), jnp.asarray(d), I.prep_scene(scene),
                     quirks=quirks)
    m = np.asarray(tr.material)
    assert (m_ref == 4).mean() > 0.5          # the sheet is actually hit
    agree = m == m_ref
    assert agree.mean() >= 0.99, agree.mean()  # razor-edge ties only
    hit = agree & (m != 0)
    np.testing.assert_allclose(np.asarray(tr.t)[hit], t_ref[hit],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(tr.normal)[hit], n_ref[hit],
                               atol=1e-4)


@pytest.mark.parametrize("quirks", [DEFAULT, REFERENCE],
                         ids=["default", "reference"])
def test_any_hit_matches_oracle(quirks):
    scene, o, d = _scene_and_rays(seed=5)
    m_ref, t_ref, _ = _trace(o, d, scene, quirks)
    # per-ray cap at half the closest distance: occluded iff the closest
    # valid hit lies under the cap
    cap = np.where(m_ref != 0, t_ref * 0.5, 1e9).astype(np.float32)
    cap[::3] = 1e9
    want = (m_ref != 0) & (t_ref < cap)
    got = np.asarray(I.any_hit(jnp.asarray(o), jnp.asarray(d),
                               I.prep_scene(scene), t_limit=jnp.asarray(cap),
                               quirks=quirks))
    assert want.any() and (~want).any()
    assert (got == want).mean() >= 0.99

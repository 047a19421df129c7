"""The fused super kernel, the XLA wavefront and the NumPy oracle agree.

ops/pallas_super.py runs the whole super sample step (threefry draws,
camera, primitive scans, shadow rays, shading, spp accumulation) as one
Pallas kernel for Triton.  Here it runs in interpret mode on the CPU and
is pinned against the XLA wavefront (models/super.py::film_super, which
off CUDA is the XLA path) on small bands; the XLA wavefront is in turn
pinned against the independent NumPy oracle (models/oracle_super.py) on
common random numbers.  The card itself is exercised by chip_smoke.py.

Windows: the camera frame is fixed for 512x512, so a small window at the
origin is all sky; the content cases render a band starting at
CONTENT_ROW, where floor, shadows and diffuse geometry are in view.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from opencl_montecarlo_path_tracing_tpu.core.quirks import (
    DEFAULT, REFERENCE, REFERENCE_LMEM, Quirks)
from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.models.oracle_super import (
    render_oracle_super)
from opencl_montecarlo_path_tracing_tpu.models.super import film_super
from opencl_montecarlo_path_tracing_tpu.ops import pallas_super as K
from opencl_montecarlo_path_tracing_tpu.ops.intersect import prep_scene
from opencl_montecarlo_path_tracing_tpu.scene.builtin import (
    demo_scene, ripple_sheet_mesh)
from opencl_montecarlo_path_tracing_tpu.scene.scene import Scene
from tests.test_crn import assert_crn

CONTENT_ROW = 300
ATOL = 2e-5


def _demo():
    return demo_scene(prefer_reference=False)[0]


def _lights(n):
    """The demo scene lit by ``n`` lights spread over the view."""
    base = _demo()
    xs = np.linspace(8.0, 16.0, n, dtype=np.float32)
    lights = np.stack([xs, np.full(n, 3.0, np.float32),
                       np.linspace(7.0, 11.0, n, dtype=np.float32),
                       np.full(n, 150.0, np.float32)], axis=1)
    return dataclasses.replace(base, lights=lights)


def _sheet():
    """2,048 triangles: a coarse ripple sheet across the view."""
    return dataclasses.replace(_demo(),
                               triangles=ripple_sheet_mesh(32, 32))


def _carry():
    """A sphere wall BEYOND the primary-hit distance on the shadow path
    (floor at t ~ 91 from the camera, occluders at 150 toward a z=300
    light), so the _lmem carried t changes occlusions."""
    return Scene(
        sphere_centers=np.array([[20 + i, -75.0, 150.0] for i in range(10)],
                                np.float32),
        square_kj=np.zeros((0, 2), np.float32),
        triangles=np.zeros((0, 3, 3), np.float32),
        lights=np.array([[25.0, -75.0, 300.0, 400.0]], np.float32))


def _no_triangles():
    return dataclasses.replace(_demo(),
                               triangles=np.zeros((0, 3, 3), np.float32))


# name: (scene, quirks, width, spp, window kwargs)
CASES = {
    "default": (_demo, DEFAULT, 32, 2, dict(row_offset=CONTENT_ROW, rows=16)),
    "reference_quirks": (_demo, REFERENCE, 32, 2,
                         dict(row_offset=CONTENT_ROW, rows=16)),
    "carry_t": (_carry, REFERENCE_LMEM, 32, 2,
                dict(row_offset=CONTENT_ROW, rows=12)),
    "odd_size_padding": (_demo, DEFAULT, 31, 2,
                         dict(row_offset=CONTENT_ROW, rows=7)),
    "spp_window": (_demo, DEFAULT, 32, 2,
                   dict(spp_offset=2, spp_total=6, row_offset=CONTENT_ROW,
                        rows=8)),
    "row_band_sky": (_demo, DEFAULT, 32, 1, dict(row_offset=4, rows=4)),
    "one_light": (lambda: _lights(1), DEFAULT, 32, 2,
                  dict(row_offset=CONTENT_ROW, rows=8)),
    "eight_lights": (lambda: _lights(8), DEFAULT, 16, 1,
                     dict(row_offset=CONTENT_ROW, rows=8)),
    "mesh_2048": (_sheet, DEFAULT, 32, 1, dict(row_offset=CONTENT_ROW,
                                               rows=8)),
    "no_triangles": (_no_triangles, DEFAULT, 32, 2,
                     dict(row_offset=CONTENT_ROW, rows=8)),
}


def xla_film(scene, quirks, width, spp, kw):
    scn = prep_scene(scene)
    rows = kw.get("rows")
    height = kw.get("row_offset", 0) + rows
    return np.asarray(jax.jit(lambda k: film_super(
        k, scn, width, height, spp, kw.get("spp_offset", 0),
        kw.get("spp_total", spp), quirks, row_offset=kw.get("row_offset", 0),
        rows=rows))(make_key(3)))


def kernel_film(scene, quirks, width, spp, kw, **opts):
    scn = prep_scene(scene)
    height = kw.get("row_offset", 0) + kw["rows"]
    return np.asarray(jax.jit(lambda k: K.film_super_kernel(
        k, scn, width, height, spp, quirks=quirks, interpret=True, **kw,
        **opts))(make_key(3)))


@pytest.mark.parametrize("name", sorted(CASES) + ["block64_warps2"])
def test_kernel_matches_xla(name):
    opts = {}
    if name == "block64_warps2":
        name, opts = "odd_size_padding", dict(block=64, num_warps=2)
    make, quirks, width, spp, kw = CASES[name]
    want = xla_film(make(), quirks, width, spp, kw)
    got = kernel_film(make(), quirks, width, spp, kw, **opts)
    assert got.shape == want.shape == (kw["rows"], width, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_xla_matches_oracle(name):
    make, quirks, width, spp, kw = CASES[name]
    scene = make()
    got = xla_film(scene, quirks, width, spp, kw)
    want = render_oracle_super(
        scene, width, kw["rows"], spp=spp, key=make_key(3), quirks=quirks,
        row_offset=kw.get("row_offset", 0),
        spp_offset=kw.get("spp_offset", 0),
        spp_total=kw.get("spp_total"))
    assert_crn(got, want, spp)


def test_carry_t_changes_occlusion():
    """The carry-t case is not vacuous: the quirk changes the film."""
    make, _, width, spp, kw = CASES["carry_t"]
    a = xla_film(make(), REFERENCE_LMEM, width, spp, kw)
    b = xla_film(make(), REFERENCE, width, spp, kw)
    assert np.abs(a - b).max() > 1e-4


def test_content_cases_see_content():
    """The content bands are not sky: the floor checker and shadows
    break the sky's smooth gradient."""
    for name in ("default", "mesh_2048", "carry_t"):
        make, quirks, width, spp, kw = CASES[name]
        assert xla_film(make(), quirks, width, spp, kw).var() > 1e-5, name


def test_kernel_inside_shard_map():
    """On the 8-device CPU mesh, each device renders its spp window with
    the kernel (traced spp_offset from axis_index) and the films psum to
    the single-device kernel film."""
    from jax.sharding import PartitionSpec as P
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        make_spp_mesh)
    scn = prep_scene(_demo())
    n, spp, w, rows = 8, 8, 16, 4
    kw = dict(row_offset=CONTENT_ROW, rows=rows, interpret=True)
    single = np.asarray(jax.jit(lambda k: K.film_super_kernel(
        k, scn, w, CONTENT_ROW + rows, spp, **kw))(make_key(9)))

    def body(k):
        idx = jax.lax.axis_index("spp")
        f = K.film_super_kernel(k, scn, w, CONTENT_ROW + rows, spp // n,
                                spp_offset=idx * jnp.uint32(spp // n),
                                spp_total=spp, **kw)
        return jax.lax.psum(f, "spp")

    sharded = np.asarray(jax.jit(jax.shard_map(
        body, mesh=make_spp_mesh(n), in_specs=(P(),), out_specs=P(),
        check_vma=False))(make_key(9)))
    np.testing.assert_allclose(sharded, single, rtol=0, atol=ATOL)


def test_nodof_kernel_route_matches_sample_buffer():
    """The NoDoF image from the kernel film (its CUDA route) equals the
    XLA sample-buffer + tree reduction to within one uint8 step: the
    kernel sums a pixel's samples in order, the reducer as a tree."""
    from opencl_montecarlo_path_tracing_tpu.models.sample_parallel import (
        render_sample_parallel)
    from opencl_montecarlo_path_tracing_tpu.ops.reduce import quantize_film
    scn = prep_scene(_demo())
    key = make_key(15)
    want = np.asarray(render_sample_parallel(key, scn, 24, 8, sample_grid=2))
    film = K.film_super_kernel(key, scn, 24, 8, 4, interpret=True)
    got = np.asarray(quantize_film(film))
    d = np.abs(want.astype(np.int32) - got.astype(np.int32))
    assert d.max() <= 1
    assert (d == 0).mean() > 0.99


def test_supported_family():
    scn = prep_scene(_demo())
    assert K.supported(scn, 5)
    assert K.supported(scn, 1)
    assert K.supported(prep_scene(_lights(8)), 5)
    assert not K.supported(scn, 0)
    assert not K.supported(prep_scene(_lights(9)), 5)


def _lowered(platform, quirks=DEFAULT, scene=None):
    scn = prep_scene(scene if scene is not None else _demo())
    fn = jax.jit(lambda k: film_super(k, scn, 16, 16, 1, 0, 1, quirks))
    return fn.trace(make_key(0)).lower(
        lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("quirks,scene", [
    (DEFAULT, None), (REFERENCE_LMEM, None), (DEFAULT, "sheet")],
    ids=["default", "carry_t", "mesh_2048"])
def test_cuda_lowering_routes_to_triton_kernel(quirks, scene):
    """A program lowered for CUDA runs the Triton kernel (and no XLA
    fallback); the kernel lowers to Triton IR at every quirk mode and
    mesh size.  The GPU compiler itself is only reached on the card."""
    txt = _lowered("cuda", quirks, _sheet() if scene == "sheet" else None)
    assert "xla.gpu.triton" in txt
    assert "super_sample" in txt


def test_cpu_lowering_runs_xla_path():
    txt = _lowered("cpu")
    assert "triton" not in txt


def test_unsupported_render_stays_on_xla_under_cuda():
    """Outside the covered family (here: no bounce at all) even a CUDA
    program takes the XLA path."""
    scn = prep_scene(_demo())
    fn = jax.jit(lambda k: film_super(k, scn, 16, 16, 1, 0, 1, DEFAULT,
                                      max_bounces=0))
    txt = fn.trace(make_key(0)).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" not in txt


def test_kernel_output_layout_and_padding():
    """The film comes back (rows, width, 3) for a pixel count that is not
    a multiple of the tile, and the tile count is the ceiling."""
    scn = prep_scene(_no_triangles())
    fn = functools.partial(K.film_super_kernel, make_key(1), scn, 13, 5, 1,
                           interpret=True, block=32, num_warps=1)
    lowered = jax.jit(fn).lower()
    film = np.asarray(lowered.compile()())
    assert film.shape == (5, 13, 3)
    assert np.isfinite(film).all()
    assert "grid_x = 3" in jax.jit(lambda: K.film_super_kernel(
        make_key(1), scn, 13, 5, 1, block=32, num_warps=1)).trace().lower(
            lowering_platforms=("cuda",)).as_text()


def test_quirks_are_static_kernel_parameters():
    """Quirk toggles change the kernel program, not its inputs."""
    a = _lowered("cuda", DEFAULT)
    b = _lowered("cuda", Quirks(accept_negative_t=True))
    assert a != b

"""Common-random-numbers oracle agreement: estimator bias < 1e-3, PROVEN.

The NumPy oracles consume the SAME threefry streams as the JAX integrators
(oracle ``key=`` mode), so every sample is identical and the comparison
isolates estimator bias from Monte-Carlo noise.  The quality criterion
(utils/metrics.py) is RMSE < 1e-3 on the display scale ((film/spp * 64) / 255 around
the ambient term); with common random numbers the agreement is float-
rounding-level at ANY spp.  Contract: >= 98% of pixels agree below 1e-5
on the display scale (two orders under the criterion).  The remaining
tail is razor-edge TIES - a sphere-silhouette discriminant or hit-vs-sky
comparison within an ulp flips between XLA's fused f32 and NumPy's, and
that sample's whole path diverges (13/1024 pixels in the simple sphere
field; the same class separates XLA on the CPU from XLA and the fused
kernel on the GPU - chip_smoke.py).

Windows: the camera frame is fixed for 512x512, so a small render at the
origin is ALL SKY and an agreement test there is vacuous for the
estimator body (see tests/test_pallas_super.py CONTENT_ROW).  Every
comparison here renders a band that contains real content - floor + diffuse geometry for the super scene (rows 372+,
cols 256+), the sphere field for the simple scene (rows 192+) - and
asserts the content is actually there.

Oracles cite: SimpleCPUTracer/simpleCPUtracer.cpp:50-119 (simple),
CLSuperPathTracer/pathtracer.ocl:48-241 (super),
CLSuperBidirectionalPathTracer/bidirectionalpathtracer.ocl:230-365 (BPT).
"""

import numpy as np
import jax
import jax.numpy as jnp

from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.core.quirks import Quirks, DEFAULT
from opencl_montecarlo_path_tracing_tpu.models.simple import render_simple
from opencl_montecarlo_path_tracing_tpu.models.oracle import render_oracle
from opencl_montecarlo_path_tracing_tpu.models.super import render_super
from opencl_montecarlo_path_tracing_tpu.models.oracle_super import (
    render_oracle_super)
from opencl_montecarlo_path_tracing_tpu.models.bidirectional import (
    film_bidirectional, render_bidirectional)
from opencl_montecarlo_path_tracing_tpu.models.oracle_bpt import (
    render_oracle_bpt, render_with_vlps)
from tests.test_render_super import small_scene

# content band for the super/BPT scene: rows 372-384 x cols 256-296 hold
# floor + ~480 diffuse pixels; the simple scene's sphere field starts
# around row 160 in the left columns
SUPER_ROW, SUPER_W = 372, 296
SIMPLE_ROW, SIMPLE_W = 192, 64


def display_diff(jax_film, oracle_film, spp):
    """Max per-pixel difference on the display scale."""
    d = np.abs(np.asarray(jax_film) - oracle_film)
    return float((d / spp * 64.0 / 255.0).max())


def assert_crn(jax_film, oracle_film, spp, tie_budget=0.02):
    """>= (1 - tie_budget) of pixels agree below 1e-5 on the display
    scale; the allowed tail is the razor-edge-tie class (module
    docstring), whose members can diverge arbitrarily (a flipped
    hit/miss changes the whole path)."""
    d = (np.abs(np.asarray(jax_film) - oracle_film)
         / spp * 64.0 / 255.0).max(axis=-1)
    q = float(np.quantile(d, 1.0 - tie_budget))
    assert q < 1e-5, (q, float(d.max()), int((d > 1e-5).sum()))


def _assert_content(film):
    """Guard against sky-only windows: real geometry breaks the smooth
    sky gradient, so per-row variance is orders above sky's."""
    f = np.asarray(film)
    assert float(f.var()) > 1e-2, f.var()


def test_super_matches_oracle_bitwise_crn():
    scene = small_scene()
    key = make_key(7)
    spp = 4
    rows = 8
    jx = np.asarray(render_super(key, scene, SUPER_W, SUPER_ROW + rows,
                                 spp=spp))[SUPER_ROW:]
    orc = render_oracle_super(scene, SUPER_W, rows, spp=spp, key=key,
                              row_offset=SUPER_ROW)
    _assert_content(orc)
    assert_crn(jx, orc, spp)


def test_super_crn_reference_quirks():
    scene = small_scene()
    key = make_key(8)
    q = Quirks.reference()
    spp = 2
    rows = 8
    jx = np.asarray(render_super(key, scene, SUPER_W, SUPER_ROW + rows,
                                 spp=spp, quirks=q))[SUPER_ROW:]
    orc = render_oracle_super(scene, SUPER_W, rows, spp=spp, key=key,
                              quirks=q, row_offset=SUPER_ROW)
    _assert_content(orc)
    assert_crn(jx, orc, spp)


def test_simple_matches_oracle_bitwise_crn():
    key = make_key(9)
    spp = 4
    rows = 16
    jx = np.asarray(render_simple(key, SIMPLE_W, SIMPLE_ROW + rows,
                                  spp=spp, max_bounces=5))[SIMPLE_ROW:]
    orc = render_oracle(SIMPLE_W, rows, spp=spp, key=key, max_depth=5,
                        row_offset=SIMPLE_ROW)
    _assert_content(orc)
    # the sphere field is silhouette-dense and the 5-bounce mirror
    # recursion amplifies fma-vs-plain f32 rounding, so the tie tail is
    # wider here (28/1024 pixels above 1e-5, the rest at rounding level)
    assert_crn(jx, orc, spp, tie_budget=0.05)


def test_bidirectional_matches_oracle_bitwise_crn():
    """Emission + gather + shadow corrections under CRN.  Real emission
    on the small scene yields almost no live VLPs, so the gather term is
    additionally pinned with a shared synthetic live table below."""
    scene = small_scene()
    key = make_key(10)
    spp = 2
    rows = 8
    jx = np.asarray(render_bidirectional(key, scene, SUPER_W,
                                         SUPER_ROW + rows, spp=spp,
                                         n_vlp=32))[SUPER_ROW:]
    orc = render_oracle_bpt(scene, SUPER_W, rows, spp=spp, n_vlp=32,
                            key=key, row_offset=SUPER_ROW)
    # with ~0 live VLPs the film is the occlusion-correction texture
    # only - structured (non-sky) but low variance
    assert float(np.asarray(orc).var()) > 1e-4
    assert_crn(jx, orc, spp)


def test_bidirectional_gather_crn_live_vlps():
    """The dense VLP gather's bias under CRN with a guaranteed-live
    table (placed over the band's floor points)."""
    from opencl_montecarlo_path_tracing_tpu.ops.intersect import prep_scene
    scene = small_scene()
    scn = prep_scene(scene)
    key = make_key(12)
    spp = 2
    rows = 8
    rng = np.random.RandomState(0)
    v = np.zeros((24, 4), np.float32)
    live = rng.choice(24, 10, replace=False)
    v[live, 0] = rng.uniform(18.0, 30.0, 10)
    v[live, 1] = rng.uniform(-95.0, -55.0, 10)
    v[live, 2] = rng.uniform(1.0, 6.0, 10)
    v[live, 3] = rng.uniform(1.0, 8.0, 10)
    vlps = jnp.asarray(v)
    jx = np.asarray(jax.jit(lambda k: film_bidirectional(
        k, scn, 40, SUPER_ROW + rows, spp, 0, spp, 8, DEFAULT,
        precomputed_vlps=vlps))(key))[SUPER_ROW:]
    orc = render_with_vlps(scene, v, 40, rows, spp=spp, key=key,
                           row_offset=SUPER_ROW)
    zero = render_with_vlps(scene, np.zeros((24, 4), np.float32), 40, rows,
                            spp=spp, key=key, row_offset=SUPER_ROW)
    assert np.abs(orc - zero).max() > 1e-3  # the gather contributes
    assert_crn(jx, orc, spp)


def test_crn_spp_window_composition():
    """CRN + spp windows: two half-renders of the oracle's sample space sum
    to the full JAX render (pins that ray ids, not draw order, define the
    sample content)."""
    scene = small_scene()
    key = make_key(11)
    rows = 4
    a = np.asarray(render_super(key, scene, 8, SUPER_ROW + rows, spp=2,
                                spp_offset=0, spp_total=4))[SUPER_ROW:]
    b = np.asarray(render_super(key, scene, 8, SUPER_ROW + rows, spp=2,
                                spp_offset=2, spp_total=4))[SUPER_ROW:]
    orc = render_oracle_super(scene, 8, rows, spp=4, key=key,
                              row_offset=SUPER_ROW)
    assert_crn(a + b, orc, 4)

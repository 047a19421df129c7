import numpy as np

from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.models.simple import render_simple
from opencl_montecarlo_path_tracing_tpu.models.oracle import render_oracle


def rmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean()))


def test_smoke_and_determinism():
    key = make_key(42)
    f1 = np.asarray(render_simple(key, 32, 32, spp=4))
    f2 = np.asarray(render_simple(key, 32, 32, spp=4))
    assert f1.shape == (32, 32, 3)
    assert np.isfinite(f1).all()
    np.testing.assert_array_equal(f1, f2)
    # different seed -> different image
    f3 = np.asarray(render_simple(make_key(43), 32, 32, spp=4))
    assert not np.array_equal(f1, f3)


def test_spp_window_composition():
    """Rendering spp in two windows sums to the full render (bit-exact),
    the property that makes spp sharding lossless."""
    key = make_key(7)
    full = np.asarray(render_simple(key, 16, 16, spp=8))
    a = np.asarray(render_simple(key, 16, 16, spp=4, spp_offset=0, spp_total=8))
    b = np.asarray(render_simple(key, 16, 16, spp=4, spp_offset=4, spp_total=8))
    np.testing.assert_allclose(a + b, full, rtol=0, atol=1e-4)


def test_matches_oracle():
    """The JAX wavefront tracer and the independent NumPy recursive oracle
    estimate the same image (identical math, independent RNGs): per-pixel
    means converge as spp grows."""
    key = make_key(123)
    w, rows, r0 = 64, 16, 192   # the sphere field (content, not sky)
    spp = 256
    film_jax = np.asarray(render_simple(key, w, r0 + rows,
                                        spp=spp))[r0:] / spp
    film_orc = render_oracle(w, rows, spp=spp, seed=9, row_offset=r0) / spp
    assert float(np.asarray(film_orc).var()) > 1e-4
    # average per-sample radiance is O(3.5 * a few); Monte-Carlo noise at
    # 256 spp dominates any residual -> demand close agreement
    err = rmse(film_jax, film_orc)
    scale = max(1e-6, float(np.abs(film_orc).mean()))
    assert err / scale < 0.08, (err, scale)
    # and the images are actually correlated (not both ~constant)
    c = np.corrcoef(film_jax.reshape(-1), film_orc.reshape(-1))[0, 1]
    assert c > 0.98, c

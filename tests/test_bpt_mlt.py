import numpy as np

from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.models.bidirectional import (
    render_bidirectional,
)
from opencl_montecarlo_path_tracing_tpu.models.metropolis import (
    render_metropolis, mlt_vlps,
)
from opencl_montecarlo_path_tracing_tpu.ops.intersect import prep_scene
from tests.test_render_super import small_scene


def test_bidirectional_smoke_and_determinism():
    key = make_key(41)
    scene = small_scene()
    a = np.asarray(render_bidirectional(key, scene, 16, 16, spp=2, n_vlp=64))
    b = np.asarray(render_bidirectional(key, scene, 16, 16, spp=2, n_vlp=64))
    assert a.shape == (16, 16, 3)
    assert np.isfinite(a).all()
    assert a.max() > 0
    np.testing.assert_array_equal(a, b)


def test_bidirectional_spp_window_composition():
    key = make_key(42)
    scene = small_scene()
    full = np.asarray(render_bidirectional(key, scene, 8, 8, spp=4, n_vlp=32))
    a = np.asarray(render_bidirectional(key, scene, 8, 8, spp=2, n_vlp=32,
                                        spp_offset=0, spp_total=4))
    b = np.asarray(render_bidirectional(key, scene, 8, 8, spp=2, n_vlp=32,
                                        spp_offset=2, spp_total=4))
    np.testing.assert_allclose(a + b, full, rtol=0, atol=1e-4)


def test_bidirectional_grid_variant_runs():
    key = make_key(43)
    scene = small_scene()
    f = np.asarray(render_bidirectional(key, scene, 8, 8, spp=1, n_vlp=32,
                                        use_grid=True))
    assert np.isfinite(f).all()


def test_mlt_vlps_structure():
    # live VLPs need a surface lit from behind its normal (see
    # tests/test_vlp.py::vlp_scene): a square directly above the light
    from tests.test_vlp import vlp_scene
    scn = prep_scene(vlp_scene())
    vlps = np.asarray(mlt_vlps(make_key(5), scn, n_seedpaths=256,
                               mutation_rounds=3))
    # nlights(1) * nseed(256) * 4 slots
    assert vlps.shape == (1024, 4)
    assert np.isfinite(vlps).all()
    live = vlps[:, 3] > 0
    assert live.any()
    # depth-halved intensity: max is base(400 floor)/(1<<0)/den; here the
    # emitting surface is a square (material 3, base 40), den = max(1,
    # 256 // 256) = 1
    assert vlps[:, 3].max() <= 400.0 + 1e-4
    assert (vlps[:, 3] >= 0).all()


def test_metropolis_render_smoke():
    key = make_key(44)
    scene = small_scene()
    a = np.asarray(render_metropolis(key, scene, 12, 12, spp=1,
                                     n_seedpaths=32, mutation_rounds=2))
    assert a.shape == (12, 12, 3)
    assert np.isfinite(a).all()
    b = np.asarray(render_metropolis(key, scene, 12, 12, spp=1,
                                     n_seedpaths=32, mutation_rounds=2))
    np.testing.assert_array_equal(a, b)


def test_metropolis_vlpgrid_variant_runs():
    key = make_key(45)
    f = np.asarray(render_metropolis(key, small_scene(), 8, 8, spp=1,
                                     n_seedpaths=16, mutation_rounds=2,
                                     use_grid=True))
    assert np.isfinite(f).all()


def test_metropolis_exact_verify_rejects_mutations():
    """verify_eps=0 reproduces the reference's exact-equality rejection; the
    render still works (mutations rejected, vertex additions still happen)."""
    key = make_key(46)
    f = np.asarray(render_metropolis(key, small_scene(), 8, 8, spp=1,
                                     n_seedpaths=16, mutation_rounds=2,
                                     verify_eps=0.0))
    assert np.isfinite(f).all()


def test_bidirectional_matches_oracle():
    """End-to-end statistical agreement with the independent NumPy BPT
    oracle (different camera RNGs; agreement is in the means) over a
    SHARED live VLP table on a floor band.  small_scene emission is
    ~all-dead (the reference's lamb test keeps only from-behind hits,
    ocl:254), so the render pass gathers nothing from its own VLPs and a
    statistical comparison there would be vacuous - the shared table
    keeps the gather term live; emission itself is pinned by
    tests/test_vlp.py and the CRN tests."""
    import jax
    from opencl_montecarlo_path_tracing_tpu.models.bidirectional import (
        film_bidirectional)
    from opencl_montecarlo_path_tracing_tpu.models.oracle_bpt import (
        render_with_vlps)
    from opencl_montecarlo_path_tracing_tpu.ops.intersect import prep_scene
    import jax.numpy as jnp
    scene = small_scene()
    scn = prep_scene(scene)
    w, rows, r0 = 48, 8, 372   # floor band (content, not sky)
    spp = 96
    rng = np.random.RandomState(1)
    v = np.zeros((32, 4), np.float32)
    live = rng.choice(32, 12, replace=False)
    v[live, 0] = rng.uniform(18.0, 30.0, 12)
    v[live, 1] = rng.uniform(-95.0, -55.0, 12)
    v[live, 2] = rng.uniform(1.0, 6.0, 12)
    v[live, 3] = rng.uniform(1.0, 8.0, 12)
    from opencl_montecarlo_path_tracing_tpu.core.quirks import DEFAULT
    jx = np.asarray(jax.jit(lambda k: film_bidirectional(
        k, scn, w, r0 + rows, spp, 0, spp, 8, DEFAULT,
        precomputed_vlps=jnp.asarray(v)))(make_key(61)))[r0:] / spp
    orc = render_with_vlps(scene, v, w, rows, spp=spp,
                           rng=np.random.default_rng(4),
                           row_offset=r0) / spp
    scale = max(1e-6, float(np.abs(orc).mean()))
    # content guard: real per-pixel structure, not a constant field
    assert float(np.asarray(orc).std()) > 0.05 * scale
    err = float(np.sqrt(((jx - orc) ** 2).mean()))
    assert err / scale < 0.12, (err, scale)
    c = np.corrcoef(jx.reshape(-1), orc.reshape(-1))[0, 1]
    assert c > 0.95, c


def test_metropolis_mutation_rounds_have_effect():
    """Mutation rounds must change the VLP set (the reference's by-value
    RNG bug made all rounds replay identical randomness; the rebuild's
    counter streams give each round fresh draws)."""
    from tests.test_vlp import vlp_scene
    scn = prep_scene(vlp_scene())
    v0 = np.asarray(mlt_vlps(make_key(5), scn, n_seedpaths=512,
                             mutation_rounds=0))
    v8 = np.asarray(mlt_vlps(make_key(5), scn, n_seedpaths=512,
                             mutation_rounds=8))
    assert v0.shape == v8.shape
    assert (v0[:, 3] > 0).any() and (v8[:, 3] > 0).any()
    assert not np.array_equal(v0, v8)


def test_metropolis_spp_window_composition():
    key = make_key(47)
    scene = small_scene()
    full = np.asarray(render_metropolis(key, scene, 8, 8, spp=4,
                                        n_seedpaths=16, mutation_rounds=2))
    a = np.asarray(render_metropolis(key, scene, 8, 8, spp=2, spp_offset=0,
                                     spp_total=4, n_seedpaths=16,
                                     mutation_rounds=2))
    b = np.asarray(render_metropolis(key, scene, 8, 8, spp=2, spp_offset=2,
                                     spp_total=4, n_seedpaths=16,
                                     mutation_rounds=2))
    np.testing.assert_allclose(a + b, full, rtol=0, atol=1e-4)


def test_mutate_chain_invariants():
    """Property tests on the batched Mutate round (metropolispathtracer.ocl
    239-283 semantics): lengths stay in [0, 4]; vertices below the filled
    length lie on scene surfaces (a re-trace toward them finds a hit within
    the verification epsilon of the construction); empty chains are only
    rebuilt, non-empty chains never become empty."""
    import jax.numpy as jnp
    from opencl_montecarlo_path_tracing_tpu.core.quirks import DEFAULT
    from opencl_montecarlo_path_tracing_tpu.models import metropolis as M
    from opencl_montecarlo_path_tracing_tpu.ops.intersect import trace_ray
    from tests.test_vlp import vlp_scene

    scn = prep_scene(vlp_scene())
    n = 128
    lp = jnp.broadcast_to(jnp.asarray(scn.lights[0, :3], jnp.float32), (n, 3))
    key = make_key(13)
    v, length = M._random_path(key, scn, DEFAULT, lp,
                               np.uint32(M._SITE_SEED), jnp.ones(n, bool))
    len0 = np.asarray(length)
    assert ((0 <= len0) & (len0 <= 4)).all()

    for rnd in range(3):
        v, length = M._mutate(key, scn, DEFAULT, 1e-3, lp, v, length,
                              jnp.uint32(rnd))
        ln = np.asarray(length)
        assert ((0 <= ln) & (ln <= 4)).all()
        # chains that had vertices keep at least one (Mutate never truncates
        # below 1; rejected mutations keep the seed path)
        assert (ln[len0 > 0] >= 1).all()

    # every filled vertex lies on a surface: tracing from the previous
    # vertex toward it hits something at ~that point
    vv = np.asarray(v)
    ln = np.asarray(length)
    origin = np.asarray(lp)
    for i in range(4):
        mask = ln > i
        if not mask.any():
            continue
        seg = vv[mask, i, :] - origin[mask]
        dist = np.linalg.norm(seg, axis=-1)
        d = seg / np.maximum(dist[:, None], 1e-9)
        tr = trace_ray(jnp.asarray(origin[mask]), jnp.asarray(d), scn,
                       quirks=DEFAULT)
        hit = np.asarray(tr.material) != 0
        assert hit.all()
        t = np.asarray(tr.t)
        np.testing.assert_allclose(t[hit], dist[hit], atol=2e-2, rtol=1e-3)
        origin = np.where(mask[:, None], vv[:, i, :], origin)

import numpy as np
import jax

from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.models.super import render_super
from opencl_montecarlo_path_tracing_tpu.parallel import (
    make_spp_mesh, render_super_sharded,
)
from tests.test_render_super import small_scene


def test_mesh_has_8_virtual_devices():
    assert jax.device_count() == 8


def test_sharded_render_matches_single_device():
    """spp sharded over 8 devices + psum == single-device render.

    Counter-based RNG makes the drawn samples identical; only float
    summation order differs."""
    scene = small_scene()
    key = make_key(21)
    w = h = 16
    spp = 16
    single = np.asarray(render_super(key, scene, w, h, spp=spp))
    mesh = make_spp_mesh(8)
    sharded = np.asarray(render_super_sharded(key, scene, w, h, spp, mesh))
    np.testing.assert_allclose(sharded, single, rtol=0, atol=2e-3)


def test_sharded_render_subset_mesh():
    scene = small_scene()
    key = make_key(22)
    mesh = make_spp_mesh(2)
    f = np.asarray(render_super_sharded(key, scene, 8, 8, 4, mesh))
    single = np.asarray(render_super(key, scene, 8, 8, spp=4))
    np.testing.assert_allclose(f, single, rtol=0, atol=2e-3)


def test_sharded_bidirectional_matches_single():
    from opencl_montecarlo_path_tracing_tpu.models.bidirectional import (
        render_bidirectional,
    )
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        render_bidirectional_sharded,
    )
    scene = small_scene()
    key = make_key(23)
    single = np.asarray(render_bidirectional(key, scene, 8, 8, spp=4,
                                             n_vlp=32))
    sharded = np.asarray(render_bidirectional_sharded(
        key, scene, 8, 8, 4, make_spp_mesh(4), n_vlp=32))
    np.testing.assert_allclose(sharded, single, rtol=0, atol=2e-3)


def test_sharded_trianglegrid_matches_single():
    from opencl_montecarlo_path_tracing_tpu.models.trianglegrid import (
        render_trianglegrid,
    )
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        render_trianglegrid_sharded,
    )
    scene = small_scene()
    key = make_key(25)
    single = np.asarray(render_trianglegrid(key, scene, 8, 8, spp=4))
    sharded = np.asarray(render_trianglegrid_sharded(
        key, scene, 8, 8, 4, make_spp_mesh(4)))
    np.testing.assert_allclose(sharded, single, rtol=0, atol=2e-3)


def test_sharded_sample_parallel_matches_single():
    """Row-sharded NoDoF == single-device, bit-for-bit (uint8 output and
    per-pixel reduction make the summation order identical too)."""
    from opencl_montecarlo_path_tracing_tpu.models.sample_parallel import (
        render_sample_parallel,
    )
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        render_sample_parallel_sharded,
    )
    scene = small_scene()
    key = make_key(26)
    single = np.asarray(render_sample_parallel(key, scene, 8, 8,
                                               sample_grid=2))
    sharded = np.asarray(render_sample_parallel_sharded(
        key, scene, 8, 8, sample_grid=2, mesh=make_spp_mesh(4, axis="y")))
    np.testing.assert_array_equal(sharded, single)


def test_sharded_simple_matches_single():
    """spp-sharded multi-bounce mirror tracer == single-device render
    (CLSimplePathTracer family; the scene is built in, no scene arg)."""
    from opencl_montecarlo_path_tracing_tpu.models.simple import render_simple
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        render_simple_sharded,
    )
    key = make_key(27)
    single = np.asarray(render_simple(key, 8, 8, spp=8))
    sharded = np.asarray(render_simple_sharded(key, 8, 8, 8,
                                               make_spp_mesh(4)))
    np.testing.assert_allclose(sharded, single, rtol=0, atol=2e-3)


def test_sharded_metropolis_grid_mode_matches_single():
    """The vlpgrid variant's grid-limited gather
    (CLSuperMetropolisPathTracer_vlpgrid/metropolispathtracer.ocl:326-349)
    under shard_map == single-device."""
    from opencl_montecarlo_path_tracing_tpu.models.metropolis import (
        render_metropolis,
    )
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        render_metropolis_sharded,
    )
    scene = small_scene()
    key = make_key(28)
    single = np.asarray(render_metropolis(key, scene, 8, 8, spp=4,
                                          n_seedpaths=16, mutation_rounds=2,
                                          use_grid=True))
    sharded = np.asarray(render_metropolis_sharded(
        key, scene, 8, 8, 4, make_spp_mesh(2), n_seedpaths=16,
        mutation_rounds=2, use_grid=True))
    np.testing.assert_allclose(sharded, single, rtol=0, atol=2e-3)


def test_sharded_metropolis_forwards_grid_modifier(monkeypatch):
    """A non-default CELL_SIZE_MODIFIER (the vlpgrid CLI positional,
    .c:433) must reach the sharded render's film_metropolis — regression
    test for the round-4 advisor finding (grid_modifier was accepted and
    cache-keyed by render_metropolis_sharded but silently dropped, so
    sharded vlpgrid CLI renders used the default 3.0).  The film itself
    cannot distinguish modifiers at test scale (the live-VLP radii
    16*sqrt(I) cover the whole grid box), so this spies on the kwarg at
    trace time for BOTH the 1-D and the 2-D sharded renderers."""
    import opencl_montecarlo_path_tracing_tpu.models.metropolis as mltmod
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        make_mesh_2d, render_metropolis_sharded,
        render_metropolis_sharded_2d,
    )
    scene = small_scene()
    key = make_key(41)
    seen = []
    orig = mltmod.film_metropolis

    def spy(*a, **kw):
        seen.append(kw.get("grid_modifier", 3.0))
        return orig(*a, **kw)

    monkeypatch.setattr(mltmod, "film_metropolis", spy)
    kw = dict(n_seedpaths=16, mutation_rounds=2, use_grid=True,
              grid_modifier=7.5)
    f = np.asarray(render_metropolis_sharded(
        key, scene, 8, 8, 4, make_spp_mesh(2), **kw))
    assert np.isfinite(f).all()
    assert seen and all(m == 7.5 for m in seen)
    seen.clear()
    f = np.asarray(render_metropolis_sharded_2d(
        key, scene, 8, 8, 4, make_mesh_2d(2, 2), **kw))
    assert np.isfinite(f).all()
    assert seen and all(m == 7.5 for m in seen)


def test_emit_vlps_window_bitexact():
    """The lightTracer work-item window [gi0, gi0+count) emits rows
    bit-identical to the same rows of the full emission (draws key on
    the GLOBAL gi; scale_den on the global n_vlp) - the invariant the
    sharded light pass rests on."""
    from opencl_montecarlo_path_tracing_tpu.ops import vlp as vlpmod
    from opencl_montecarlo_path_tracing_tpu.ops.intersect import prep_scene
    scn = prep_scene(small_scene())
    key = make_key(31)
    n_vlp = 32
    nlights = int(scn.lights.shape[0])
    full = np.asarray(vlpmod.emit_vlps(key, scn, n_vlp))
    parts = [np.asarray(vlpmod.emit_vlps(key, scn, n_vlp,
                                         gi0=g0, count=8))
             for g0 in range(0, n_vlp, 8)]
    # part layout [l][gi window] -> reassemble to [l][gi]
    stack = np.stack(parts).reshape(4, nlights, 8, 4)
    merged = stack.transpose(1, 0, 2, 3).reshape(nlights * n_vlp, 4)
    np.testing.assert_array_equal(merged, full)


def test_mlt_vlps_chain_window_bitexact():
    """Same invariant for the Metropolis chain window: the full
    seed/Mutate/emit pipeline restricted to [chain0, chain0+chains)
    produces rows bit-identical to the full run's."""
    from opencl_montecarlo_path_tracing_tpu.models.metropolis import mlt_vlps
    from opencl_montecarlo_path_tracing_tpu.ops.intersect import prep_scene
    scn = prep_scene(small_scene())
    key = make_key(32)
    B, rounds = 16, 2
    nlights = int(scn.lights.shape[0])
    full = np.asarray(mlt_vlps(key, scn, B, rounds))
    parts = [np.asarray(mlt_vlps(key, scn, B, rounds, chain0=c0, chains=4))
             for c0 in range(0, B, 4)]
    # part layout [l][slot][chain window] -> [l][slot][chain]
    stack = np.stack(parts).reshape(4, nlights, 4, 4, 4)
    merged = stack.transpose(1, 2, 0, 3, 4).reshape(nlights * 4 * B, 4)
    np.testing.assert_array_equal(merged, full)


def test_sharded_bpt_light_pass_modes_bitexact():
    """sharded light pass == replicated light pass, BIT-EXACT: the
    all-gathered VLP table is identical, the per-device render is
    identical, and the psum order is identical."""
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        render_bidirectional_sharded,
    )
    scene = small_scene()
    key = make_key(33)
    mesh = make_spp_mesh(4)
    a = np.asarray(render_bidirectional_sharded(
        key, scene, 8, 8, 4, mesh, n_vlp=32, light_pass="sharded"))
    b = np.asarray(render_bidirectional_sharded(
        key, scene, 8, 8, 4, mesh, n_vlp=32, light_pass="replicated"))
    np.testing.assert_array_equal(a, b)


def test_sharded_mlt_light_pass_modes_bitexact():
    """Sharded chains == replicated chains for Metropolis, bit-exact,
    in both the dense and the vlpgrid gather modes (the grid is built
    per device from the gathered table - deterministic)."""
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        render_metropolis_sharded,
    )
    scene = small_scene()
    key = make_key(34)
    mesh = make_spp_mesh(4)
    for use_grid in (False, True):
        a = np.asarray(render_metropolis_sharded(
            key, scene, 8, 8, 4, mesh, n_seedpaths=16, mutation_rounds=2,
            use_grid=use_grid, light_pass="sharded"))
        b = np.asarray(render_metropolis_sharded(
            key, scene, 8, 8, 4, mesh, n_seedpaths=16, mutation_rounds=2,
            use_grid=use_grid, light_pass="replicated"))
        np.testing.assert_array_equal(a, b)


def test_sharded_metropolis_matches_single():
    from opencl_montecarlo_path_tracing_tpu.models.metropolis import (
        render_metropolis,
    )
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        render_metropolis_sharded,
    )
    scene = small_scene()
    key = make_key(24)
    single = np.asarray(render_metropolis(key, scene, 8, 8, spp=4,
                                          n_seedpaths=16, mutation_rounds=2))
    sharded = np.asarray(render_metropolis_sharded(
        key, scene, 8, 8, 4, make_spp_mesh(2), n_seedpaths=16,
        mutation_rounds=2))
    np.testing.assert_allclose(sharded, single, rtol=0, atol=2e-3)


def test_sharded_2d_vlp_integrators_match_single():
    """2-D (rows x spp) sharding for the VLP integrators with the light
    pass sharded over the FLATTENED 4x2 device set: bidirectional and
    metropolis (dense + grid) == single-device renders.  The light
    window invariance makes the gathered VLP table bit-identical, so
    the only difference is psum order (atol as the 1-D tests)."""
    from opencl_montecarlo_path_tracing_tpu.models.bidirectional import (
        render_bidirectional)
    from opencl_montecarlo_path_tracing_tpu.models.metropolis import (
        render_metropolis)
    from opencl_montecarlo_path_tracing_tpu.parallel.mesh import (
        make_mesh_2d, render_bidirectional_sharded_2d,
        render_metropolis_sharded_2d)
    scene = small_scene()
    key = make_key(39)
    mesh = make_mesh_2d(4, 2)
    w = h = 16
    spp = 4

    single = np.asarray(render_bidirectional(key, scene, w, h, spp=spp,
                                             n_vlp=32))
    sharded = np.asarray(render_bidirectional_sharded_2d(
        key, scene, w, h, spp, mesh, n_vlp=32))
    np.testing.assert_allclose(sharded, single, rtol=0, atol=2e-3)

    for use_grid in (False, True):
        single = np.asarray(render_metropolis(
            key, scene, w, h, spp=spp, n_seedpaths=16, mutation_rounds=2,
            use_grid=use_grid))
        sharded = np.asarray(render_metropolis_sharded_2d(
            key, scene, w, h, spp, mesh, n_seedpaths=16,
            mutation_rounds=2, use_grid=use_grid))
        np.testing.assert_allclose(sharded, single, rtol=0, atol=2e-3)

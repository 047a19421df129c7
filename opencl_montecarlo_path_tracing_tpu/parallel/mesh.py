"""Device-mesh parallelism: spp sharding with a film all-reduce.

The reference is a single-device codebase (one in-order cl_command_queue,
ocl_boiler.h:150); its only scaling axes are the 2-D NDRange and the
sample-parallel decomposition of CLSuperPathTracer_lmem_NoDoF
(gws = (W*8, H*8), SURVEY.md section 2 #7).  The generalisation here is:
spp is a sharded batch axis over a ``jax.sharding.Mesh``; every device
renders a disjoint sample window of the *same* logical sample space
(counter-based RNG keyed on pixel*spp_total + sample, so the set of drawn
samples is independent of the layout); the film is ``psum``-reduced over
the device interconnect (NVLink between the cards of one host, where XLA
hands collectives to NCCL).  No host round-trips anywhere in the pipeline.
Every card reaches every other at the same rate, so the mesh takes
``jax.devices()`` in order.

The per-device sample windows make the sharded image equal to the
single-device image up to float summation order (tested to atol 1e-3).
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

shard_map = jax.shard_map

from ..models.super import film_super
from ..models.common import MAX_BOUNCES
from ..ops.intersect import SceneArrays, prep_scene
from ..scene.scene import Scene
from ..core.quirks import Quirks, DEFAULT


def make_spp_mesh(n_devices: int | None = None, axis: str = "spp") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (axis,), devices=devices)


# compiled sharded programs, keyed per (mesh layout, scene, render config) -
# repeated calls must not re-trace
_COMPILED: dict = {}


def _mesh_key(mesh: Mesh):
    return (tuple(mesh.shape.items()),
            tuple(d.id for d in mesh.devices.flat))


def _cached(cfg, make_fn):
    fn = _COMPILED.get(cfg)
    if fn is None:
        fn = make_fn()
        _COMPILED[cfg] = fn
    return fn


def shard_spp(film_fn, mesh: Mesh, spp: int, axis: str = "spp",
              spp_total: int | None = None):
    """Wrap ``film_fn(key, spp_local, spp_offset, spp_total) -> film`` into
    an SPMD program taking ``(key, spp_offset)``: each device renders its
    sample window of the ``spp`` samples starting at the (traced) global
    ``spp_offset``, films are psum-reduced over the mesh axis, result
    replicated.  ``spp_total`` fixes the logical RNG stream space (defaults
    to ``spp``); pass the full-render total when rendering a checkpoint
    window so windows compose bit-exactly (utils/checkpoint.py)."""
    n = mesh.devices.size
    if spp % n:
        raise ValueError(f"spp={spp} not divisible by mesh size {n}")
    local = spp // n
    total = spp if spp_total is None else spp_total

    def body(key, spp_offset):
        idx = jax.lax.axis_index(axis)
        film = film_fn(key, local, spp_offset + idx * jnp.uint32(local),
                       total)
        return jax.lax.psum(film, axis)

    return shard_map(body, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
                     check_vma=False)


def render_super_sharded(key, scene: Scene | SceneArrays, width: int,
                         height: int, spp: int, mesh: Mesh | None = None,
                         quirks: Quirks = DEFAULT,
                         max_bounces: int = MAX_BOUNCES,
                         spp_offset: int = 0, spp_total: int | None = None):
    """Multi-device render of the full scene; returns the replicated
    pre-ambient film (H, W, 3).  ``spp_offset``/``spp_total`` select a
    sample window for checkpointed accumulation (the offset is traced, so
    every window of a resumable render shares one compiled program)."""
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if mesh is None:
        mesh = make_spp_mesh()
    cfg = ("super", scn.fingerprint(), width, height, spp, spp_total,
           quirks, max_bounces, _mesh_key(mesh))

    def make():
        def film_fn(k, local, offset, total):
            return film_super(k, scn, width, height, local, offset, total,
                              quirks, max_bounces)
        return jax.jit(shard_spp(film_fn, mesh, spp, spp_total=spp_total))

    return _cached(cfg, make)(key, jnp.uint32(spp_offset))


def render_simple_sharded(key, width: int, height: int, spp: int,
                          mesh: Mesh | None = None,
                          quirks: Quirks = DEFAULT,
                          max_bounces: int = MAX_BOUNCES,
                          spp_offset: int = 0, spp_total: int | None = None):
    """spp-sharded render of the multi-bounce mirror tracer
    (CLSimplePathTracer, the only genuinely multi-bounce GPU variant -
    CLSimplePathTracer/CLSimplePathTracer.c:85): each device renders its
    sample window of the business-card scene and films psum over the
    mesh."""
    from ..models.simple import film_simple
    if mesh is None:
        mesh = make_spp_mesh()
    cfg = ("simple", width, height, spp, spp_total, quirks, max_bounces,
           _mesh_key(mesh))

    def make():
        def film_fn(k, local, offset, total):
            return film_simple(k, width, height, local, offset, total,
                               quirks, max_bounces)
        return jax.jit(shard_spp(film_fn, mesh, spp, spp_total=spp_total))

    return _cached(cfg, make)(key, jnp.uint32(spp_offset))


def render_bidirectional_sharded(key, scene, width: int, height: int,
                                 spp: int, mesh: Mesh | None = None,
                                 n_vlp: int = 512,
                                 quirks: Quirks = DEFAULT,
                                 use_grid: bool = False,
                                 light_pass: str = "sharded",
                                 spp_offset: int = 0,
                                 spp_total: int | None = None):
    """spp-sharded bidirectional render.

    ``light_pass="sharded"`` (default): each device emits only the
    n_vlp/n work-item window of the lightTracer pass (ops/vlp.py::
    emit_vlps gi window - every draw keys on the GLOBAL work-item id,
    so window rows are bit-identical to the full emission) and the VLP
    table is ``all_gather``-ed over the mesh, reassembled to the reference's
    vlp[gi + l*n_vlp] layout.  Emission work scales 1/n instead of
    being replicated per device; the film is bit-exact vs replicated
    (tests/test_parallel.py pins all three: sharded == replicated ==
    single-device).

    ``light_pass="replicated"``: every device emits the SAME full VLP
    set (same key -> identical emission, no communication)."""
    from ..models.bidirectional import film_bidirectional
    from ..ops import vlp as vlpmod
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if mesh is None:
        mesh = make_spp_mesh()
    axis = tuple(mesh.shape.keys())[0]
    n = mesh.devices.size
    nlights = int(scn.lights.shape[0])
    if light_pass == "sharded" and (n_vlp % n or nlights == 0):
        light_pass = "replicated"   # indivisible window / no lights
    cfg = ("bpt", scn.fingerprint(), width, height, spp, spp_total, n_vlp,
           quirks, use_grid, light_pass, _mesh_key(mesh))
    total = spp if spp_total is None else spp_total

    def make():
        if spp % n:
            raise ValueError(f"spp={spp} not divisible by mesh size {n}")
        local = spp // n
        localv = n_vlp // n

        def body(k, off):
            idx = jax.lax.axis_index(axis)
            if light_pass == "sharded":
                part = vlpmod.emit_vlps(
                    k, scn, n_vlp, quirks,
                    gi0=idx * jnp.uint32(localv), count=localv)
                g = jax.lax.all_gather(part, axis)  # (n, nlights*localv, 4)
                vlps = (g.reshape(n, nlights, localv, 4)
                        .transpose(1, 0, 2, 3)
                        .reshape(nlights * n_vlp, 4))
            else:
                vlps = vlpmod.emit_vlps(k, scn, n_vlp, quirks)
            film = film_bidirectional(k, scn, width, height, local,
                                      off + idx * jnp.uint32(local), total,
                                      n_vlp, quirks, use_grid=use_grid,
                                      precomputed_vlps=vlps)
            return jax.lax.psum(film, axis)

        return jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P()),
                                 out_specs=P(), check_vma=False))

    return _cached(cfg, make)(key, jnp.uint32(spp_offset))


def render_metropolis_sharded(key, scene, width: int, height: int,
                              spp: int, mesh: Mesh | None = None,
                              n_seedpaths: int = 512,
                              mutation_rounds: int = 8,
                              quirks: Quirks = DEFAULT,
                              use_grid: bool = False,
                              grid_modifier: float = 3.0,
                              light_pass: str = "sharded",
                              spp_offset: int = 0,
                              spp_total: int | None = None):
    """spp-sharded Metropolis render.

    ``light_pass="sharded"`` (default): each device runs only the
    n_seedpaths/n chain window of the seed/Mutate/emit pipeline
    (models/metropolis.py::mlt_vlps chain window - draws key on the
    GLOBAL chain index, so window rows are bit-identical) and the VLP
    table is ``all_gather``-ed and reassembled to the reference's
    light-major, slot-minor layout.  This removes the n-fold replicated
    chain work (the sequential part of the render at default configs).

    ``light_pass="replicated"``: every device derives the identical
    full VLP set (chains keyed on (key, chain id), no communication)."""
    from ..models.metropolis import film_metropolis, mlt_vlps
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if mesh is None:
        mesh = make_spp_mesh()
    axis = tuple(mesh.shape.keys())[0]
    n = mesh.devices.size
    nlights = int(scn.lights.shape[0])
    if light_pass == "sharded" and (n_seedpaths % n or nlights == 0):
        light_pass = "replicated"
    cfg = ("mlt", scn.fingerprint(), width, height, spp, spp_total,
           n_seedpaths, mutation_rounds, quirks, use_grid, grid_modifier,
           light_pass, _mesh_key(mesh))
    total = spp if spp_total is None else spp_total

    def make():
        if spp % n:
            raise ValueError(f"spp={spp} not divisible by mesh size {n}")
        local = spp // n
        localc = n_seedpaths // n

        def body(k, off):
            idx = jax.lax.axis_index(axis)
            if light_pass == "sharded":
                part = mlt_vlps(k, scn, n_seedpaths, mutation_rounds,
                                quirks, chain0=idx * jnp.uint32(localc),
                                chains=localc)
                # part: [light][slot][chain-window] -> this repo's
                # mlt_vlps layout [light][slot][chain] (light-major,
                # slot, chain; the reference's float16 write at
                # metropolispathtracer.ocl:528 instead stores a chain's
                # 4 slots contiguously - [light][chain][slot] - see
                # models/metropolis.py for the documented difference)
                g = jax.lax.all_gather(part, axis)
                vlps = (g.reshape(n, nlights, 4, localc, 4)
                        .transpose(1, 2, 0, 3, 4)
                        .reshape(nlights * 4 * n_seedpaths, 4))
            else:
                vlps = mlt_vlps(k, scn, n_seedpaths, mutation_rounds,
                                quirks)
            film = film_metropolis(k, scn, width, height, local,
                                   off + idx * jnp.uint32(local), total,
                                   n_seedpaths, mutation_rounds, quirks,
                                   use_grid=use_grid,
                                   grid_modifier=grid_modifier,
                                   precomputed_vlps=vlps)
            return jax.lax.psum(film, axis)

        return jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P()),
                                 out_specs=P(), check_vma=False))

    return _cached(cfg, make)(key, jnp.uint32(spp_offset))


def render_trianglegrid_sharded(key, scene, width: int, height: int,
                                spp: int, mesh: Mesh | None = None,
                                cell_size_modifier: float = 3.0,
                                quirks: Quirks = DEFAULT,
                                max_bounces: int = MAX_BOUNCES,
                                spp_offset: int = 0,
                                spp_total: int | None = None):
    """spp-sharded grid-accelerated render: every device builds the SAME
    triangle grid on-device (deterministic sort-based build, ops/grid.py -
    identical everywhere, no communication) and renders its sample window;
    films psum over the mesh."""
    from ..models.trianglegrid import film_trianglegrid
    from ..ops import grid as gridmod
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if mesh is None:
        mesh = make_spp_mesh()
    cfg = ("trianglegrid", scn.fingerprint(), width, height, spp, spp_total,
           cell_size_modifier, quirks, max_bounces, _mesh_key(mesh))

    def make():
        def film_fn(k, local, offset, total):
            grid, _box = gridmod.triangle_grid(
                scn, modifier=cell_size_modifier, device=True)
            return film_trianglegrid(k, scn, grid, width, height, local,
                                     offset, total, quirks, max_bounces)
        return jax.jit(shard_spp(film_fn, mesh, spp, spp_total=spp_total))

    return _cached(cfg, make)(key, jnp.uint32(spp_offset))


def render_sample_parallel_sharded(key, scene, width: int, height: int,
                                   sample_grid: int = 8,
                                   mesh: Mesh | None = None,
                                   quirks: Quirks = DEFAULT,
                                   max_bounces: int = MAX_BOUNCES):
    """Image-row-sharded NoDoF render: the sample-parallel variant's natural
    axis is the big (H*sg, W*sg) sample buffer, so each device produces
    one horizontal *pixel-row* band (samples AND reduction stay on-device,
    models/sample_parallel.py) and the final uint8 image is all-gathered
    over the mesh.  Band content equals the single-device image exactly (ray ids are
    keyed on the global pixel index)."""
    from ..models.sample_parallel import sample_buffer
    from ..ops.reduce import reduce_samples
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if mesh is None:
        mesh = make_spp_mesh(axis="y")
    axis = tuple(mesh.shape.keys())[0]
    n = mesh.devices.size
    if height % n:
        raise ValueError(f"height={height} not divisible by mesh size {n}")
    rows = height // n
    cfg = ("nodof", scn.fingerprint(), width, height, sample_grid, quirks,
           max_bounces, _mesh_key(mesh))

    def make():
        def body(k):
            iy = jax.lax.axis_index(axis)
            buf = sample_buffer(k, scn, width, height, sample_grid, quirks,
                                max_bounces, row_offset=iy * jnp.int32(rows),
                                rows=rows)
            img = reduce_samples(buf, sample_grid, wrap=quirks.wrap_uint8)
            return jax.lax.all_gather(img, axis, axis=0, tiled=True)
        return jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),),
                                 out_specs=P(), check_vma=False))

    return _cached(cfg, make)(key)


def make_mesh_2d(n_rows: int, n_spp: int, devices=None) -> Mesh:
    """2-D mesh: image rows ('y') x samples ('spp')."""
    if devices is None:
        devices = jax.devices()
    devices = devices[:n_rows * n_spp]
    return jax.make_mesh((n_rows, n_spp), ("y", "spp"), devices=devices)


def render_super_sharded_2d(key, scene: Scene | SceneArrays, width: int,
                            height: int, spp: int, mesh: Mesh,
                            quirks: Quirks = DEFAULT,
                            max_bounces: int = MAX_BOUNCES):
    """Render sharded over BOTH the image-row axis and the spp axis:
    each device renders a (rows/n_y) band for its spp window; films are
    psum-reduced over 'spp' and all-gathered over 'y'.
    Sample content is identical to the single-device render."""
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    ny = mesh.shape["y"]
    nspp = mesh.shape["spp"]
    if height % ny or spp % nspp:
        raise ValueError(f"height={height} % {ny} or spp={spp} % {nspp} != 0")
    rows = height // ny
    local = spp // nspp
    cfg = ("super2d", scn.fingerprint(), width, height, spp, quirks,
           max_bounces, _mesh_key(mesh))

    def make():
        def body(k):
            iy = jax.lax.axis_index("y")
            isp = jax.lax.axis_index("spp")
            film = film_super(k, scn, width, height, local,
                              isp * jnp.uint32(local), spp, quirks,
                              max_bounces,
                              row_offset=iy * jnp.uint32(rows), rows=rows)
            film = jax.lax.psum(film, "spp")
            return jax.lax.all_gather(film, "y", axis=0, tiled=True)

        return jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),),
                                 out_specs=P(), check_vma=False))

    return _cached(cfg, make)(key)


def render_bidirectional_sharded_2d(key, scene, width: int, height: int,
                                    spp: int, mesh: Mesh, n_vlp: int = 512,
                                    quirks: Quirks = DEFAULT,
                                    use_grid: bool = False):
    """Bidirectional render sharded over image rows ('y') AND spp
    ('spp'), with the LIGHT pass sharded over the FLATTENED device set:
    every one of the ny*nspp devices emits the work-item window
    [lin/n, (lin+1)/n) of the lightTracer pass (lin = iy*nspp + isp),
    the VLP table is ``all_gather``-ed over both axes and reassembled to
    the reference layout, then each device renders its (row band, spp
    window) and the film is psum('spp') + row-gathered over 'y' - all
    collectives over the mesh, no replicated emission anywhere.  Bit-exact
    vs the single-device render up to psum summation order
    (tests/test_parallel.py)."""
    from ..models.bidirectional import film_bidirectional
    from ..ops import vlp as vlpmod
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    ny = mesh.shape["y"]
    nspp = mesh.shape["spp"]
    n = ny * nspp
    nlights = int(scn.lights.shape[0])
    if height % ny or spp % nspp:
        raise ValueError(f"height={height} % {ny} or spp={spp} % "
                         f"{nspp} != 0")
    shard_light = bool(nlights) and n_vlp % n == 0
    rows = height // ny
    local = spp // nspp
    cfg = ("bpt2d", scn.fingerprint(), width, height, spp, n_vlp, quirks,
           use_grid, shard_light, _mesh_key(mesh))

    def make():
        localv = n_vlp // n if shard_light else n_vlp

        def body(k):
            iy = jax.lax.axis_index("y")
            isp = jax.lax.axis_index("spp")
            if shard_light:
                lin = iy * jnp.uint32(nspp) + isp
                part = vlpmod.emit_vlps(
                    k, scn, n_vlp, quirks,
                    gi0=lin * jnp.uint32(localv), count=localv)
                g = jax.lax.all_gather(part, ("y", "spp"))
                vlps = (g.reshape(n, nlights, localv, 4)
                        .transpose(1, 0, 2, 3)
                        .reshape(nlights * n_vlp, 4))
            else:
                vlps = vlpmod.emit_vlps(k, scn, n_vlp, quirks)
            film = film_bidirectional(
                k, scn, width, height, local, isp * jnp.uint32(local),
                spp, n_vlp, quirks, use_grid=use_grid,
                precomputed_vlps=vlps,
                row_offset=iy * jnp.uint32(rows), rows=rows)
            film = jax.lax.psum(film, "spp")
            return jax.lax.all_gather(film, "y", axis=0, tiled=True)

        return jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),),
                                 out_specs=P(), check_vma=False))

    return _cached(cfg, make)(key)


def render_metropolis_sharded_2d(key, scene, width: int, height: int,
                                 spp: int, mesh: Mesh,
                                 n_seedpaths: int = 512,
                                 mutation_rounds: int = 8,
                                 quirks: Quirks = DEFAULT,
                                 use_grid: bool = False,
                                 grid_modifier: float = 3.0):
    """Metropolis render sharded over rows x spp with the chain pipeline
    sharded over the flattened device set (chain window lin/n per
    device, all_gather + reference light-major slot-minor reassembly) -
    the 2-D analogue of render_metropolis_sharded's sharded light
    pass."""
    from ..models.metropolis import film_metropolis, mlt_vlps
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    ny = mesh.shape["y"]
    nspp = mesh.shape["spp"]
    n = ny * nspp
    nlights = int(scn.lights.shape[0])
    if height % ny or spp % nspp:
        raise ValueError(f"height={height} % {ny} or spp={spp} % "
                         f"{nspp} != 0")
    shard_light = bool(nlights) and n_seedpaths % n == 0
    rows = height // ny
    local = spp // nspp
    cfg = ("mlt2d", scn.fingerprint(), width, height, spp, n_seedpaths,
           mutation_rounds, quirks, use_grid, grid_modifier, shard_light,
           _mesh_key(mesh))

    def make():
        localc = n_seedpaths // n if shard_light else n_seedpaths

        def body(k):
            iy = jax.lax.axis_index("y")
            isp = jax.lax.axis_index("spp")
            if shard_light:
                lin = iy * jnp.uint32(nspp) + isp
                part = mlt_vlps(k, scn, n_seedpaths, mutation_rounds,
                                quirks, chain0=lin * jnp.uint32(localc),
                                chains=localc)
                g = jax.lax.all_gather(part, ("y", "spp"))
                vlps = (g.reshape(n, nlights, 4, localc, 4)
                        .transpose(1, 2, 0, 3, 4)
                        .reshape(nlights * 4 * n_seedpaths, 4))
            else:
                vlps = mlt_vlps(k, scn, n_seedpaths, mutation_rounds,
                                quirks)
            film = film_metropolis(
                k, scn, width, height, local, isp * jnp.uint32(local),
                spp, n_seedpaths, mutation_rounds, quirks,
                use_grid=use_grid, grid_modifier=grid_modifier,
                precomputed_vlps=vlps,
                row_offset=iy * jnp.uint32(rows), rows=rows)
            film = jax.lax.psum(film, "spp")
            return jax.lax.all_gather(film, "y", axis=0, tiled=True)

        return jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),),
                                 out_specs=P(), check_vma=False))

    return _cached(cfg, make)(key)

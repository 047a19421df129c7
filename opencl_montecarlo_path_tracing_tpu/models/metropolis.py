"""Metropolis light transport - CLSuperMetropolisPathTracer (+_vlpgrid).

Reference pipeline (SURVEY.md section 3.5): (a) ``lightTracer`` builds one
random 4-vertex seed ``Path`` per (work item, light); (b)
``MetropolisLightTracer`` runs ``mutation_rounds`` of ``Mutate`` - vertex
perturbations (Szirmay-Kalos s1=1/512, s2=1/16, metropolispathtracer.ocl:
184-222) re-validated by a re-trace, plus probabilistic vertex add/drop -
then emits <= 4 VLPs per path with intensity halved per depth
(light_intensity / (1 << i), ocl:524); (c) ``pathTracer`` gathers the VLPs
like the bidirectional tracer.  The _vlpgrid variant additionally reduces
the VLP bounding box, builds a uniform grid over the VLPs and gathers only
the shading point's cell.

Deliberate repairs of reference defects (all cited in SURVEY.md section 2
#11/#12), following the default intended-math policy:
 * the reference hands ``lightTracer``'s output buffer to the wrong kernel
   argument, so ``MetropolisLightTracer`` reads an uninitialised seed-path
   buffer (.c:439-441); here the seed pass output feeds the mutation pass.
 * MWC64X state is passed BY VALUE through GetRandomDirection / Mutate /
   Perturbation (ocl:146,157,171,184), so every nested draw replays the
   same substream (all mutation rounds see identical randomness).  Counter-
   based threefry gives every (chain, round, site) an independent draw.
 * ``VerifyIntersection`` compares the re-traced hit with EXACT float
   equality (ocl:234), which never holds for a perturbed vertex - mutations
   are always rejected in the reference.  The rebuild accepts within
   ``verify_eps`` (default 1e-3); pass ``verify_eps=0.0`` to reproduce the
   reference's always-reject behaviour.
 * the host pipeline's blocking bounding-box read (.c:609) is replaced by a
   device-resident reduction (ops/vlp.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core import rng as rngmod
from ..core.quirks import Quirks, DEFAULT
from ..ops.intersect import SceneArrays, prep_scene, trace_ray
from ..ops import vlp as vlpmod
from ..scene.scene import Scene
from . import common as C
from .super import sample_super
from .bidirectional import illum_vlp

# RNG site space: chains use ray_id = chain index and sites >= 256
_SITE_SEED = 192          # + vertex slot (seed-path directions)
_SITE_MLT = 256           # + round * 16 + purpose
_P_DECIDE = 0             # mutate/extend decision draws
_P_PERTURB = 2            # + vertex slot (3 uniforms each)
_P_ADD = 6                # + addition slot (direction draws)
_P_REBUILD = 10           # + vertex slot (rebuild directions)

_S1 = np.float32(1.0 / 512.0)   # perturbation scales (ocl:188-190)
_S2 = np.float32(1.0 / 16.0)


def _slot_set(v, slot, new, mask):
    """v: (B, 4, 3); write ``new`` (B, 3) at per-chain ``slot`` where mask."""
    one_hot = (jnp.arange(4)[None, :] == slot[:, None]) & mask[:, None]
    return jnp.where(one_hot[..., None], new[:, None, :], v)


def _slot_get(v, slot):
    """v: (B, 4, 3) -> (B, 3) at per-chain slot (clamped)."""
    s = jnp.clip(slot, 0, 3).astype(jnp.int32)
    idx = jnp.broadcast_to(s[:, None, None], (v.shape[0], 1, 3))
    return jnp.take_along_axis(v, idx, axis=1)[:, 0, :]


def _add_vertex(key, scn, quirks, origin, site, attempt, chain=None):
    """AddRandomVertex (ocl:157-168) batched: random direction, one trace;
    returns (hit_mask, hit_point).  ``chain``/``site`` may be per-row
    arrays - the light-batched path packs all lights into one trace but
    keeps every (chain, site) draw identical to the per-light version."""
    if chain is None:
        chain = jnp.arange(origin.shape[0], dtype=jnp.uint32)
    u1, u2 = rngmod.rand2(key, chain, site)
    d = vlpmod.uniform_sphere(u1, u2)
    tr = trace_ray(origin, d, scn, quirks=quirks, sphere_material=3)
    hit = attempt & (tr.material != 0)
    x = origin + d * tr.t[..., None]
    return hit, x


def _random_path(key, scn, quirks, origin, site_base, build, chain=None):
    """GetRandomPath (ocl:171-181) batched: up to 4 chained random vertices."""
    B = origin.shape[0]
    v = jnp.zeros((B, 4, 3), jnp.float32)
    length = jnp.zeros(B, jnp.int32)
    cur = origin
    building = build
    for i in range(4):
        hit, x = _add_vertex(key, scn, quirks, cur, site_base + np.uint32(i),
                             building, chain)
        v = v.at[:, i, :].set(jnp.where(hit[:, None], x, v[:, i, :]))
        length = length + hit.astype(jnp.int32)
        cur = jnp.where(hit[:, None], x, cur)
        building = building & hit
    return v, length


def _perturbation(key, chain, vertex, site):
    """Szirmay-Kalos-style perturbation (ocl:184-222)."""
    u1, u2, u3 = rngmod.randn_draws(key, chain, site, 3)
    r = jnp.stack([u1, u2, u3], axis=-1)
    ratio = _S1 / _S2
    dx = _S1 / (ratio + jnp.abs(2.0 * r - 1.0)) - _S1 / (ratio + 1.0)
    plus = jnp.where(vertex < 1.0, vertex + dx, vertex + dx - 1.0)
    minus = jnp.where(vertex < 0.0, vertex - dx + 1.0, vertex - dx)
    return jnp.where(r < 0.5, plus, minus)


def _verify(scn, quirks, origin, dest, eps):
    """VerifyIntersection (ocl:225-236): re-trace toward ``dest`` and check
    the first hit is ``dest`` (within eps; eps=0 reproduces the reference's
    exact-equality rejection)."""
    d = C.normalize(dest - origin)
    tr = trace_ray(origin, d, scn, quirks=quirks, sphere_material=3)
    x = origin + d * tr.t[..., None]
    if eps == 0.0:
        close = jnp.all(x == dest, axis=-1)
    else:
        close = jnp.sum((x - dest) ** 2, axis=-1) < np.float32(eps * eps)
    return (tr.material != 0) & close


def _mutate(key, scn, quirks, verify_eps, light_origin, v, length, rnd,
            chain=None):
    """One Mutate round (ocl:239-283), batched over all chains.  ``rnd``
    may be a per-chain array (light-batched path: rnd = r + l*rounds)."""
    B = v.shape[0]
    if chain is None:
        chain = jnp.arange(B, dtype=jnp.uint32)
    base = _SITE_MLT + rnd * np.uint32(16)

    # empty paths: try to build a fresh one (ocl:242-245)
    empty = length == 0
    nv, nl = _random_path(key, scn, quirks, light_origin,
                          base + np.uint32(_P_REBUILD), empty, chain)
    v = jnp.where(empty[:, None, None], nv, v)
    length = jnp.where(empty, nl, length)
    active = length > 0

    r1, r2 = rngmod.rand2(key, chain, base + np.uint32(_P_DECIDE))
    mut_prob = 1.0 / (length.astype(jnp.float32) + 0.2)
    do_mutate = active & (mut_prob >= r1)   # ocl:247-248 returns if prob < r

    # perturb + verify each vertex in chain order (ocl:250-258)
    temp_v = v
    temp_len = jnp.zeros(B, jnp.int32)
    cur = light_origin
    ok_chain = do_mutate
    for i in range(4):
        pv = _perturbation(key, chain, v[:, i, :],
                           base + np.uint32(_P_PERTURB + i))
        in_range = i < length
        ver = _verify(scn, quirks, cur, pv, verify_eps)
        accept = ok_chain & in_range & ver
        temp_v = temp_v.at[:, i, :].set(jnp.where(accept[:, None], pv,
                                                  temp_v[:, i, :]))
        temp_len = temp_len + accept.astype(jnp.int32)
        cur = jnp.where(accept[:, None], pv, cur)
        ok_chain = ok_chain & (accept | ~in_range)

    replace = do_mutate & (temp_len == length)   # ocl:259-261
    v = jnp.where(replace[:, None, None], temp_v, v)

    # probabilistic vertex additions (ocl:262-282); the branch is chosen by
    # the length at entry, additions chain and stop at the first failure.
    # NOTE: the reference returns early when the mutation draw is skipped
    # (ocl:248), so additions only run on mutating rounds - gate on
    # do_mutate, not just active.
    entry_len = length
    t0 = ((entry_len == 1) & (r2 > 0.3)) | ((entry_len == 2) & (r2 < 0.3)) \
        | ((entry_len == 3) & (r2 < 0.2))
    t1 = ((entry_len == 1) & (r2 > 0.7)) | ((entry_len == 2) & (r2 < 0.2))
    t2 = (entry_len == 1) & (r2 > 0.9)
    ok = do_mutate
    for j, want in enumerate((t0, t1, t2)):
        attempt = ok & want & (length < 4)
        origin_j = _slot_get(v, length - 1)
        hit, x = _add_vertex(key, scn, quirks, origin_j,
                             base + np.uint32(_P_ADD + j), attempt, chain)
        v = _slot_set(v, length, x, hit)
        length = length + hit.astype(jnp.int32)
        ok = ok & (hit | ~attempt)
    return v, length


def mlt_vlps(key, scn: SceneArrays, n_seedpaths: int, mutation_rounds: int,
             quirks: Quirks = DEFAULT, verify_eps: float = 1e-3,
             chain0: int = 0, chains: int | None = None):
    """Seed + mutate + emit: (nlights * n_seedpaths * 4, 4) VLPs.

    total_paths scaling: base intensity / (total_paths / 256) with the
    reference's integer division (ocl:418), guarded to >= 1.

    All lights' chains run in ONE batch (the chain is the sequential
    bottleneck of the integrator - halving the trace count per round is
    ~free throughput).  Every threefry draw keys on the per-light chain
    index and site, so draws, VLP values and output ordering are
    bit-identical to the per-light loop - the CRN tests against
    oracle_mlt.py pin this.

    ``chain0``/``chains`` restrict to the chain window
    [chain0, chain0+chains) of each light (result
    (nlights * 4 * chains, 4), layout [light][slot][chain]): the sharded
    light pass runs a disjoint window per device and all-gathers.  Draws
    key on the GLOBAL chain index (and scale_den on the global
    n_seedpaths), so window rows are bit-identical to the same rows of
    the full run; ``chain0`` may be a traced scalar."""
    if int(scn.lights.shape[0]) == 0:
        return jnp.zeros((0, 4), jnp.float32)
    seed = mlt_seed(key, scn, n_seedpaths, quirks, chain0, chains)
    return mlt_mutate_emit(key, scn, n_seedpaths, mutation_rounds, quirks,
                           verify_eps, seed, chain0, chains)


def _chain_layout(scn, n_seedpaths, chain0, chains):
    nlights = int(scn.lights.shape[0])
    B = chains if chains is not None else n_seedpaths
    lp = jnp.repeat(jnp.asarray(scn.lights[:, :3], jnp.float32), B, axis=0)
    intensity = jnp.repeat(jnp.asarray(scn.lights[:, 3], jnp.float32), B)
    light_idx = jnp.repeat(jnp.arange(nlights, dtype=jnp.uint32), B)
    chain = jnp.tile(jnp.arange(B, dtype=jnp.uint32) + jnp.uint32(chain0),
                     nlights)
    return nlights, B, lp, intensity, light_idx, chain


def mlt_seed(key, scn: SceneArrays, n_seedpaths: int,
             quirks: Quirks = DEFAULT, chain0: int = 0,
             chains: int | None = None):
    """The seed-path stage alone (the reference's ``lightTracer`` kernel,
    vlpgrid .c:182-221 dispatch): returns the (v, length) chain state the
    Metropolis stage mutates.  Split out so the staged CLI can time the
    two light kernels separately, like the reference's per-event report."""
    nlights, B, lp, _, light_idx, chain = _chain_layout(
        scn, n_seedpaths, chain0, chains)
    build = jnp.ones(nlights * B, bool)
    return _random_path(key, scn, quirks, lp,
                        np.uint32(_SITE_SEED) + np.uint32(4) * light_idx,
                        build, chain)


def mlt_mutate_emit(key, scn: SceneArrays, n_seedpaths: int,
                    mutation_rounds: int, quirks: Quirks = DEFAULT,
                    verify_eps: float = 1e-3, seed_state=None,
                    chain0: int = 0, chains: int | None = None):
    """Mutation rounds + VLP emission (the reference's
    ``MetropolisLightTracer`` kernel, vlpgrid .c:223-264 dispatch) on the
    seed state from :func:`mlt_seed`."""
    nlights, B, lp, intensity, light_idx, chain = _chain_layout(
        scn, n_seedpaths, chain0, chains)
    total_paths = n_seedpaths * nlights
    scale_den = max(1, total_paths // 256)
    v, length = seed_state

    rounds = jnp.uint32(max(1, mutation_rounds))

    def round_body(r, carry):
        v, length = carry
        return _mutate(key, scn, quirks, verify_eps, lp, v, length,
                       jnp.uint32(r) + light_idx * rounds, chain)

    v, length = jax.lax.fori_loop(0, mutation_rounds, round_body,
                                  (v, length))

    # emit <= 4 VLPs per chain, intensity halved per depth (ocl:522-527)
    origin = lp
    alive = length > 0
    slots = []
    for i in range(4):
        d = C.normalize(v[:, i, :] - origin)
        vlp = vlpmod.vlp_from_light_sample(
            origin, d, intensity / np.float32(1 << i), scale_den, scn,
            quirks, base=vlpmod._MLT_BASE)
        emit = alive & (i < length) & (vlp[:, 3] > 0)
        vlp = jnp.where(emit[:, None], vlp, 0.0)
        slots.append(vlp)
        alive = emit   # reference breaks when curr_vlp.w == 0 (ocl:525)
        origin = jnp.where(emit[:, None], v[:, i, :], origin)
    # original (per-light) ordering: light-major, slot-minor
    out = [slots[i][l * B:(l + 1) * B]
           for l in range(nlights) for i in range(4)]
    return jnp.concatenate(out, axis=0)


def film_metropolis(key, scn: SceneArrays, width, height, spp, spp_offset,
                    spp_total, n_seedpaths, mutation_rounds, quirks,
                    max_bounces=C.MAX_BOUNCES, use_grid: bool = False,
                    grid_modifier: float = 3.0, verify_eps: float = 1e-3,
                    precomputed_vlps=None, precomputed_grid=None,
                    grid_res=None, row_offset=0, rows=None):
    vlps = (precomputed_vlps if precomputed_vlps is not None
            else mlt_vlps(key, scn, n_seedpaths, mutation_rounds, quirks,
                          verify_eps))
    grid = precomputed_grid
    if use_grid and grid is None:
        res = (grid_res if grid_res is not None else
               vlpmod.vlp_grid_static_res(int(vlps.shape[0]),
                                          grid_modifier))
        grid = vlpmod.build_vlp_grid(vlps, res)
    illum = functools.partial(illum_vlp, key, scn, quirks, vlps, grid, None)
    sample_fn = functools.partial(sample_super, key, scn, quirks, max_bounces,
                                  illum_fn=illum)
    return C.accumulate_spp(sample_fn, width, height, spp,
                            spp_offset=spp_offset, spp_total=spp_total,
                            row_offset=row_offset, rows=rows)


_COMPILED: dict = {}


def render_metropolis(key, scene: Scene | SceneArrays, width: int = 512,
                      height: int = 512, spp: int = 64,
                      n_seedpaths: int = 512, mutation_rounds: int = 8,
                      spp_offset: int = 0, spp_total: int | None = None,
                      quirks: Quirks = DEFAULT,
                      max_bounces: int = C.MAX_BOUNCES,
                      use_grid: bool = False, grid_modifier: float = 3.0,
                      verify_eps: float = 1e-3,
                      dynamic_grid_res: bool = False):
    """Render with Metropolis light transport; CLI mirrors the reference's
    [nseedpaths] [mutation_rounds] (+ [CELL_SIZE_MODIFIER] for the grid
    variant; .c:297-315, vlpgrid .c:429-451).

    ``dynamic_grid_res=True`` is the opt-in REFERENCE-PARITY grid mode:
    the VLP box is min/max-reduced on device and read back to the host
    (the reference's one mid-pipeline blocking sync, vlpgrid .c:609),
    and the grid resolution is derived from the box per .c:629-636
    (ops/vlp.py::vlp_grid_dynamic_res) so CELL_SIZE_MODIFIER shapes the
    partition exactly as the reference's does.  The default static mode
    keeps the whole pipeline device-resident under one jit."""
    scn = prep_scene(scene) if isinstance(scene, Scene) else scene
    if spp_total is None:
        spp_total = spp
    cfg = (scn.fingerprint(), width, height, spp, spp_offset, spp_total,
           n_seedpaths, mutation_rounds, quirks, max_bounces, use_grid,
           grid_modifier, verify_eps)
    if use_grid and dynamic_grid_res:
        ecfg = ("mlt-emit", scn.fingerprint(), n_seedpaths,
                mutation_rounds, quirks, verify_eps)
        emit = _COMPILED.get(ecfg)
        if emit is None:
            emit = jax.jit(lambda k: mlt_vlps(
                k, scn, n_seedpaths, mutation_rounds, quirks, verify_eps))
            _COMPILED[ecfg] = emit
        vlps = emit(key)
        bounds = _COMPILED.setdefault(
            "vlp-bounds", jax.jit(vlpmod.vlp_bounds))
        # THE host sync: the reference's blocking box read (.c:609)
        vmin, vmax = (np.asarray(b) for b in bounds(vlps))
        res = vlpmod.vlp_grid_dynamic_res(vmin, vmax, int(vlps.shape[0]),
                                          grid_modifier)
        rcfg = cfg + ("dynres", res)
        fn = _COMPILED.get(rcfg)
        if fn is None:
            fn = jax.jit(lambda k, v: film_metropolis(
                k, scn, width, height, spp, spp_offset, spp_total,
                n_seedpaths, mutation_rounds, quirks, max_bounces,
                use_grid, grid_modifier, verify_eps, precomputed_vlps=v,
                grid_res=res))
            _COMPILED[rcfg] = fn
        return fn(key, vlps)
    fn = _COMPILED.get(cfg)
    if fn is None:
        fn = jax.jit(lambda k: film_metropolis(
            k, scn, width, height, spp, spp_offset, spp_total, n_seedpaths,
            mutation_rounds, quirks, max_bounces, use_grid, grid_modifier,
            verify_eps))
        _COMPILED[cfg] = fn
    return fn(key)

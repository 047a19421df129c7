"""Golden-render validation against the reference's committed artifacts.

Runs on the default JAX device; writes VALIDATION.md at the repo root.

The reference commits three renders (SURVEY.md section 4): the CPU tracer's
resultCPU.ppm and the CLSuperPathTracer/_lmem result.ppm (512^2 RGBA PAM,
64 spp, libc-rand seeded).  Bitwise comparison is impossible (different RNG);
agreement is statistical: RMSE in 8-bit units at matched spp (dominated by
the two independent 64-spp Monte-Carlo noise realisations) and pixel
correlation.  Also reports "spp to fixed RMSE" against a high-spp converged
self-render (the quality metric: display-scale RMSE < 1e-3).
"""

import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opencl_montecarlo_path_tracing_tpu.core.rng import make_key
from opencl_montecarlo_path_tracing_tpu.core.quirks import (
    DEFAULT, REFERENCE, REFERENCE_LMEM)
from opencl_montecarlo_path_tracing_tpu.models.simple import render_simple
from opencl_montecarlo_path_tracing_tpu.models.super import render_super
from opencl_montecarlo_path_tracing_tpu.scene import load_scene
from opencl_montecarlo_path_tracing_tpu.utils import pam
from opencl_montecarlo_path_tracing_tpu.utils.metrics import (
    rmse_u8, correlation, spp_to_rmse,
)

REF = "/root/reference"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "VALIDATION.md")


def golden(path):
    img = pam.load_pam(path)
    return np.asarray(img.data)[..., :3].astype(np.float64)


def main():
    lines = ["# VALIDATION — golden-render comparison",
             "",
             "Generated by tools/validate_golden.py on "
             f"{jax.devices()[0].device_kind}.",
             ""]
    key = make_key(2026)

    # --- simple tracer vs SimpleCPUTracer golden -------------------------
    g = golden(os.path.join(REF, "SimpleCPUTracer", "resultCPU.ppm"))
    t0 = time.time()
    film = np.asarray(render_simple(key, 512, 512, spp=64))
    ours = pam.film_to_rgba8(film)[..., :3].astype(np.float64)
    r = rmse_u8(ours, g)
    c = correlation(ours, g)
    lines += [
        "## simple tracer vs committed SimpleCPUTracer/resultCPU.ppm",
        "",
        f"- 512x512, 64 spp (matched), {time.time()-t0:.1f}s",
        f"- RMSE (8-bit units): **{r:.2f}** "
        "(both images carry independent 64-spp MC noise)",
        f"- pixel correlation: **{c:.4f}**",
        f"- mean: ours {ours.mean():.2f} vs golden {g.mean():.2f}",
        "",
    ]

    # --- the two committed goldens vs each other --------------------------
    ga = golden(os.path.join(REF, "CLSuperPathTracer", "result.ppm"))
    gb = golden(os.path.join(REF, "CLSuperPathTracer_lmem", "result.ppm"))
    lines += [
        "## reference goldens vs each other (context)",
        "",
        f"- CLSuperPathTracer vs _lmem result.ppm: RMSE {rmse_u8(ga, gb):.2f}, "
        f"correlation {correlation(ga, gb):.4f}, means {ga.mean():.2f} vs "
        f"{gb.mean():.2f}",
        "- the reference's own two committed renders disagree substantially",
        "  (different code state or scene at commit time); agreement with the",
        "  _lmem golden is the meaningful comparison.",
        "",
    ]

    # --- super tracer vs CLSuperPathTracer goldens -----------------------
    scene = load_scene(os.path.join(REF, "CLSuperPathTracer"))
    for name, quirks in (("default (intended math)", DEFAULT),
                         ("quirks=reference", REFERENCE),
                         ("quirks=reference_lmem (+shadow carry-t)",
                          REFERENCE_LMEM)):
        for gold_name in ("CLSuperPathTracer", "CLSuperPathTracer_lmem"):
            gp = os.path.join(REF, gold_name, "result.ppm")
            if not os.path.exists(gp):
                continue
            g = golden(gp)
            film = np.asarray(render_super(key, scene, 512, 512, spp=64,
                                           quirks=quirks))
            ours = pam.film_to_rgba8(film, wrap=quirks.wrap_uint8)[..., :3]
            ours = ours.astype(np.float64)
            r = rmse_u8(ours, g)
            c = correlation(ours, g)
            lines += [
                f"## super tracer ({name}) vs {gold_name}/result.ppm",
                "",
                f"- RMSE (8-bit units): **{r:.2f}**, correlation: **{c:.4f}**",
                f"- mean: ours {ours.mean():.2f} vs golden {g.mean():.2f}",
                "",
            ]

    # --- noise floor: ours vs ours at a different seed --------------------
    # if two independent 64-spp renders of OUR estimator differ from each
    # other about as much as ours differs from the golden, the residual is
    # Monte-Carlo noise, not estimator disagreement.
    film_a = np.asarray(render_super(make_key(2026), scene, 512, 512, spp=64))
    film_b = np.asarray(render_super(make_key(777), scene, 512, 512, spp=64))
    a8 = pam.film_to_rgba8(film_a)[..., :3].astype(np.float64)
    b8 = pam.film_to_rgba8(film_b)[..., :3].astype(np.float64)
    g = golden(os.path.join(REF, "CLSuperPathTracer_lmem", "result.ppm"))
    lines += [
        "## noise floor (two independent 64-spp renders of THIS estimator)",
        "",
        f"- ours(seed A) vs ours(seed B): RMSE {rmse_u8(a8, b8):.2f}, "
        f"correlation {correlation(a8, b8):.4f}",
        f"- ours(seed A) vs _lmem golden: RMSE {rmse_u8(a8, g):.2f}, "
        f"correlation {correlation(a8, g):.4f}",
        "- our estimator is low-variance at 64 spp (the super scene has no",
        "  mirror bounces, so per-pixel randomness is only the lens/shadow",
        "  jitter).  The residual against the golden therefore reflects",
        "  reference-side differences (its id-hash-seeded RNG and build",
        "  drift): note the reference's own two goldens disagree with each",
        "  other by MORE (RMSE ~46) than we disagree with the better one",
        "  (~21).",
        "",
    ]

    # --- estimator bias via common random numbers -------------------------
    # the oracles consume the SAME threefry streams as the JAX integrators
    # (oracle key= mode), so the difference below contains NO Monte-Carlo
    # noise - it is pure estimator bias + float rounding.  This is the
    # "RMSE < 1e-3" criterion, demonstrated rather than argued.
    from opencl_montecarlo_path_tracing_tpu.models.oracle_super import (
        render_oracle_super)
    from opencl_montecarlo_path_tracing_tpu.models.oracle import render_oracle
    from opencl_montecarlo_path_tracing_tpu.models.oracle_bpt import (
        render_oracle_bpt)
    from opencl_montecarlo_path_tracing_tpu.models.bidirectional import (
        render_bidirectional)

    def crn_stats(jx, orc, spp):
        d = (np.asarray(jx, np.float64) - orc) / spp * 64.0 / 255.0
        dm = np.abs(d).max(axis=-1)
        return (float(np.sqrt((d ** 2).mean())),
                float(np.quantile(dm, 0.98)), float(dm.max()))

    # content bands: the camera frame is fixed for 512x512, so a window at
    # the origin is ALL SKY and a comparison there pins only the camera
    # (round-2 finding).  Rows 372+ hold floor + diffuse geometry for the
    # full scene; rows 192+ hold the simple scene's sphere field.
    ck = make_key(4242)
    spp = 16
    r0, band = 372, 16
    rows = []
    jx = np.asarray(render_super(ck, scene, 296, r0 + band, spp=spp))[r0:]
    r_, q_, m_ = crn_stats(jx, render_oracle_super(
        scene, 296, band, spp=spp, key=ck, row_offset=r0), spp)
    rows.append(("super 296x16 band@372, 16spp", r_, q_, m_))
    jx = np.asarray(render_super(ck, scene, 296, r0 + band, spp=spp,
                                 quirks=REFERENCE))[r0:]
    r_, q_, m_ = crn_stats(jx, render_oracle_super(
        scene, 296, band, spp=spp, key=ck, quirks=REFERENCE,
        row_offset=r0), spp)
    rows.append(("super (quirks=reference)", r_, q_, m_))
    jx = np.asarray(render_simple(ck, 128, 192 + band, spp=spp,
                                  max_bounces=5))[192:]
    r_, q_, m_ = crn_stats(jx, render_oracle(
        128, band, spp=spp, key=ck, max_depth=5, row_offset=192), spp)
    rows.append(("simple 128x16 band@192 (sphere field)", r_, q_, m_))
    jx = np.asarray(render_bidirectional(ck, scene, 296, r0 + band,
                                         spp=spp, n_vlp=128))[r0:]
    r_, q_, m_ = crn_stats(jx, render_oracle_bpt(
        scene, 296, band, spp=spp, n_vlp=128, key=ck, row_offset=r0), spp)
    rows.append(("bidirectional nvlp=128", r_, q_, m_))
    lines += [
        "## estimator bias, common random numbers (JAX vs NumPy oracle)",
        "",
        "Oracle and JAX renders consume IDENTICAL threefry sample streams",
        "over CONTENT bands (floor/diffuse geometry at rows 372+, the",
        "simple sphere field at rows 192+ - a window at the origin is all",
        "sky and would pin only the camera); the residual is estimator",
        "bias + float rounding (display scale; target < 1e-3):",
        "",
        "| config | RMSE | p98 | max |",
        "|---|---|---|---|",
    ]
    lines += [f"| {name} | {r_:.3e} | {q_:.3e} | {m_:.3e} |"
              for name, r_, q_, m_ in rows]
    lines += [
        "",
        "(tests/test_crn.py asserts the tie-excluded quantile under 1e-5",
        "with a 2-5% tie budget per scene - the silhouette-dense simple",
        "field uses 5%, so its p98 here sits at the contract edge.  The",
        "max column is the razor-edge-tie tail: a silhouette",
        "discriminant within an ulp flips between fused and plain f32 and",
        "that sample's whole path diverges; the same class separates",
        "XLA on the CPU from the GPU.)",
        "",
        "Note on the `_lmem` shadow carry-t quirk: the rebuild reproduces",
        "the kernel's `&t` aliasing exactly (core/quirks.py cites",
        "CLSuperPathTracer_lmem/pathtracer.ocl:178, behaviour pinned by",
        "tests/test_quirks.py::test_shadow_carry_t_quirk), but agreement",
        "with the committed _lmem golden does not improve - consistent with",
        "the goldens predating the committed kernel code (the reference's",
        "own two goldens disagree with each other by RMSE ~46).",
        "",
    ]

    # --- spp to fixed RMSE (self-converged reference) --------------------
    # display space: the canonical 64-spp-exposure image on a [0, 1] scale
    # ((film/spp * 3.5 * 64 + 13) / 255); the "RMSE < 1e-3" criterion is
    # applied on that scale.
    def display(film, spp):
        return (np.asarray(film) / spp * 64.0 + 13.0) / 255.0

    ref_img = display(render_super(make_key(999), scene, 256, 256, spp=8192),
                      8192)

    def at_spp(spp):
        return display(render_super(make_key(555), scene, 256, 256, spp=spp),
                       spp)

    spp_needed, hist = spp_to_rmse(
        at_spp, ref_img, 1e-3,
        spp_schedule=(64, 256, 1024, 4096, 16384))
    lines += [
        "## spp to fixed RMSE (display scale, vs self-converged 8192 spp)",
        "",
        f"- target display-space RMSE 1e-3 reached at spp = **{spp_needed}**",
        "- history: " + ", ".join(f"{s}spp:{r:.5f}" for s, r in hist),
        "- (Monte-Carlo noise scales as 1/sqrt(spp); the 1e-3 target on the",
        "  display scale is what the per-pixel estimator converges toward -",
        "  no unbiased renderer of this scene, the reference included,",
        "  reaches it at low spp.)",
        "",
    ]

    with open(OUT, "w") as fp:
        fp.write("\n".join(lines))
    print("\n".join(lines))


if __name__ == "__main__":
    main()

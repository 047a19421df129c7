"""Monte-Carlo path-tracing framework in JAX, run on NVIDIA GPUs.

A ground-up JAX/XLA/Pallas rebuild of the capability set of the reference
OpenCL thesis renderer family (JustAToaster/OpenCL_MonteCarlo_Path_Tracing):
one wavefront SoA renderer with pluggable integrators replaces the eight
per-variant megakernels.

Layout
------
core/      counter-based threefry RNG streams, camera (+thin-lens DoF),
           fidelity ("quirks") policy
scene/     reference text scene formats (spheres/squares/triangles/lights),
           bitmap -> SoA expansion, AABBs
ops/       batched primitive intersection, uniform-grid build (sort-based,
           no atomics) + DDA traversal, VLP gather ops, the fused super
           sample kernel (Pallas, compiled through Triton)
models/    the integrator family: oracle (CPU recursive reference),
           simple, super (+lmem semantics), sample-parallel (NoDoF),
           trianglegrid, bidirectional (VPL), metropolis (+VLP grid)
parallel/  device mesh setup, spp sharding via shard_map, film psum
utils/     PAM (P7) image IO byte-compatible with the reference's
           pamalign.h, per-stage profiling reports, CLI parity
"""

__version__ = "0.1.0"

from .api import render, VARIANTS  # noqa: E402,F401

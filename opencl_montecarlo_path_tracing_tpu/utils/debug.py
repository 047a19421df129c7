"""In-kernel debug visibility - the reference's disabled device printfs.

The reference ships commented-out in-kernel printfs (DDA traversal state,
CLSuperPathTracer_trianglegrid/pathtracer.ocl:192) and a disabled grid
dump kernel (printTrianglesGrid, ocl:332-346, neutered by an early return
at :333).  The analog here is ``jax.debug.print`` behind an env flag: set
``PT_KERNEL_DEBUG=1`` to stream aggregate per-call statistics from inside
jitted programs.  Aggregates, not per-lane dumps - a wavefront batch has
10^5-10^6 lanes where the reference had one work item under the
debugger's eye; the host-side analog of the full grid dump is
``ops/grid.py::grid_stats``.

The flag is read at TRACE time: when it is unset the hooks contribute
nothing to the compiled program.
"""

from __future__ import annotations

import os

import jax


def enabled() -> bool:
    return os.environ.get("PT_KERNEL_DEBUG", "") == "1"


def dprint(fmt: str, *args, **kw) -> None:
    """``jax.debug.print(fmt, ...)`` when PT_KERNEL_DEBUG=1, else a no-op
    resolved at trace time (zero cost in the compiled program)."""
    if enabled():
        jax.debug.print(fmt, *args, **kw)

"""Per-stage profiling reports in the reference's format.

The reference enables CL_QUEUE_PROFILING_ENABLE on every queue
(ocl_boiler.h:154-155) and prints per-stage lines like

    rendering : 262144 pixels in 12.3ms: 0.085 GB/s

(CLSuperPathTracer.c:321-325; 7-stage variant
CLSuperMetropolisPathTracer_vlpgrid/...c:673-705).  The equivalent here is
wall-clock around ``jax.block_until_ready`` per stage; ``StageTimer`` keeps
the reporting format (ms + derived GB/s = data_size / 1e6 / ms).
"""

from __future__ import annotations

import time
import dataclasses

import jax


@dataclasses.dataclass
class Stage:
    name: str
    items: int
    item_label: str
    data_size: int  # bytes moved, for the GB/s figure
    ms: float

    @property
    def gbs(self) -> float:
        return self.data_size / 1.0e6 / self.ms if self.ms > 0 else float("inf")


class StageTimer:
    def __init__(self):
        self.stages: list[Stage] = []

    def run(self, name: str, fn, *, items: int, item_label: str,
            data_size: int):
        """Execute ``fn()`` (returning jax arrays or pytrees), block until
        device completion, and record the stage."""
        t0 = time.perf_counter()
        out = fn()
        out = jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) * 1e3
        self.stages.append(Stage(name, items, item_label, data_size, ms))
        return out

    def record(self, name: str, ms: float, *, items: int, item_label: str,
               data_size: int):
        self.stages.append(Stage(name, items, item_label, data_size, ms))

    def trace(self, log_dir: str):
        """Capture a device profile (TensorBoard/XProf format) around a
        block - the deep-profiling analog of the reference's
        CL_QUEUE_PROFILING_ENABLE event timing.  Usage:

            with timer.trace("/tmp/pt_trace"):
                film = render(...); jax.block_until_ready(film)
        """
        return jax.profiler.trace(log_dir)

    def report(self) -> str:
        lines = []
        total = 0.0
        for s in self.stages:
            lines.append(f"{s.name} : {s.items} {s.item_label} in {s.ms:g}ms: "
                         f"{s.gbs:g} GB/s")
            total += s.ms
        lines.append("")
        lines.append(f"Total time: {total:g} ms.")
        return "\n".join(lines)

    def print_report(self):
        print(self.report())

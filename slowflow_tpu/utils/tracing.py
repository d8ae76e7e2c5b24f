"""Stage timing and profiling.

The reference instruments wall-clock time around preprocessing / epic /
minimization and flushes per-phase accumulators to `results.info` /
`result.info` (slow_flow.cpp:729-937, dense_tracking.cpp:1951-1964). This
module provides the same lightweight discipline plus optional JAX device
profiling (trace viewer) for the device compute path.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    >>> t = StageTimer()
    >>> with t.stage("epic"): ...
    >>> t.write_info(path, header="SlowFlow variational estimation")
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.rows = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def add_row(self, key, value):
        self.rows.append((key, value))

    def summary(self) -> str:
        lines = []
        for name, total in self.totals.items():
            lines.append(f"{name} took {total:.2f}s"
                         f" ({self.counts[name]} calls).")
        return "\n".join(lines)

    def write_info(self, path: str, header: str = "") -> None:
        with open(path, "w") as fh:
            if header:
                fh.write(f"# {header}\n\n")
            fh.write(self.summary() + "\n\n")
            for key, value in self.rows:
                fh.write(f"{key}\t{value}\n")


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Capture a JAX profiler trace (TensorBoard trace-viewer format) around
    the block when `log_dir` is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    import jax

    os.makedirs(log_dir, exist_ok=True)
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()

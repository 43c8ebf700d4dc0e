"""Per-stage wall-time instrumentation.

The reference only logs end-to-end times (reference:src/sketch.rs:60-65,
reference:src/dist.rs:57-62); this adds named stage spans and optional
jax.profiler trace capture for device performance work.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class StageTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name}: {self.totals[name]:.3f}s over {self.counts[name]} calls"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def maybe_profile(trace_dir: str = ""):
    """Capture a jax.profiler trace when trace_dir is set."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield

"""Frame timing instrumentation.

Capability match of the reference's observability (``src/context.rs``):
``Stopwatch`` (``:536-556``) for per-frame dt, ``FpsCounter``
(``:559-588``, 0.25 s refresh window) for the GUI fps readout, plus a
``StageTimer`` for per-stage device timings the reference never had
(it has no GPU timestamps — SURVEY §5).  A device stage is closed by
a ``sync`` callable that waits for its result (``jax.block_until_ready``).
"""

from __future__ import annotations

import collections
import time
from typing import Dict



class Stopwatch:
    def __init__(self):
        self._prev = time.perf_counter()

    def tick(self) -> float:
        """Seconds since the previous tick."""
        now = time.perf_counter()
        dt = now - self._prev
        self._prev = now
        return dt


class FpsCounter:
    """Sliding frame counter refreshed every ``window`` seconds."""

    def __init__(self, window: float = 0.25):
        self.window = window
        self.fps = 0.0
        self._frames = 0
        self._t0 = time.perf_counter()

    def tick(self) -> float:
        self._frames += 1
        now = time.perf_counter()
        elapsed = now - self._t0
        if elapsed >= self.window:
            self.fps = self._frames / elapsed
            self._frames = 0
            self._t0 = now
        return self.fps


class StageTimer:
    """Accumulates wall time per named stage; device stages are closed
    by forcing a sync on the stage's result."""

    def __init__(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)

    def measure(self, name: str, fn, *args, sync=None, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync is not None:
            sync(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def report(self) -> Dict[str, float]:
        return {
            name: self.totals[name] / max(1, self.counts[name])
            for name in self.totals
        }

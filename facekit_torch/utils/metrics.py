"""Serving metrics: latency percentiles and counters per named stage.

The port's own copy of ``facekit.utils.metrics``.

The reference has no metrics at all (SURVEY.md §5.1/§5.5 — logging only).
facekit tracks per-endpoint latency percentiles and faces/sec, surfaced via
the server's /metrics endpoint.
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager
from typing import Dict


class LatencyTracker:
    """Ring-buffer latency percentiles + counters per named stage."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._samples: Dict[str, collections.deque] = {}
        self._counts: Dict[str, int] = collections.defaultdict(int)
        self._window = window

    def observe(self, name: str, seconds: float, count: int = 1) -> None:
        with self._lock:
            dq = self._samples.setdefault(
                name, collections.deque(maxlen=self._window))
            dq.append(seconds)
            self._counts[name] += count

    @contextmanager
    def time(self, name: str, count: int = 1):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0, count)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out = {}
        with self._lock:
            for name, dq in self._samples.items():
                xs = sorted(dq)
                n = len(xs)
                if not n:
                    continue
                out[name] = {
                    "count": self._counts[name],
                    "p50_ms": xs[n // 2] * 1e3,
                    "p90_ms": xs[min(n - 1, int(n * 0.9))] * 1e3,
                    "p99_ms": xs[min(n - 1, int(n * 0.99))] * 1e3,
                    "mean_ms": sum(xs) / n * 1e3,
                }
        return out


class StageTimer:
    """Lightweight named-stage wall timer for pipeline introspection."""

    def __init__(self, tracker: LatencyTracker, prefix: str = ""):
        self.tracker = tracker
        self.prefix = prefix

    @contextmanager
    def stage(self, name: str):
        with self.tracker.time(self.prefix + name):
            yield

"""Scoped wall-clock timers with rolling percentile summaries (thread-safe).

Each engine owns one `Timers`; its summary is part of `TTSEngine.get_stats()`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator

import numpy as np


class Timers:
    def __init__(self, window: int = 512):
        self._samples: Dict[str, deque] = defaultdict(lambda: deque(maxlen=window))
        self._counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def track(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self._samples[name].append(seconds)
            self._counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        out = {}
        with self._lock:
            for name, samples in self._samples.items():
                if not samples:
                    continue
                arr = np.asarray(samples)
                out[name] = {
                    "count": self._counts[name],
                    "p50_ms": round(float(np.percentile(arr, 50)) * 1000, 3),
                    "p90_ms": round(float(np.percentile(arr, 90)) * 1000, 3),
                    "p99_ms": round(float(np.percentile(arr, 99)) * 1000, 3),
                    "mean_ms": round(float(arr.mean()) * 1000, 3),
                }
        return out

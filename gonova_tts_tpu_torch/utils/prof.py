"""Profiling: scoped wall-clock timers and an optional device trace.

Each engine owns one `Timers` (rolling percentile summaries, thread-safe); its
summary is part of `TTSEngine.get_stats()`. `device_trace` is the counterpart of
the JAX package's `jax.profiler` hook: a `torch.profiler` trace of a block, written
as a Chrome trace for a timeline viewer; `device_events` reads a trace's device side.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional

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


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the block with `torch.profiler` into `log_dir` (a no-op when None):
    host activity, and the card's kernels where a card is present. Writes
    `trace_<pid>_<n>.json` (Chrome format)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


def device_events(prof) -> List:
    """A torch.profiler trace's device events (kernels and copies), largest device
    time first. A user-annotated range (an optimizer's step) also shows as a device
    event spanning its kernels: it is left out, or its kernels would count twice."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.self_device_time_total, reverse=True)

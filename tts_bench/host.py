"""Host readings of every run, printed on the info line (never in `metrics`): how
fast the host ran the window, so that a run that reads far from the rest can be
told apart by its cause.

  * `probe_ms`: a fixed piece of pure Python timed after set-up and after the
    window: the host's speed for one thread, in this run;
  * `passes`, `pass_s`: the engine's passes in the window and their summed wall
    time (the time the engine thread held a pass);
  * `gc_s`, `gc_gen2`: the collector's time in the window and its full passes;
  * `cpu_s`, `invol_switches`: the process's CPU time in the window and the times
    it was taken off a core against its will;
  * `audio_per_5s`: the window's audio seconds in bins of five seconds.
"""

from __future__ import annotations

import gc
import resource
import time
from typing import List


def probe_ms(n: int = 300_000) -> float:
    """The best of three runs of a fixed loop of dict and string work, in ms."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        d = {}
        for i in range(n):
            d[i & 1023] = str(i)
        best = min(best, time.perf_counter() - t)
    return 1e3 * best


class Host:
    def __init__(self, svc):
        self.passes: List[tuple] = []  # (start, end) of each engine pass
        self.gcs: List[tuple] = []  # (start, end, generation)
        self._gc_t = 0.0
        eng = svc.synthesizer.engine
        orig = eng.synthesize_batch

        def timed(*a, **k):
            t = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                self.passes.append((t, time.perf_counter()))

        eng.synthesize_batch = timed
        gc.callbacks.append(self._on_gc)
        self.probe0 = probe_ms()
        self.probe1 = 0.0
        self.ru0 = self.ru1 = None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        else:
            self.gcs.append((self._gc_t, time.perf_counter(), info["generation"]))

    def mark(self, start: bool) -> None:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        if start:
            self.ru0 = ru
        else:
            self.ru1 = ru

    def close(self) -> None:
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        self.probe1 = probe_ms()

    def readings(self, window) -> dict:
        w0, w1 = window.start, window.end
        inside = [(a, b) for a, b in self.passes if w0 <= a and b < w1]
        g = [(a, b, n) for a, b, n in self.gcs if w0 <= a < w1]
        bins = [0.0] * max(1, int((w1 - w0 + 4.999) // 5))
        for r in window.results:
            if r.failed:
                continue
            for p, t in zip(r.parts, r.part_done):
                if w0 <= t < w1:
                    bins[int((t - w0) // 5)] += len(p) / r.sample_rate
        out = {"probe_ms": [self.probe0, self.probe1], "passes": len(inside),
               "pass_s": sum(b - a for a, b in inside), "gc_s": sum(b - a for a, b, _ in g),
               "gc_gen2": sum(n == 2 for _, _, n in g), "audio_per_5s": bins}
        if self.ru0 is not None and self.ru1 is not None:
            out["cpu_s"] = (self.ru1.ru_utime + self.ru1.ru_stime) - (self.ru0.ru_utime + self.ru0.ru_stime)
            out["invol_switches"] = self.ru1.ru_nivcsw - self.ru0.ru_nivcsw
        return out

"""The port's span and counter recorder: one `Tracer` per engine, shared by the
service, the batcher and the engine.

A span records its name, start and end (`time.perf_counter_ns()`), the thread it
ran on, its id, its parent's id, the request it serves and a few integer
attributes.

  * Histograms, always: each recorded span feeds a per-name histogram over fixed
    log-spaced bounds (`BOUNDS_S`), counted over every sample since start.
    `summary()` (`TTSEngine.get_stats()["timers"]`) and `prometheus()` read them.
  * The switch (`monitoring.trace_spans`, `Tracer.on`): on, spans also go to a
    bounded ring (`spans()`, with `dropped` counting what it let go once full),
    and a synchronous span opened while a `torch.profiler` records also opens
    `record_function("gonova.<name>")`. Off, a span not in `ALWAYS` is the shared
    `NOOP` (no clock read, nothing allocated); the `ALWAYS` spans still time
    themselves into their histograms.
  * Synchronous spans (`span()`, a context manager) open and close on one thread;
    the open one is the implicit parent of spans opened under it, in the same
    thread or in tasks and `asyncio.to_thread` calls made under it (a context
    variable). Spans that cross an `await` are `begin`/`finish`ed, or `record`ed
    from a start taken earlier; they never open a `record_function`. A span that
    opened one keeps (`SpanRecord.rf`) how long after its start the call returned:
    a reader pairs the two clocks through it.

`device_events` reads a torch.profiler trace's device side.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import itertools
import math
import sys
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional

# 10 us … 100 s, five bounds a decade; a last bucket holds what lies above.
BOUNDS_S = tuple(10.0 ** (e / 5) for e in range(-25, 11))
_BOUNDS_NS = tuple(round(b * 1e9) for b in BOUNDS_S)
# The spans the engine timed before spans existed: their histograms fill with the
# switch off too.
ALWAYS = frozenset({"engine.pass", "engine.embed_voice", "engine.stream.acoustic", "engine.stream.window"})
RING = 1 << 16

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("gonova_span", default=None)


def profiling() -> bool:
    """Whether a torch.profiler records (on any thread) in this process."""
    prof = sys.modules.get("torch.autograd.profiler")
    return bool(getattr(prof, "_is_profiler_enabled", False))


class _Noop:
    """The span of a switched-off tracer, and of a span whose parent was not recorded."""

    __slots__ = ()
    start = end = id = parent = 0
    request = None

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _Noop()


class _Timed(_Noop):
    """An `ALWAYS` span that is not recorded (the switch off, or its parent not
    recorded): its duration feeds its histogram only."""

    __slots__ = ("_tracer", "name", "_t0")

    def __init__(self, tracer: "Tracer", name: str):
        self._tracer, self.name = tracer, name

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._observe(self.name, time.perf_counter_ns() - self._t0)
        return False


class SpanRecord(NamedTuple):
    """A recorded span as `Tracer.spans()` returns it. `rf` is set on a synchronous
    span that opened a `record_function`: how long after `start` that call
    returned, in ns."""

    name: str
    start: int
    end: int
    thread: int
    id: int
    parent: int
    request: object
    attrs: dict
    rf: Optional[int]


class Span:
    """An open span; recorded as a `SpanRecord` when it ends."""

    __slots__ = ("name", "start", "end", "thread", "id", "parent", "request", "attrs", "rf",
                 "_tracer", "_token", "_rfh")

    def __init__(self, tracer: "Tracer", name: str, id: int, parent, request, attrs: dict):
        self.name, self.id, self.attrs = name, id, attrs
        self.parent = parent.id if parent else 0
        self.request = request if request is not None else (parent.request if parent else None)
        self.thread = threading.get_ident()
        self.start = self.end = 0
        self.rf = self._rfh = None
        self._tracer = tracer

    def __bool__(self) -> bool:
        return True

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        self._token = _CURRENT.set(self)
        self.start = time.perf_counter_ns()
        if profiling():
            from torch.autograd.profiler import record_function

            self._rfh = record_function("gonova." + self.name)
            self._rfh.__enter__()
            self.rf = time.perf_counter_ns() - self.start
        return self

    def __exit__(self, *exc) -> bool:
        if self._rfh is not None:
            self._rfh.__exit__(None, None, None)
            self._rfh = None
        self.end = time.perf_counter_ns()
        _CURRENT.reset(self._token)
        self._tracer._record(self)
        return False


def stage(name: str):
    """`record_function("gonova.<name>")` where a recorded span is open on this thread
    (the tracer is on) and a torch.profiler records; else a no-op. A model marks the
    parts of an eager pass with it; a replayed graph runs no Python and marks none."""
    if isinstance(_CURRENT.get(), Span) and profiling():
        from torch.autograd.profiler import record_function

        return record_function("gonova." + name)
    return contextlib.nullcontext()


class Tracer:
    """Spans and their histograms (thread-safe). `on` is the tracing switch."""

    def __init__(self, on: bool = False, capacity: int = RING):
        self.on = bool(on)
        self.dropped = 0
        self._ring: deque = deque(maxlen=capacity)
        self._hist: Dict[str, list] = {}  # name → [bucket counts, count, sum ns, min ns, max ns]
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def new_id(self) -> int:
        return next(self._ids)

    @staticmethod
    def current():
        """The open span of this thread or task (a parent for spans opened now)."""
        return _CURRENT.get()

    @staticmethod
    @contextlib.contextmanager
    def within(span) -> Iterator[None]:
        """Make `span` the implicit parent of what runs under the block: spans, and
        the tasks and `asyncio.to_thread` calls started in it."""
        token = _CURRENT.set(span)
        try:
            yield
        finally:
            _CURRENT.reset(token)

    def _new(self, name: str, parent, request, id: int, attrs: dict):
        if parent is None:
            parent = _CURRENT.get()
        if parent is NOOP:  # under a span that was not recorded
            return NOOP
        return Span(self, name, id or next(self._ids), parent, request, attrs)

    def span(self, name: str, parent=None, request=None, id: int = 0, **attrs):
        """A synchronous span: `with tracer.span(name, **attrs) as sp:`. `id` takes
        one drawn with `new_id()` before the span opens."""
        if self.on:
            span = self._new(name, parent, request, id, attrs)
            if span:
                return span
        return _Timed(self, name) if name in ALWAYS else NOOP

    def begin(self, name: str, parent=None, request=None, start: Optional[int] = None, **attrs):
        """An async span, started now or at `start` (perf_counter_ns); `finish` ends it."""
        if not self.on:
            return NOOP
        span = self._new(name, parent, request, 0, attrs)
        if span:
            span.start = time.perf_counter_ns() if start is None else start
        return span

    def finish(self, span, **attrs) -> None:
        if span:
            span.attrs.update(attrs)
            span.end = time.perf_counter_ns()
            self._record(span)

    def record(self, name: str, start: int, parent=None, request=None, **attrs) -> None:
        """An async span from `start` (perf_counter_ns) to now."""
        if self.on:
            self.finish(self.begin(name, parent, request, start, **attrs))

    def _record(self, span: Span) -> None:
        # Tuples of atoms (the attributes too: a dict would keep it tracked): the
        # collector stops tracking them, so a full ring adds nothing to the work of
        # a full collection.
        record = (span.name, span.start, span.end, span.thread, span.id, span.parent, span.request,
                  tuple(span.attrs.items()), span.rf)
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(record)
            self._observe_locked(span.name, span.end - span.start)

    def _observe(self, name: str, ns: int) -> None:
        with self._lock:
            self._observe_locked(name, ns)

    def _observe_locked(self, name: str, ns: int) -> None:
        h = self._hist.get(name)
        if h is None:
            h = self._hist[name] = [[0] * (len(_BOUNDS_NS) + 1), 0, 0, ns, ns]
        h[0][bisect.bisect_left(_BOUNDS_NS, ns)] += 1
        h[1] += 1
        h[2] += ns
        h[3], h[4] = min(h[3], ns), max(h[4], ns)

    def spans(self) -> List[SpanRecord]:
        """The ring's spans, oldest first."""
        with self._lock:
            records = list(self._ring)
        return [SpanRecord(*r[:7], dict(r[7]), r[8]) for r in records]

    def histograms(self) -> Dict[str, dict]:
        """Per span name: cumulative counts at each of `BOUNDS_S` and above, count,
        sum and extremes in seconds."""
        with self._lock:
            items = [(name, list(h[0]), h[1], h[2], h[3], h[4]) for name, h in self._hist.items()]
        return {name: {"buckets": list(itertools.accumulate(counts)), "count": n, "sum_s": total / 1e9,
                       "min_s": lo / 1e9, "max_s": hi / 1e9}
                for name, counts, n, total, lo, hi in items}

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, h in sorted(self.histograms().items()):
            out[name] = {
                "count": h["count"],
                "p50_ms": round(_quantile(h, 0.50) * 1e3, 3),
                "p90_ms": round(_quantile(h, 0.90) * 1e3, 3),
                "p99_ms": round(_quantile(h, 0.99) * 1e3, 3),
                "mean_ms": round(h["sum_s"] / h["count"] * 1e3, 3),
            }
        return out

    def prometheus(self) -> List[str]:
        """Prometheus text lines: one histogram family over every span name, and the
        ring's drop counter."""
        lines = ["# TYPE gonova_tts_span_seconds histogram"]
        for name, h in sorted(self.histograms().items()):
            for bound, n in zip(BOUNDS_S, h["buckets"]):
                lines.append(f'gonova_tts_span_seconds_bucket{{span="{name}",le="{bound:.6g}"}} {n}')
            lines.append(f'gonova_tts_span_seconds_bucket{{span="{name}",le="+Inf"}} {h["count"]}')
            lines.append(f'gonova_tts_span_seconds_sum{{span="{name}"}} {h["sum_s"]:.9g}')
            lines.append(f'gonova_tts_span_seconds_count{{span="{name}"}} {h["count"]}')
        lines += ["# TYPE gonova_tts_span_ring_dropped counter", f"gonova_tts_span_ring_dropped {self.dropped}"]
        return lines


def _quantile(h: dict, q: float) -> float:
    """The q-quantile (0-1) of a histogram's samples in seconds: log-interpolated
    inside the bucket that holds it, clamped to the extremes."""
    cum, n = h["buckets"], h["count"]
    rank = max(1.0, q * n)
    i = bisect.bisect_left(cum, rank)
    below = cum[i - 1] if i else 0
    lo = max(BOUNDS_S[i - 1] if i else 0.0, h["min_s"])
    hi = min(BOUNDS_S[i] if i < len(BOUNDS_S) else math.inf, h["max_s"])
    if hi <= lo:
        return hi
    f = (rank - below) / (cum[i] - below)
    return lo * (hi / lo) ** f if lo > 0 else lo + (hi - lo) * f


def device_events(prof) -> List:
    """A torch.profiler trace's device events (kernels and copies), largest device
    time first. A user-annotated range (an optimizer's step) also shows as a device
    event spanning its kernels: it is left out, or its kernels would count twice."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)),
                  key=lambda e: e.self_device_time_total, reverse=True)

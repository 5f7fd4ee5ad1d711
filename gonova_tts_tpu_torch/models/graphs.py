"""CUDA graphs of the serving pass: captured at warm-up, replayed per dispatch shape.

An engine that serves one replica on a card keeps a `GraphSet` and makes it the
active set of its thread around each pass (`active`). The model functions that own a
graph (`acoustic.encode`, `acoustic.decode` and each vocoder's `forward`) run their
body through `run`, which

  * runs it eagerly when no set is active, under autograd, or inside the set's own
    capture;
  * in a capturing set (the engine's warm-up), captures it into a new graph keyed on
    the function, the parameters, the tensor inputs' shapes, strides and dtypes and
    the static arguments, without running it (its outputs hold no values yet);
  * in a replaying set (a pass), replays the graph of that key and returns its
    outputs; a key with no graph runs eagerly and counts the pass as eager.

A graph reads its inputs where they lay at capture: an input that lies elsewhere is
first copied there. The engine hands the token-domain graph its own static inputs and
each later graph the outputs of the one before, so a pass copies nothing but where
graphs are shared: one vocoder graph serves a (batch, frame bucket) from every token
bucket's decode. The set keeps every graph's inputs and outputs referenced, so a
later capture never reuses their memory; it may reuse a graph's freed intermediates.
So the graphs of one function share a memory pool, and each function has its own:
a pass replays at most one graph of each function, so a graph never overwrites
what another graph of the pass is still to read. (One pool for all would let a
decode captured after a shared vocoder graph put its outputs where that vocoder
keeps its intermediates, to be overwritten before they are read.) Passes run one at
a time and are read back before the next. The functions are still called as before,
from the same callers and with the same shapes; only their body is replayed instead
of launched op by op.

A set keeps at most `QUEUED` of its replays unfinished on the card: before it
launches another it waits for the oldest to end. Launched back to back, long runs of
replays (F5's 32 Euler steps a pass) fill the card's command buffer and leave the
launching thread blocked inside `cudaGraphLaunch`; a torch.profiler stopped on another
thread meanwhile deadlocked the process. The wait costs the card one launch's latency
a replay, against replays of milliseconds; a pass that reads its results back waits
for its last replay anyway.

What a body must not do under capture: copy from pageable host memory or
synchronise. Host-side constants are therefore built once and kept on the device
(`layers.device_constant`), and the engine runs a few eager passes at batch 1
before it captures (`TTSEngine._prime`), which fill every other host-side memo.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Callable, Dict, Optional, Sequence

import torch

from .. import ops
from ..utils import prof

_LOCAL = threading.local()
QUEUED = 1  # the most replays of a set unfinished on the card at once


class GraphSet:
    """One engine's graphs, their memory pools (one per function) and the stream they
    are captured on. `replayed` and `eager` count the graphed functions of the
    current pass."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graphs: Dict[tuple, tuple] = {}  # key → (graph, inputs, outputs, kernel launches)
        self.capturing = False
        self.open = False  # inside one of this set's captures
        self.replayed = self.eager = 0
        self._pools: Dict[str, tuple] = {}
        self._stream = torch.cuda.Stream(device)
        self._queued: collections.deque = collections.deque()  # an event after each unfinished replay

    def __len__(self) -> int:
        return len(self.graphs)

    def side_stream(self):
        """The capture stream as the current stream: the eager passes before the
        captures run on it, so that the libraries' per-stream state (cuBLAS's
        workspace) exists before a capture."""
        return torch.cuda.stream(self._stream)

    def capture(self, name: str, fn: Callable):
        """(a graph of `fn`'s launches in the pool of function `name`, `fn`'s
        outputs); nothing runs until a replay."""
        graph = torch.cuda.CUDAGraph()
        pool = self._pools.setdefault(name, torch.cuda.graph_pool_handle())
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            self.open = True
            try:
                out = fn()
            finally:
                self.open = False
                graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        return graph, out

    def replay(self, name: str, graph) -> None:
        """Launch `graph` once fewer than `QUEUED` replays of this set are unfinished."""
        while len(self._queued) >= QUEUED:
            self._queued.popleft().synchronize()
        with _launch_range(name):
            graph.replay()
        self._queued.append(self._mark())

    def _mark(self):
        """An event recorded on the current stream after what it has launched."""
        done = torch.cuda.Event()
        done.record()
        return done


@contextlib.contextmanager
def active(graphs: Optional[GraphSet], capture: bool = False):
    """Make `graphs` the set that `run` uses on this thread (capturing with
    `capture`), with the pass's counts reset; `None` leaves every call eager."""
    prev = getattr(_LOCAL, "graphs", None)
    if graphs is not None:
        graphs.capturing, graphs.replayed, graphs.eager = capture, 0, 0
    _LOCAL.graphs = graphs
    try:
        yield graphs
    finally:
        _LOCAL.graphs = prev
        if graphs is not None:
            graphs.capturing = False


def _launch_range(name: str):
    """A profiler op around a replay (`graph:<name>`), for the replayed kernels to be
    linked to. A kernel is attributed to the op that launched it, and a replay runs
    inside no op: within a `record_function` range alone its kernels would count for
    no range. `RecordFunctionFast` records an op, as a library call does. It is
    opened only while a profiler records: it asks whether one does when it opens and
    again when it closes, and raises where a profiler started in between (a traced
    window opening during a replay failed a pass that way)."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return fast(f"graph:{name}") if fast is not None and prof.profiling() else contextlib.nullcontext()


def _count(launches: Dict[str, int], sign: int) -> None:
    """The hand kernels' launch counters (`ops.launch_counts`) count a replayed
    kernel as launched, as an eager call counts it."""
    for name, n in launches.items():
        ops.counter(name).count += sign * n


def _signature(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.stride(), t.dtype


def _fresh(out):
    """The caller's view of a graph's outputs: a dict is copied, so a caller that
    edits it leaves the graph's own untouched."""
    return dict(out) if isinstance(out, dict) else out


def run(name: str, fn: Callable, params, tensors: Sequence[torch.Tensor], *static):
    """`fn()`, whose launches read `tensors` and depend otherwise on `params` and the
    hashable `static` arguments alone: replayed from, or captured into, a graph of
    the active set, else run eagerly. A warm-up call of a shape already captured
    returns that graph's outputs and runs nothing."""
    graphs = getattr(_LOCAL, "graphs", None)
    if graphs is None or graphs.open or torch.is_grad_enabled():
        return fn()
    key = (name, id(params), tuple(_signature(t) for t in tensors), static)
    hit = graphs.graphs.get(key)
    if hit is None:
        if not graphs.capturing:
            graphs.eager += 1
            return fn()
        before = ops.launch_counts()
        graph, out = graphs.capture(name, fn)
        launches = {k: n - before.get(k, 0) for k, n in ops.launch_counts().items() if n != before.get(k, 0)}
        _count(launches, -1)  # a capture launches nothing
        graphs.graphs[key] = (graph, tuple(tensors), out, launches)
        return _fresh(out)
    graph, inputs, out, launches = hit
    if not graphs.capturing:
        for mine, given in zip(inputs, tensors):
            if mine.data_ptr() != given.data_ptr():
                mine.copy_(given)
        graphs.replay(name, graph)
        _count(launches, 1)
        graphs.replayed += 1
    return _fresh(out)

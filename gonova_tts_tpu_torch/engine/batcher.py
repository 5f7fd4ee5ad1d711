"""Dynamic batcher: admission-windowed request coalescing in front of the engine.

The reference serializes synthesis one request at a time through a single worker
(services/tts/server.py:110-186) — its "20-30 concurrent syntheses" are connection-level
only.  Here concurrent requests admitted within `batch_window_ms` are coalesced into one
padded batch per device pass (up to `max_batch`): a batch costs the device little more
than a single request. The port's own copy of `gonova_tts_tpu/engine/batcher.py`.

Latency shape: p50 TTFA ≈ admission window + one acoustic pass + one vocoder window.

Spans (the engine's tracer): `frontend.text_to_ids` per sentence; `batcher.wait`
per sentence, from its queue put to the start of the engine call for its bucket
group (`pass_id` names the `engine.pass` that served it); `batcher.admission` per
window, from its first item to the window closed. A sentence's spans take the
caller's open span (its request's) as parent; the passes take the window's.

A sentence's frontend is `engine.plan` against its voice: its ids and the bucket
its pass pads it to (the token bucket; under an F5 engine the frame bucket of its
L), by which a window's sentences are grouped.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..text import text_to_ids
from ..utils import get_logger
from .engine import Plan, TTSEngine

logger = get_logger("gonova.batcher")


def _frontend(tracer, engine, text: str, speaker) -> Plan:
    """The engine's plan of a sentence, its token ids by this module's
    `text_to_ids` (tts_bench's trace times the frontend by wrapping that name)."""
    with tracer.span("frontend.text_to_ids"):
        return engine.plan(text, speaker, text_to_ids)


@dataclass
class _Pending:
    text: str
    speaker: Optional[np.ndarray]
    exaggeration: float
    future: asyncio.Future = field(repr=False, default=None)
    enqueued_at: int = 0  # perf_counter_ns at the queue put: batcher.wait's start
    plan: Optional[Plan] = None  # frontend output, computed once
    parent: object = field(repr=False, default=None)  # the caller's span


class DynamicBatcher:
    """Coalesces `submit()` calls into engine.synthesize_batch passes."""

    def __init__(self, engine: TTSEngine, max_batch: Optional[int] = None,
                 window_ms: Optional[float] = None):
        self.engine = engine
        self.tracer = engine.tracer
        self.max_batch = max_batch or engine.ecfg.max_batch
        self.window_s = (window_ms if window_ms is not None else engine.ecfg.batch_window_ms) / 1000.0
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._stopped = False  # set by stop(); distinct from "not yet started"
        self.metrics = {
            "batches": 0,
            "requests": 0,
            "max_batch_seen": 0,
            "bucket_splits": 0,  # admission windows split into >1 device pass
        }

    async def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._stopped = False
        self._task = asyncio.create_task(self._worker())

    async def stop(self) -> None:
        self._running = False
        self._stopped = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # Fail any admitted-but-unbatched items so submit() callers never hang on a
        # mid-flight stop (in-flight batches resolve their own futures above).
        while not self._queue.empty():
            item = self._queue.get_nowait()
            if item.future is not None and not item.future.done():
                item.future.set_exception(RuntimeError("batcher stopped"))

    async def submit(
        self,
        text: str,
        speaker: Optional[np.ndarray] = None,
        exaggeration: float = 0.5,
    ) -> np.ndarray:
        """Synthesize one sentence-chunk; resolves when its batch completes."""
        loop = asyncio.get_event_loop()
        # Frontend (normalize + G2P, possibly the neural-G2P decode for OOV words)
        # runs off the event loop, and exactly once — the plan rides to the engine.
        plan = await asyncio.to_thread(_frontend, self.tracer, self.engine, text, speaker)
        item = _Pending(
            text=text,
            speaker=speaker,
            exaggeration=exaggeration,
            future=loop.create_future(),
            enqueued_at=time.perf_counter_ns(),
            plan=plan,
            parent=self.tracer.current(),
        )
        await self._queue.put(item)
        # stop() may have finished draining while the frontend ran in the
        # executor above — the put then lands in a dead batcher and nothing
        # would ever resolve the future. Fail it here (same contract as stop()).
        if self._stopped and not item.future.done():
            item.future.set_exception(RuntimeError("batcher stopped"))
        return await item.future

    async def _worker(self) -> None:
        while self._running:
            try:
                first = await self._queue.get()
            except asyncio.CancelledError:
                break
            batch: List[_Pending] = [first]
            admission = self.tracer.begin("batcher.admission")
            deadline = time.time() + self.window_s
            cancelled = False
            while len(batch) < self.max_batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self._queue.get(), timeout))
                except asyncio.TimeoutError:
                    break  # admission window closed — dispatch what we have
                except asyncio.CancelledError:
                    cancelled = True
                    break
            if cancelled:
                # stop() cancelled us while we were filling the window. Don't eat
                # the cancellation and dispatch a device pass anyway — fail the
                # admitted futures and exit (stop() flushes the rest of the queue).
                for p in batch:
                    if p.future is not None and not p.future.done():
                        p.future.set_exception(RuntimeError("batcher stopped"))
                raise asyncio.CancelledError

            try:
                # Bucket-aware dispatch: the engine pads every request in a device pass
                # to the pass's single token bucket, so a 5-token and a 40-token sentence
                # sharing one pass both pay the 64-bucket. Group by bucket and run one
                # pass per group — ≤1 extra pass in the common two-length case, and the
                # padded-token waste drops to the per-bucket minimum.
                groups: Dict[int, List[_Pending]] = {}
                for p in batch:
                    groups.setdefault(p.plan.bucket, []).append(p)
                if len(groups) > 1:
                    self.metrics["bucket_splits"] += 1
                if admission:
                    self.tracer.finish(admission, items=len(batch), groups=len(groups))

                for bucket, group in groups.items():
                    pass_id = self.tracer.new_id()
                    if self.tracer.on:
                        for p in group:
                            self.tracer.record("batcher.wait", p.enqueued_at, parent=p.parent,
                                               pass_id=pass_id, token_bucket=bucket)
                    try:
                        with self.tracer.within(admission):
                            results = await asyncio.to_thread(
                                self.engine.synthesize_batch,
                                [p.text for p in group],
                                [p.speaker for p in group],
                                [p.exaggeration for p in group],
                                pass_id=pass_id,
                                plans=[p.plan for p in group],
                            )
                        for p, r in zip(group, results):
                            if not p.future.done():
                                p.future.set_result(r)
                    except Exception as e:  # noqa: BLE001 — isolate failures per group
                        logger.error("batch_failed", error=str(e), batch_size=len(group))
                        for p in group:
                            if not p.future.done():
                                p.future.set_exception(e)
                self.metrics["batches"] += len(groups)
                self.metrics["requests"] += len(batch)
                self.metrics["max_batch_seen"] = max(self.metrics["max_batch_seen"], len(batch))
            except asyncio.CancelledError:
                # stop() cancelled us mid-device-pass: CancelledError is a
                # BaseException so the per-group handler above doesn't see it —
                # fail every unresolved future in this batch (the executor job
                # itself finishes on its own thread) so submit() callers never hang.
                for p in batch:
                    if p.future is not None and not p.future.done():
                        p.future.set_exception(RuntimeError("batcher stopped"))
                raise
            except Exception as e:  # noqa: BLE001 — the worker must outlive ANY batch
                # An error in group assembly or metrics (outside the per-group
                # guard) must not kill the worker task: a dead worker strands the
                # current batch's futures and hangs every subsequent submit()
                # forever with _stopped still False.
                logger.error("batcher_worker_error", error=str(e), exc_info=True)
                for p in batch:
                    if p.future is not None and not p.future.done():
                        p.future.set_exception(e)

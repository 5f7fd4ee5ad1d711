"""Queueing layer with the reference's exact bounds/drop/metrics semantics.

Spec (reference: services/tts/core/queue_manager.py):
  * bounded input queue (500) with 2.0 s put timeout → drop + count (:131-171);
  * per-connection bounded output queues (2000) with put_nowait → 0.1 s retry → drop
    (:200-248);
  * metrics dict with keys requests_received/processed/dropped, chunks_sent,
    active_connections (+ live sizes in get_metrics, :282-291);
  * 10 s metrics logger with an 80%-full warning (:105-129);
  * drain-on-unregister (:264-280) and wait_until_empty for shutdown (:293-313).

The consumer side differs from the reference by design: multiple service workers feed
the dynamic batcher concurrently instead of one serialized worker (SURVEY.md §2.4).
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..utils import get_logger
from ..utils.prof import NOOP

logger = get_logger("gonova.queue")


@dataclass
class SynthesisRequest:
    connection_id: str
    text: str
    voice_id: str
    timestamp: float
    chunk_size: int = 50
    exaggeration: float = 0.5
    streaming: bool = True
    generation: int = 0  # cancel support: stale generations are skipped
    seq: int = 0  # per-connection send-order index (worker pool streams in order)
    metadata: bool = False  # opt-in synthesis_started frame (README-promised extension)
    output_format: str = "pcm"  # pcm|wav|mp3|opus (encoding: config, audio/encode.py)
    cancelled: bool = field(default=False, compare=False)
    trace: object = field(default=NOOP, compare=False, repr=False)  # its service.request span


@dataclass
class AudioChunk:
    connection_id: str
    audio_data: bytes
    chunk_id: int
    is_final: bool
    sample_rate: int = 24000
    trace: object = field(default=None, compare=False, repr=False)  # the request's span, on its first audio


class TTSQueueManager:
    def __init__(self, input_queue_size: int = 500, output_queue_size: int = 2000):
        self.input_queue: asyncio.Queue = asyncio.Queue(maxsize=input_queue_size)
        self.output_queues: Dict[str, asyncio.Queue] = {}
        self.output_queue_size = output_queue_size
        self.metrics = {
            "requests_received": 0,
            "requests_processed": 0,
            "requests_dropped": 0,
            "chunks_sent": 0,
            "active_connections": 0,
        }
        self._workers = []
        self.running = False
        # Requests pulled by a worker but not yet marked done: in NEITHER queue, so
        # the drain check must count them or shutdown cancels mid-synthesis work.
        self.in_flight = 0

    async def start(self) -> None:
        if self.running:
            logger.warning("queue_manager_already_running")
            return
        self.running = True
        self._workers.append(asyncio.create_task(self._metrics_worker()))

    async def stop(self) -> None:
        self.running = False
        for w in self._workers:
            w.cancel()
        await asyncio.gather(*self._workers, return_exceptions=True)
        self._workers.clear()

    async def _metrics_worker(self) -> None:
        while self.running:
            try:
                await asyncio.sleep(10.0)
                logger.info(
                    "queue_metrics",
                    input=f"{self.input_queue.qsize()}/{self.input_queue.maxsize}",
                    connections=len(self.output_queues),
                    requests=self.metrics["requests_received"],
                    chunks=self.metrics["chunks_sent"],
                    dropped=self.metrics["requests_dropped"],
                )
                if self.input_queue.qsize() > self.input_queue.maxsize * 0.8:
                    logger.warning(
                        "input_queue_almost_full",
                        size=self.input_queue.qsize(),
                        maxsize=self.input_queue.maxsize,
                    )
            except asyncio.CancelledError:
                break
            except Exception as e:  # noqa: BLE001
                logger.error("metrics_worker_error", error=str(e))

    async def enqueue_request(
        self,
        connection_id: str,
        text: str,
        voice_id: str = "default",
        chunk_size: int = 50,
        exaggeration: float = 0.5,
        streaming: bool = True,
        timeout: float = 2.0,
        generation: int = 0,
        metadata: bool = False,
        seq: int = 0,
        output_format: str = "pcm",
        trace: object = NOOP,
    ) -> bool:
        request = SynthesisRequest(
            connection_id=connection_id,
            text=text,
            voice_id=voice_id,
            timestamp=time.time(),
            chunk_size=chunk_size,
            exaggeration=exaggeration,
            streaming=streaming,
            generation=generation,
            metadata=metadata,
            seq=seq,
            output_format=output_format,
            trace=trace,
        )
        try:
            await asyncio.wait_for(self.input_queue.put(request), timeout=timeout)
            self.metrics["requests_received"] += 1
            return True
        except asyncio.TimeoutError:
            logger.warning("input_queue_full_request_dropped", connection_id=connection_id)
            self.metrics["requests_dropped"] += 1
            return False

    async def get_next_request(self, timeout: float = 1.0) -> Optional[SynthesisRequest]:
        try:
            req = await asyncio.wait_for(self.input_queue.get(), timeout=timeout)
            self.in_flight += 1
            return req
        except asyncio.TimeoutError:
            return None
        except Exception as e:  # noqa: BLE001
            logger.error("get_next_request_error", error=str(e))
            return None

    async def requeue(self, request: SynthesisRequest) -> bool:
        """Put a pulled request back (out-of-order arrival at a worker). Balances
        the original get()'s task_done/in_flight accounting; the requeued item gets
        its own. False if the queue is full (caller must fail the request)."""
        try:
            self.input_queue.put_nowait(request)
        except asyncio.QueueFull:
            self.input_queue.task_done()
            self.in_flight = max(0, self.in_flight - 1)
            # This IS a drop (the caller discards the request with an error
            # frame); without it received > processed + dropped forever and
            # monitoring reads a stuck in-flight backlog.
            self.metrics["requests_dropped"] += 1
            return False
        self.input_queue.task_done()
        self.in_flight = max(0, self.in_flight - 1)
        return True

    async def mark_request_done(self) -> None:
        self.input_queue.task_done()
        self.in_flight = max(0, self.in_flight - 1)
        self.metrics["requests_processed"] += 1

    async def enqueue_audio_chunk(
        self,
        connection_id: str,
        audio_data: bytes,
        chunk_id: int,
        is_final: bool = False,
        sample_rate: int = 24000,
        trace: object = None,
    ) -> bool:
        queue = self.output_queues.get(connection_id)
        if queue is None:
            logger.warning("output_queue_missing", connection_id=connection_id)
            return False
        chunk = AudioChunk(
            connection_id=connection_id,
            audio_data=audio_data,
            chunk_id=chunk_id,
            is_final=is_final,
            sample_rate=sample_rate,
            trace=trace,
        )
        try:
            queue.put_nowait(chunk)
            self.metrics["chunks_sent"] += 1
            return True
        except asyncio.QueueFull:
            # Audio chunks are droppable under backpressure (reference policy, 0.1 s);
            # CONTROL frames (is_final / negative chunk ids) are not — dropping a
            # final marker strands the client waiting for synthesis_complete, so they
            # get a much longer bound (5 s covers any realistic drain; still bounded
            # so a dead-but-registered connection can't wedge a worker).
            timeout = 5.0 if (is_final or chunk_id < 0) else 0.1
            try:
                await asyncio.wait_for(queue.put(chunk), timeout=timeout)
                self.metrics["chunks_sent"] += 1
                return True
            except asyncio.TimeoutError:
                logger.warning(
                    "output_queue_full_chunk_dropped",
                    connection_id=connection_id,
                    chunk_id=chunk_id,
                    is_final=is_final,
                )
                return False

    def register_connection(self, connection_id: str) -> asyncio.Queue:
        queue: asyncio.Queue = asyncio.Queue(maxsize=self.output_queue_size)
        self.output_queues[connection_id] = queue
        self.metrics["active_connections"] = len(self.output_queues)
        logger.info("connection_registered", connection_id=connection_id)
        return queue

    def unregister_connection(self, connection_id: str) -> None:
        queue = self.output_queues.pop(connection_id, None)
        if queue is None:
            return
        while not queue.empty():
            try:
                queue.get_nowait()
                queue.task_done()
            except Exception:  # noqa: BLE001
                break
        self.metrics["active_connections"] = len(self.output_queues)
        logger.info("connection_unregistered", connection_id=connection_id)

    def get_metrics(self) -> dict:
        return {
            **self.metrics,
            "input_queue_size": self.input_queue.qsize(),
            "output_queues_count": len(self.output_queues),
            "total_output_queue_items": sum(q.qsize() for q in self.output_queues.values()),
        }

    async def wait_until_empty(self, timeout: float = 30.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if (
                self.input_queue.empty()
                and self.in_flight == 0
                and all(q.empty() for q in self.output_queues.values())
            ):
                logger.info("all_queues_empty")
                return True
            await asyncio.sleep(0.5)
        logger.warning("queue_drain_timeout", timeout=timeout)
        return False

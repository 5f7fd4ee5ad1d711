"""TTS service of the port: the WebSocket streaming API, health/metrics and REST synthesis.

The port's counterpart of `gonova_tts_tpu/service/server.py`, behaviour for behaviour,
over the port's engine, batcher, voice manager and queues:
  * WS `/v1/stream/tts`: inbound JSON `synthesize` / `register_voice` / `list_voices` /
    `cancel`; outbound binary frames (float32 mono 24 kHz PCM, or the request's
    wav/mp3/opus stream), then `{"type": "synthesis_complete", "chunk_id": N}`;
    `voice_registered`, `voice_list`, `cancelled` and `error` messages;
  * admission control: per-IP rate limit, then max connections, both closing with 1008;
  * unknown voice_id → warning + the default voice; per-request error isolation;
  * `GET /health` (503 until loaded), `GET /metrics` (JSON, or `?format=prometheus`),
    `POST /v1/synthesize` (a whole utterance as pcm/wav/mp3/opus);
  * env: TTS_PORT / TTS_INSTANCE_ID.

`TTSService` needs no aiohttp: it talks to a socket only through `async for msg in ws`
(messages with `.type` and `.data`), `send_json`, `send_bytes` and `close`, and
compares message types with this module's `WSMsgType`, whose values are aiohttp's.
`health()`, `metrics()` and `metrics_prometheus()` build the bodies the HTTP handlers
send. aiohttp is imported only by the app (`create_app`, the handlers, `main`), so the
service runs behind any socket that offers those calls.

Spans (the engine's tracer, utils/prof.py), request id `(connection id, seq)`:
`service.request` from a `synthesize` message's admission to its final marker
enqueued; under it `service.queue_wait` (admission → a worker takes it up, parking
included) and `service.first_audio` (admission → its first binary frame handed to
`send_bytes`), and what the request runs: its sentences' frontend and batcher spans
and its voice's embedding. `service.register_voice`: the message → its reply.

    python -m gonova_tts_tpu_torch.service.server     # port 8002, TTS_PORT overrides
"""

from __future__ import annotations

import asyncio
import enum
import io
import json
import os
import time
import uuid
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..audio import encode as encode_mod
from ..config import Config, load_config
from ..engine import DynamicBatcher, VoiceEmbeddingCache
from ..text import segment_text
from ..utils import get_logger, write_wav
from ..utils.jsonlog import configure as configure_logging
from .queue_manager import SynthesisRequest, TTSQueueManager
from .rate_limiter import RateLimiter
from .synthesizer import StreamingSynthesizer
from .voice_manager import VoiceManager, sanitize_voice_id

logger = get_logger("gonova.server")

WS_POLICY_VIOLATION = 1008


class WSMsgType(enum.IntEnum):
    """WebSocket message types with aiohttp's values: aiohttp's own `WSMsgType` is an
    `IntEnum` too, so its messages compare equal to these."""

    CONTINUATION = 0
    TEXT = 1
    BINARY = 2
    CLOSE = 8
    PING = 9
    PONG = 10
    CLOSING = 256
    CLOSED = 257
    ERROR = 258


def device_info(device: torch.device) -> dict:
    """What `/health` reports under "device" and "tpu" (the key the JAX service's
    clients read): the backend the engine runs on and its devices."""
    if device.type == "cuda":
        n = torch.cuda.device_count()
        return {
            "backend": "cuda",
            "device_count": n,
            "devices": [torch.cuda.get_device_name(i) for i in range(min(n, 8))],
        }
    return {"backend": "cpu", "device_count": 1, "devices": ["cpu"]}


class TTSService:
    """Composition root: synthesizer/engine, voice manager, queues, batcher, workers.
    The engine runs on `config.model.device`."""

    def __init__(self, config: Optional[Config] = None):
        self.config = config or load_config()
        configure_logging(self.config.logging.level, logfile=self.config.logging.file)

        self.synthesizer = StreamingSynthesizer(self.config)
        self.tracer = self.synthesizer.engine.tracer
        self.voice_manager = VoiceManager(
            cache_dir=self.config.voice_cloning.cache_dir,
            max_cached=self.config.voice_cloning.max_cached_voices,
            min_duration=self.config.voice_cloning.min_duration,
            max_duration=self.config.voice_cloning.max_duration,
            min_snr=self.config.voice_cloning.min_snr,
        )
        self.queue_manager = TTSQueueManager(
            input_queue_size=self.config.queues.input_queue_size,
            output_queue_size=self.config.queues.output_queue_size,
        )
        self.rate_limiter = RateLimiter(
            max_requests=self.config.rate_limiting.max_requests_per_minute,
            window=self.config.rate_limiting.window_seconds,
        )
        self.voice_embeddings = VoiceEmbeddingCache(
            max_entries=self.config.voice_cloning.max_cached_voices
        )
        self.batcher: Optional[DynamicBatcher] = None

        self.max_connections = self.config.server.max_connections
        self.active_connections = 0
        self.device_health: Dict[str, object] = {"status": "unloaded"}
        self._watchdog_task: Optional[asyncio.Task] = None
        self.connections: Dict[str, dict] = {}
        self.is_shutting_down = False
        self._workers = []
        self._cancel_generations: Dict[str, int] = {}
        # Per-connection ORDERING: the worker pool parallelizes across connections,
        # but one connection's requests must stream back strictly in send order —
        # binary frames carry no request id (reference protocol), so interleaving
        # or reordering them garbles the client's audio. Each request gets a
        # per-connection sequence number at admission; a worker only runs the
        # request whose seq equals the connection's cursor. A later seq pulled
        # early is PARKED in a per-connection dict (it stays in_flight for drain
        # accounting); the worker that completes the earlier seq picks the parked
        # successor up inline — no requeue churn, and one chatty client only ever
        # occupies one worker. The cursor advances strictly contiguously: seqs
        # that will never run (admission drop, cancel, dead connection) go into a
        # done-set and the cursor moves only when its own seq lands there, so an
        # overload can never let two requests of one connection stream at once.
        self._conn_seq_alloc: Dict[str, int] = {}
        self._conn_seq_next: Dict[str, int] = {}
        self._conn_done: Dict[str, set] = {}
        self._conn_parked: Dict[str, Dict[int, SynthesisRequest]] = {}
        self._park_cap = 32  # per-connection parked bound (admission stays queue-bounded)
        self._park_count = 0  # observability: how often workers hit out-of-order pulls
        self.is_draining = False
        self._default_speaker: Optional[np.ndarray] = None
        self.started_at: Optional[float] = None

    # ------------------------------------------------------------ lifecycle

    async def start(self, n_workers: Optional[int] = None) -> None:
        logger.info("service_starting")
        await self.synthesizer.load()
        self.batcher = DynamicBatcher(self.synthesizer.engine)
        await self.batcher.start()
        await self.queue_manager.start()
        await self._load_default_voice()
        n = n_workers or self.config.engine.max_batch
        self._workers = [asyncio.create_task(self._tts_worker(i)) for i in range(n)]
        self._watchdog_task = asyncio.create_task(self._watchdog())
        self.started_at = time.time()
        logger.info("service_started", workers=n)

    async def _watchdog(self, interval_s: float = 30.0) -> None:
        """Periodic device liveness probe feeding /health."""
        loop = asyncio.get_event_loop()
        while not self.is_shutting_down:
            try:
                self.device_health = await loop.run_in_executor(
                    None, self.synthesizer.engine.health_check
                )
                if self.device_health.get("status") not in ("ok", "unloaded"):
                    logger.warning("device_health_degraded", **self.device_health)
                # Unbounded-growth guard the reference lacks: drop idle rate-limiter
                # clients each probe cycle.
                self.rate_limiter.prune()
                await asyncio.sleep(interval_s)
            except asyncio.CancelledError:
                break
            except Exception as e:  # noqa: BLE001
                self.device_health = {"status": "unhealthy", "reason": str(e)}
                await asyncio.sleep(interval_s)

    async def shutdown(self) -> None:
        logger.info("service_shutting_down")
        # Gate new admissions for the whole drain: without this an active client
        # can keep the input queue non-empty until the 30 s timeout expires and
        # then lose its in-flight requests to the worker cancellation below.
        self.is_draining = True
        if self._watchdog_task:
            self._watchdog_task.cancel()
        # Drain BEFORE signalling the workers: each worker loop exits on
        # is_shutting_down, so flipping it first would leave any requests beyond
        # one-per-worker stranded in the input queue for the whole drain timeout.
        await self.queue_manager.wait_until_empty(timeout=30.0)
        self.is_shutting_down = True
        for w in self._workers:
            w.cancel()
        await asyncio.gather(*self._workers, return_exceptions=True)
        self._workers.clear()
        if self.batcher:
            await self.batcher.stop()
        await self.queue_manager.stop()
        await self.synthesizer.cleanup()
        logger.info("service_stopped")

    async def _load_default_voice(self) -> None:
        path = self.config.voice_cloning.default_voice_path
        if path and not os.path.exists(path):
            # Configured path missing → shipped fallback asset (the reference ships
            # voices/urek.wav as its default; ours lives in assets/ so a fresh
            # checkout speaks out of the box). Explicit null disables the default.
            shipped = os.path.join(
                os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                "assets",
                "default_voice.wav",
            )
            if os.path.exists(shipped):
                path = shipped
        if path and os.path.exists(path):
            loop = asyncio.get_event_loop()
            try:
                self._default_speaker = await loop.run_in_executor(
                    None, self.synthesizer.engine.voice_from_file, path,
                    self.config.voice_cloning.default_voice_text,
                )
                logger.info("default_voice_loaded", path=path)
            except Exception as e:  # noqa: BLE001
                logger.warning("default_voice_load_failed", path=path, error=str(e))
        else:
            logger.info("default_voice_absent", path=path)

    # ------------------------------------------------------------ synthesis workers

    async def _resolve_speaker(self, voice_id: str):
        """voice_id → the engine's voice (`voice_from_file`: a speaker embedding, or
        an F5 model's prompt from the recording and its registered transcript);
        unknown ids warn + fall back to default (reference behavior,
        server.py:128-138)."""
        if not voice_id or voice_id == "default":
            return self._default_speaker
        # Cache under the SANITIZED id — the voice manager resolves by it, so two
        # raw spellings of one voice must share the entry (and re-registration's
        # invalidate must hit every spelling).
        key = sanitize_voice_id(voice_id)
        cached = self.voice_embeddings.get(key)
        if cached is not None:
            return cached
        # Snapshot the registration generation BEFORE embedding: if the voice is
        # re-registered while the executor thread embeds the old file, caching
        # that result afterwards would permanently re-install the stale voice.
        gen = self.voice_manager.generation_of(key)
        path = await self.voice_manager.get_voice(voice_id)
        if path is None:
            logger.warning("voice_not_found", voice_id=voice_id)
            return self._default_speaker
        emb = await asyncio.to_thread(
            self.synthesizer.engine.voice_from_file, path, self.voice_manager.get_reference_text(voice_id)
        )
        if self.voice_manager.generation_of(key) == gen:
            self.voice_embeddings.put(key, emb)
        return emb

    async def _send_error_frame(self, conn_id: str, message: str, chunk_id: int) -> None:
        """Error JSON + terminating synthesis_complete so a failed request never
        strands the client (control frames use the blocking-put path)."""
        try:
            await self.queue_manager.enqueue_audio_chunk(
                conn_id, message.encode("utf-8"), -2, is_final=False
            )
            await self.queue_manager.enqueue_audio_chunk(conn_id, b"", chunk_id, is_final=True)
        except Exception as e:  # noqa: BLE001
            logger.error("error_frame_send_failed", connection_id=conn_id, error=str(e))

    def _is_stale(self, request: SynthesisRequest) -> bool:
        return request.generation < self._cancel_generations.get(request.connection_id, 0)

    def _finish_seq(self, conn_id: str, seq: int) -> None:
        """Mark seq finished-or-skipped; advance the connection cursor CONTIGUOUSLY.

        The cursor only moves through seqs that have actually completed (or will
        never run) — jumping past an unfinished seq would let a later request pass
        the gate while an earlier one is still streaming."""
        if conn_id not in self.queue_manager.output_queues:
            # Connection already torn down: its cursor/done entries were popped in
            # handle_connection's finally, and conn ids are never reused. Recording
            # here (e.g. a worker's finally firing after client disconnect) would
            # resurrect the dicts and leak an entry per aborted connection.
            return
        nxt = self._conn_seq_next.get(conn_id, 0)
        if seq != nxt:
            self._conn_done.setdefault(conn_id, set()).add(seq)
            return
        nxt = seq + 1
        done = self._conn_done.get(conn_id)
        if done:
            while nxt in done:
                done.discard(nxt)
                nxt += 1
        self._conn_seq_next[conn_id] = nxt

    def _pop_ready(self, conn_id: str) -> Optional[SynthesisRequest]:
        """Parked successor whose seq just became current, if any."""
        parked = self._conn_parked.get(conn_id)
        if not parked:
            return None
        return parked.pop(self._conn_seq_next.get(conn_id, 0), None)

    async def _flush_dead_connection(self, conn_id: str) -> None:
        """Release bookkeeping for requests of a connection that no longer exists."""
        parked = self._conn_parked.pop(conn_id, None)
        if parked:
            for _ in parked:
                await self.queue_manager.mark_request_done()
        self._conn_done.pop(conn_id, None)

    async def _tts_worker(self, worker_id: int) -> None:
        """Pull requests, segment, feed the batcher, stream chunks back in order.

        N of these run concurrently; the batcher coalesces their sentences into shared
        device passes. Per-request failures are isolated (reference server.py:173-186)."""
        logger.info("tts_worker_started", worker=worker_id)
        while not self.is_shutting_down:
            try:
                request = await self.queue_manager.get_next_request()
                # Completing one request can unpark its successor; process the
                # chain inline — per-connection requests are serial by contract,
                # so one worker owning the backlog is the optimal schedule.
                while request is not None:
                    # The request's span is the parent of what it runs.
                    with self.tracer.within(request.trace):
                        request = await self._process_request(request)
            except asyncio.CancelledError:
                break
            except Exception as e:  # noqa: BLE001
                logger.error("tts_worker_error", worker=worker_id, error=str(e))
                await asyncio.sleep(1.0)

    async def _process_request(
        self, request: SynthesisRequest
    ) -> Optional[SynthesisRequest]:
        """Run (or park/skip) one pulled request; return the next ready one."""
        conn = request.connection_id
        if conn not in self.queue_manager.output_queues:
            # Connection already gone: drop the work and any parked siblings.
            await self.queue_manager.mark_request_done()
            await self._flush_dead_connection(conn)
            return None
        if self._is_stale(request):
            self._finish_seq(conn, request.seq)
            await self.queue_manager.mark_request_done()
            return self._pop_ready(conn)
        if request.seq > self._conn_seq_next.get(conn, 0):
            # An earlier request from this connection is still streaming (or in
            # another worker's hands). Park it — it stays in_flight for drain
            # accounting and is released by whichever worker finishes the
            # predecessor. No await between the liveness check above and this
            # insert, so connection teardown can't race us into a leak.
            parked = self._conn_parked.setdefault(conn, {})
            if len(parked) < self._park_cap:
                parked[request.seq] = request
                self._park_count += 1
                return None
            # Parked depth at cap: without this, workers would drain the whole
            # input queue into parked dicts and a single pipelining client could
            # bypass the queue bound entirely. Put it back (admission control
            # stays with the bounded queue) or, if even that is full, drop with
            # an error frame — plain JSON, no final marker, so it cannot
            # terminate the in-flight request's stream early.
            if not await self.queue_manager.requeue(request):
                self._finish_seq(conn, request.seq)
                await self.queue_manager.enqueue_audio_chunk(
                    conn, b"Server busy: request queue full", -2, is_final=False
                )
            await asyncio.sleep(0.005)  # throttle the above-cap requeue cycle
            return None
        if request.trace:
            self.tracer.record("service.queue_wait", request.trace.start, parent=request.trace)
        chunk_id = 0
        pending: list = []
        try:
            try:
                speaker = await self._resolve_speaker(request.voice_id)
                sentences = segment_text(request.text)
                # Per-request streaming encoder (audio/encode.py): pcm is the
                # byte-identical wire default; wav/mp3/opus produce encoded binary
                # frames. Encoder state lives for the request, so codec frame
                # boundaries span chunk boundaries correctly.
                encoder = encode_mod.make_encoder(
                    request.output_format,
                    self.config.model.sample_rate,
                    mp3_bitrate=self.config.encoding.mp3_bitrate,
                    opus_bitrate=self.config.encoding.opus_bitrate,
                )
                if request.metadata:
                    # Opt-in extension (reference README.md:160-173, never
                    # shipped there): announce synthesis start without
                    # breaking byte-parity for clients that didn't ask.
                    await self.queue_manager.enqueue_audio_chunk(
                        request.connection_id, b"", -1, is_final=False
                    )
                pending = [
                    asyncio.create_task(
                        self.batcher.submit(s, speaker, request.exaggeration)
                    )
                    for s in sentences
                ]
                for fut in pending:
                    audio = await fut
                    if self._is_stale(request):
                        break
                    if conn not in self.queue_manager.output_queues:
                        # Client disconnected mid-request: teardown popped the
                        # cancel generation, so _is_stale can never trip — stop
                        # burning device batch slots synthesizing for nobody.
                        break
                    payload = encoder.encode(audio.astype(np.float32))
                    if not payload:
                        # A codec may buffer a short chunk entirely; no frame to
                        # send yet (never happens for pcm — parity preserved).
                        continue
                    await self.queue_manager.enqueue_audio_chunk(
                        request.connection_id, payload, chunk_id, is_final=False,
                        trace=None if chunk_id else request.trace,
                    )
                    chunk_id += 1
                tail = encoder.flush()
                if tail and not self._is_stale(request):
                    await self.queue_manager.enqueue_audio_chunk(
                        request.connection_id, tail, chunk_id, is_final=False,
                        trace=None if chunk_id else request.trace,
                    )
                    chunk_id += 1
                await self.queue_manager.enqueue_audio_chunk(
                    request.connection_id, b"", chunk_id, is_final=True
                )
            except Exception as e:  # noqa: BLE001
                logger.error(
                    "synthesis_failed",
                    connection_id=request.connection_id,
                    error=str(e),
                    exc_info=True,
                )
                # Never leave the client hanging: error frame + final
                # marker, sent BEFORE the seq advances so they can't
                # interleave into the next request's stream.
                await self._send_error_frame(
                    request.connection_id, f"Synthesis failed: {e}", chunk_id
                )
            self.tracer.finish(request.trace)
            logger.info(
                "synthesis_completed",
                connection_id=request.connection_id,
                text_length=len(request.text),
                chunks=chunk_id,
            )
        finally:
            # Cancelled/failed mid-request: don't leave queued sentences
            # running on the device or futures nobody awaits.
            for t in pending:
                if not t.done():
                    t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            self._finish_seq(conn, request.seq)
            # In the finally: a CancelledError mid-synthesis (shutdown cancelling
            # workers) must not leak the in_flight/task_done accounting.
            await self.queue_manager.mark_request_done()
        return self._pop_ready(conn)

    # ------------------------------------------------------------ WS connection

    async def handle_connection(self, ws, conn_id: str) -> None:
        """Serve one WebSocket until its receive side ends. `ws` is an async iterator
        of messages (`.type`, `.data`) with `send_json`, `send_bytes` and `close`."""
        output_queue = self.queue_manager.register_connection(conn_id)
        self.connections[conn_id] = {"connected_at": time.time(), "last_activity": time.time()}
        self.active_connections += 1
        self._cancel_generations[conn_id] = 0
        logger.info(
            "connection_established",
            connection_id=conn_id,
            active_connections=self.active_connections,
        )

        async def receive_requests() -> None:
            try:
                async for msg in ws:
                    self.connections[conn_id]["last_activity"] = time.time()
                    if msg.type == WSMsgType.TEXT:
                        try:
                            await self._handle_message(ws, conn_id, json.loads(msg.data))
                        except Exception as e:  # noqa: BLE001
                            logger.error(
                                "request_processing_error",
                                connection_id=conn_id,
                                error=str(e),
                            )
                            try:
                                # Best-effort reply: a client whose request died
                                # here (malformed JSON, handler error) must not
                                # hang awaiting a response that will never come.
                                await ws.send_json(
                                    {"type": "error", "message": f"Bad request: {e}"}
                                )
                            except Exception:  # noqa: BLE001 — socket already gone
                                pass
                    elif msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR, WSMsgType.CLOSING):
                        break
            except asyncio.CancelledError:
                pass

        async def send_audio() -> None:
            idle_limit = self.config.server.connection_timeout
            try:
                while True:
                    try:
                        chunk = await asyncio.wait_for(output_queue.get(), timeout=1.0)
                    except asyncio.TimeoutError:
                        # Idle-connection timeout (server.connection_timeout — present in
                        # the reference's config schema but never wired there, §5.6).
                        conn_state = self.connections.get(conn_id)
                        if conn_state is None:
                            # Teardown raced us (cancellation can surface as this
                            # TimeoutError inside wait_for): the connection is gone.
                            break
                        idle = time.time() - conn_state["last_activity"]
                        if idle_limit and idle > idle_limit:
                            logger.info("connection_idle_timeout", connection_id=conn_id)
                            await ws.close()
                            break
                        continue
                    self.connections[conn_id]["last_activity"] = time.time()
                    try:
                        if chunk.chunk_id == -1 and not chunk.is_final:
                            await ws.send_json({"type": "synthesis_started"})
                        elif chunk.chunk_id == -2 and not chunk.is_final:
                            await ws.send_json(
                                {
                                    "type": "error",
                                    "message": chunk.audio_data.decode("utf-8", "replace"),
                                }
                            )
                        elif not chunk.is_final:
                            if chunk.trace:
                                self.tracer.record("service.first_audio", chunk.trace.start, parent=chunk.trace)
                            await ws.send_bytes(chunk.audio_data)
                        else:
                            await ws.send_json(
                                {"type": "synthesis_complete", "chunk_id": chunk.chunk_id}
                            )
                    except (ConnectionResetError, RuntimeError):
                        break
                    except Exception as e:  # noqa: BLE001
                        logger.error("send_error", connection_id=conn_id, error=str(e))
                        break
            except asyncio.CancelledError:
                pass

        recv_task = asyncio.create_task(receive_requests())
        send_task = asyncio.create_task(send_audio())
        try:
            await asyncio.wait(
                [recv_task, send_task], return_when=asyncio.FIRST_COMPLETED
            )
        finally:
            # Cancellation of the pending task lives in the FINALLY: if this
            # handler itself is cancelled (server shutdown with live sockets,
            # aiohttp handler_cancellation), skipping it would leak both tasks
            # past the state teardown below — send_audio would then KeyError on
            # the popped connection entry and die as an unretrieved exception.
            for t in (recv_task, send_task):
                if not t.done():
                    t.cancel()
            await asyncio.gather(recv_task, send_task, return_exceptions=True)
            self.queue_manager.unregister_connection(conn_id)
            self.connections.pop(conn_id, None)
            self._cancel_generations.pop(conn_id, None)
            self._conn_seq_alloc.pop(conn_id, None)
            self._conn_seq_next.pop(conn_id, None)
            # Parked requests count as in_flight; release them or shutdown's
            # drain would wait the full timeout on a dead connection.
            await self._flush_dead_connection(conn_id)
            self.active_connections -= 1
            logger.info(
                "connection_closed",
                connection_id=conn_id,
                active_connections=self.active_connections,
            )

    async def _handle_message(
        self, ws, conn_id: str, data: dict
    ) -> None:
        mtype = data.get("type")
        if mtype == "synthesize":
            if self.is_draining or self.is_shutting_down:
                # Shutdown drain in progress: reject instead of admitting work the
                # worker cancellation would strand mid-request.
                await ws.send_json(
                    {"type": "error", "message": "Server shutting down"}
                )
                return
            fmt = str(
                data.get("format", self.config.encoding.default_format)
            ).lower()
            supported = encode_mod.available_formats(
                self.config.model.sample_rate,
                mp3_bitrate=self.config.encoding.mp3_bitrate,
                opus_bitrate=self.config.encoding.opus_bitrate,
            )
            if fmt not in supported:
                # Validate at admission — sample-rate aware (a codec library may
                # be present but reject this model's rate, e.g. opus at 22050 Hz):
                # a mid-stream encoder failure would cost the client a full
                # synthesis before learning the format is bad.
                await ws.send_json(
                    {
                        "type": "error",
                        "message": (
                            f"Unsupported format {fmt!r}; supported: "
                            + ", ".join(supported)
                        ),
                    }
                )
                return
            seq = self._conn_seq_alloc.get(conn_id, 0)
            self._conn_seq_alloc[conn_id] = seq + 1
            span = self.tracer.begin("service.request", request=(conn_id, seq))
            accepted = await self.queue_manager.enqueue_request(
                connection_id=conn_id,
                text=data.get("text", ""),
                timeout=self.config.queues.put_timeout_s,
                voice_id=data.get("voice_id", "default"),
                chunk_size=data.get("chunk_size", self.config.model.chunk_size),
                exaggeration=data.get(
                    "exaggeration", self.config.synthesis.default_exaggeration
                ),
                streaming=data.get("streaming", True),
                generation=self._cancel_generations.get(conn_id, 0),
                metadata=data.get("metadata", False),
                seq=seq,
                output_format=fmt,
                trace=span,
            )
            if not accepted:
                self.tracer.finish(span, dropped=1)
                # The slot was never admitted; don't let its seq hole stall later
                # requests (contiguous advance — never jumps past in-flight work).
                self._finish_seq(conn_id, seq)
                # The request was dropped at admission (input queue full for 2 s) —
                # a silent drop would leave the client awaiting audio forever.
                await ws.send_json(
                    {"type": "error", "message": "Server busy: request queue full"}
                )
        elif mtype == "register_voice":
            if not self.config.voice_cloning.enabled:
                await ws.send_json(
                    {"type": "error", "message": "Voice registration failed: voice cloning disabled"}
                )
                return
            voice_id = data.get("voice_id")
            reference_audio = data.get("reference_audio")
            if voice_id and reference_audio:
                span = self.tracer.begin("service.register_voice", request=(conn_id, None))
                try:
                    await self.register_voice(
                        voice_id, reference_audio, data.get("description", ""), data.get("reference_text"),
                    )
                    await ws.send_json({"type": "voice_registered", "voice_id": voice_id})
                except Exception as e:  # noqa: BLE001
                    await ws.send_json(
                        {"type": "error", "message": f"Voice registration failed: {e}"}
                    )
                self.tracer.finish(span)
            else:
                # Never leave the client awaiting voice_registered: missing or
                # empty fields must answer like every other invalid input here.
                await ws.send_json(
                    {
                        "type": "error",
                        "message": "Voice registration failed: voice_id and "
                        "reference_audio are required",
                    }
                )
        elif mtype == "list_voices":
            await ws.send_json(
                {"type": "voice_list", "voices": self.voice_manager.list_voices()}
            )
        elif mtype == "cancel":
            # Extension (README.md:137-146): drop queued/in-flight synthesis for this
            # connection; a confirmation is sent so clients can resynchronize.
            self._cancel_generations[conn_id] = self._cancel_generations.get(conn_id, 0) + 1
            await ws.send_json({"type": "cancelled"})

    async def register_voice(self, voice_id: str, reference_audio_b64: str, description: str = "",
                             reference_text: Optional[str] = None) -> str:
        """Validate and store a cloning reference (voice_manager), with its transcript
        where one is given; an F5 model needs the transcript. Raises ValueError."""
        if self.synthesizer.engine.f5 and not (reference_text or "").strip():
            raise ValueError("reference_text is required: the F5 model clones from a transcribed prompt")
        path = await self.voice_manager.register_voice(
            voice_id=voice_id, reference_audio_b64=reference_audio_b64, description=description,
            reference_text=reference_text,
        )
        self.voice_embeddings.invalidate(sanitize_voice_id(voice_id))
        return path

    # ------------------------------------------------------------ REST synthesis

    async def synthesize_full(
        self, text: str, voice_id: str = "default", exaggeration: float = 0.5
    ) -> np.ndarray:
        """Whole-utterance synthesis for the REST endpoint (segment → batch → concat)."""
        speaker = await self._resolve_speaker(voice_id)
        sentences = segment_text(text)
        if not sentences:
            return np.zeros((0,), np.float32)
        parts = await asyncio.gather(
            *[self.batcher.submit(s, speaker, exaggeration) for s in sentences]
        )
        return np.concatenate([p for p in parts if len(p)]) if parts else np.zeros((0,), np.float32)

    # ------------------------------------------------------------ health / metrics

    def health(self) -> Tuple[int, dict]:
        """(HTTP status, body) of `GET /health`: 503 until the model is loaded."""
        if not self.synthesizer.is_loaded:
            return 503, {"status": "unhealthy", "reason": "Model not loaded"}
        info = device_info(self.synthesizer.engine.device)
        dev_status = self.device_health.get("status", "unloaded")
        return 200, {
            "status": "healthy" if dev_status in ("ok", "unloaded") else "degraded",
            "device_health": self.device_health,
            "device": info["backend"],
            "active_connections": self.active_connections,
            "queue_metrics": self.queue_manager.get_metrics(),
            "synthesizer_stats": self.synthesizer.get_stats(),
            "voice_stats": self.voice_manager.get_stats(),
            "batcher_metrics": self.batcher.metrics if self.batcher else {},
            "tpu": info,
        }

    def metrics(self) -> dict:
        """Body of `GET /metrics`: the queue metrics as a JSON dict (the reference's
        behaviour)."""
        return self.queue_manager.get_metrics()

    def metrics_prometheus(self) -> str:
        """Body of `GET /metrics?format=prometheus`: Prometheus text exposition of the
        queue metrics, the batcher's and the engine's counters, the hand kernels'
        launches (`gonova_tts_kernel_launches_<wrapper>`), and one histogram of
        seconds per span name (`gonova_tts_span_seconds{span=...}`)."""
        lines = []
        for key, value in self.metrics().items():
            name = f"gonova_tts_{key}"
            kind = "counter" if key.startswith(("requests_", "chunks_")) else "gauge"
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {value}")
        if self.batcher:
            for key, value in self.batcher.metrics.items():
                lines.append(f"# TYPE gonova_tts_batcher_{key} counter")
                lines.append(f"gonova_tts_batcher_{key} {value}")
        stats = self.synthesizer.engine.stats
        for key in ("padded_tokens", "real_tokens", "vocode_frames_executed", "truncated_sentences",
                    "graph_passes", "eager_passes", "graphs_captured", "f5_real_frames", "f5_padded_frames",
                    "f5_prompt_frames", "f5_evaluations"):
            lines.append(f"# TYPE gonova_tts_engine_{key} {'gauge' if key == 'graphs_captured' else 'counter'}")
            lines.append(f"gonova_tts_engine_{key} {stats[key]}")
        for kernel, n in sorted(ops.launch_counts().items()):
            lines.append(f"# TYPE gonova_tts_kernel_launches_{kernel} counter")
            lines.append(f"gonova_tts_kernel_launches_{kernel} {n}")
        lines += self.tracer.prometheus()
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- aiohttp app


def aiohttp_web():
    """aiohttp's `web` module; only the HTTP app needs it."""
    try:
        from aiohttp import web
    except ImportError as e:
        raise ImportError(
            "the HTTP app needs aiohttp, which is not installed; TTSService itself "
            "runs without it (drive TTSService.handle_connection with any socket)"
        ) from e
    return web


async def websocket_endpoint(request):
    web = aiohttp_web()
    svc = request.app["service"]
    ws = web.WebSocketResponse(max_msg_size=64 * 1024 * 1024)
    await ws.prepare(request)

    client_ip = request.remote or "unknown"
    if not svc.rate_limiter.check(client_ip):
        await ws.close(code=WS_POLICY_VIOLATION, message=b"Rate limit exceeded")
        return ws
    if svc.active_connections >= svc.max_connections:
        await ws.close(code=WS_POLICY_VIOLATION, message=b"Max connections reached")
        return ws

    conn_id = str(uuid.uuid4())
    await svc.handle_connection(ws, conn_id)
    return ws


async def health_check(request):
    svc = request.app["service"]
    status, body = svc.health()
    return aiohttp_web().json_response(body, status=status)


async def metrics(request):
    """Queue metrics: a JSON dict by default, Prometheus text with
    `?format=prometheus`."""
    web = aiohttp_web()
    svc = request.app["service"]
    if request.query.get("format") == "prometheus":
        return web.Response(text=svc.metrics_prometheus(), content_type="text/plain")
    return web.json_response(svc.metrics())


async def rest_synthesize(request):
    """POST /v1/synthesize {text, voice_id?, exaggeration?,
    format?: pcm|wav|mp3|opus — defaults to encoding.default_format}."""
    web = aiohttp_web()
    svc = request.app["service"]
    if not svc.synthesizer.is_loaded:
        return web.json_response({"error": "Model not loaded"}, status=503)
    try:
        data = await request.json()
    except Exception:  # noqa: BLE001
        return web.json_response({"error": "Invalid JSON body"}, status=400)
    text = data.get("text", "")
    if not text.strip():
        return web.json_response({"error": "Missing 'text'"}, status=400)
    if svc.is_draining or svc.is_shutting_down:
        # Same rejection contract as the WS path: work admitted mid-drain is
        # invisible to the queue accounting and gets killed by batcher.stop().
        return web.json_response({"error": "Server shutting down"}, status=503)
    client_ip = request.remote or "unknown"
    if not svc.rate_limiter.check(client_ip):
        return web.json_response({"error": "Rate limit exceeded"}, status=429)

    # Same configured default as the WS path (encoding.default_format) so the two
    # entry points agree on what an unspecified format means.
    fmt = str(data.get("format", svc.config.encoding.default_format)).lower()
    sr = svc.config.model.sample_rate
    supported = encode_mod.available_formats(
        sr,
        mp3_bitrate=svc.config.encoding.mp3_bitrate,
        opus_bitrate=svc.config.encoding.opus_bitrate,
    )
    if fmt not in supported:
        # Sample-rate-aware admission: reject before synthesizing, not after.
        return web.json_response(
            {
                "error": f"Unsupported format {fmt!r}",
                "supported": supported,
            },
            status=400,
        )
    try:
        audio = await svc.synthesize_full(
            text,
            voice_id=data.get("voice_id", "default"),
            exaggeration=data.get("exaggeration", svc.config.synthesis.default_exaggeration),
        )
    except ValueError as exc:  # an F5 model with no voice to speak in
        return web.json_response({"error": str(exc)}, status=400)
    if fmt == "pcm":
        return web.Response(
            body=audio.astype(np.float32).tobytes(),
            content_type="application/octet-stream",
            headers={"X-Sample-Rate": str(sr)},
        )
    if fmt == "wav":
        # Exact-size RIFF (utils.write_wav): the REST payload is complete, so no
        # streaming-header convention is needed.
        buf = io.BytesIO()
        write_wav(buf, audio, sr)
        return web.Response(body=buf.getvalue(), content_type="audio/wav")
    try:
        enc = encode_mod.make_encoder(
            fmt, sr,
            mp3_bitrate=svc.config.encoding.mp3_bitrate,
            opus_bitrate=svc.config.encoding.opus_bitrate,
        )
    except encode_mod.EncoderUnavailable as exc:
        # Admission already probed this format; a codec library gone since then is
        # a client error response, never a 500.
        return web.json_response({"error": str(exc)}, status=400)
    body = enc.encode(audio) + enc.flush()
    return web.Response(body=body, content_type=encode_mod.content_type(fmt))


def create_app(config: Optional[Config] = None):
    """Build the aiohttp app; service start/stop tied to the app lifecycle. Raises
    ImportError when aiohttp is not installed."""
    web = aiohttp_web()
    service = TTSService(config)
    app = web.Application()
    # Handlers resolve the service from the app, so several apps in one process
    # (tests, embedding) never cross wires.
    app["service"] = service
    app.router.add_get("/v1/stream/tts", websocket_endpoint)
    if service.config.monitoring.enable_health_endpoint:
        app.router.add_get("/health", health_check)
    if service.config.monitoring.enable_metrics_endpoint:
        app.router.add_get("/metrics", metrics)
    app.router.add_post("/v1/synthesize", rest_synthesize)

    async def on_startup(app) -> None:
        await app["service"].start()

    async def on_shutdown(app) -> None:
        # aiohttp's run_app handles SIGTERM/SIGINT itself and fires on_shutdown
        # before closing connections; a signal handler of our own would shadow it
        # and leave the process alive after the service drained.
        if not app["service"].is_shutting_down:
            await app["service"].shutdown()

    app.on_startup.append(on_startup)
    app.on_shutdown.append(on_shutdown)
    return app


def main() -> None:
    port = int(os.getenv("TTS_PORT", "8002"))
    instance_id = os.getenv("TTS_INSTANCE_ID", "1")
    logger.info("starting_tts_server", port=port, instance_id=instance_id)
    config = load_config()
    config.server.port = port
    app = create_app(config)
    aiohttp_web().run_app(app, host=config.server.host, port=port)


if __name__ == "__main__":
    main()

"""StreamingSynthesizer — protocol-compatible facade over the port's engine.

Counterpart of `gonova_tts_tpu/service/synthesizer.py`, same surface. `device` is what
the engine is built on; left as `None` it is `config.model.device`, as `TTSEngine`
resolves it ("cuda" by default: without a card that raises, it never falls back).

Keeps the reference class surface (services/tts/core/synthesizer.py:102-429):
`load()`, async-generator `synthesize_streaming(text, voice_embedding, chunk_size,
exaggeration)`, `extract_voice_embedding`, `get_stats`, `cleanup`, `.is_loaded`,
`.sample_rate` — so callers written against the reference drop in unchanged.

Differences under the hood: `voice_embedding` accepts a WAV path (reference behavior)
or a precomputed speaker-embedding ndarray; blocking device work runs in the default
executor exactly like the reference's `_synthesize_sync` (synthesizer.py:312-318).
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import AsyncGenerator, Optional, Union

import numpy as np

from ..config import Config
from ..engine import TTSEngine
from ..utils import get_logger

logger = get_logger("gonova.synthesizer")


class StreamingSynthesizer:
    def __init__(
        self,
        config: Optional[Config] = None,
        model_path: Optional[str] = None,
        device: Optional[str] = None,
        device_index: int = 0,
        chunk_size: int = 50,
        sample_rate: int = 24000,
    ):
        self.config = config or Config()
        if model_path is not None:
            self.config.model.model_path = model_path
        self.device_index = device_index
        self.chunk_size = chunk_size  # accepted-but-unused, like the reference (:226)
        self.sample_rate = sample_rate
        self.engine = TTSEngine(self.config, device=device)
        self.device = self.engine.device

    @property
    def is_loaded(self) -> bool:
        return self.engine.is_loaded

    @property
    def stats(self) -> dict:
        return self.engine.stats

    async def load(self) -> None:
        """Load params + warm up the hot shapes (reference load+warmup analog)."""
        loop = asyncio.get_event_loop()
        await loop.run_in_executor(None, self.engine.load)
        logger.info("synthesizer_loaded")

    async def synthesize_streaming(
        self,
        text: str,
        voice_embedding: Optional[Union[str, np.ndarray]] = None,
        chunk_size: Optional[int] = None,  # kept for API compatibility, unused
        # 0.25 is the REFERENCE CLASS default (core/synthesizer.py:227), kept for
        # drop-in parity; the service layer passes config.synthesis
        # .default_exaggeration (0.5) explicitly, exactly like the reference's
        # server layer does (reference server.py:222).
        exaggeration: float = 0.25,
    ) -> AsyncGenerator[np.ndarray, None]:
        """Yield float32 audio chunks for `text` (sentence/window granularity)."""
        _ = chunk_size
        if not self.is_loaded:
            raise RuntimeError("Model not loaded. Call load() first")
        if not text.strip():
            return

        speaker = await self._resolve_speaker(voice_embedding)

        loop = asyncio.get_event_loop()
        queue: asyncio.Queue = asyncio.Queue(maxsize=64)
        _END = object()
        stop = threading.Event()

        def _put(item) -> bool:
            """Bounded cross-thread put that honors `stop` — a plain .result() would
            block the executor thread forever if the consumer is cancelled while
            the 64-slot queue is full (early client disconnect).

            The did-it-go-in signal is an explicit Event set right after
            queue.put returns (no suspension point in between, so a task
            cancellation can never land between insert and set): cancelling the
            chained concurrent future and re-reading its state can MISREPORT —
            cancel() can win the future-state race after put_nowait already
            inserted, and a retry would then duplicate the chunk in the stream.

            A stall deadline bounds an ABANDONED consumer (generator dropped
            without aclose and kept referenced): without it the producer would
            spin cancel/retry cycles forever, pinning a default-executor thread."""
            deadline = time.monotonic() + 120.0
            while not stop.is_set():
                inserted = threading.Event()

                async def _do_put():
                    await queue.put(item)
                    inserted.set()

                try:
                    fut = asyncio.run_coroutine_threadsafe(_do_put(), loop)
                except RuntimeError:  # loop closed
                    return False
                try:
                    fut.result(timeout=0.5)
                    return True
                except FuturesTimeoutError:
                    fut.cancel()
                    try:
                        # Settle: wait for the task to finish or unwind. The
                        # CancelledError is a BaseException on CPython >= 3.8.
                        fut.result(timeout=5.0)
                    except BaseException:  # noqa: BLE001 — cancelled or stuck
                        pass
                    if inserted.is_set():
                        return True
                    if time.monotonic() > deadline:
                        logger.warning("stream_consumer_stalled_dropping_producer")
                        return False
                    continue
                except BaseException:  # noqa: BLE001
                    return False
            return False

        def producer() -> None:
            try:
                for chunk in self.engine.synthesize_stream(
                    text, speaker=speaker, exaggeration=exaggeration
                ):
                    if not _put(chunk):
                        return  # consumer gone — closes the engine generator too
                _put(_END)
            except Exception as e:  # noqa: BLE001
                _put(e)

        task = loop.run_in_executor(None, producer)
        try:
            while True:
                item = await queue.get()
                if item is _END:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # Free a producer blocked on a full queue so `await task` can't hang.
            while not queue.empty():
                queue.get_nowait()
            await task

    async def _resolve_speaker(
        self, voice_embedding: Optional[Union[str, np.ndarray]]
    ) -> Optional[np.ndarray]:
        if voice_embedding is None:
            return None
        if isinstance(voice_embedding, np.ndarray):
            return voice_embedding
        loop = asyncio.get_event_loop()
        return await loop.run_in_executor(None, self.engine.embed_voice_file, voice_embedding)

    async def extract_voice_embedding(
        self, reference_audio: np.ndarray, sample_rate: int
    ) -> np.ndarray:
        """Reference audio array → speaker embedding (the reference's equivalent wrote a
        temp WAV and returned its path, synthesizer.py:361-409; we return the actual
        embedding)."""
        if not self.is_loaded:
            raise RuntimeError("Model not loaded")
        loop = asyncio.get_event_loop()
        return await loop.run_in_executor(
            None, self.engine.embed_voice, reference_audio, sample_rate
        )

    def get_stats(self) -> dict:
        return self.engine.get_stats()

    async def cleanup(self) -> None:
        self.engine.cleanup()
        logger.info("synthesizer_cleaned_up")

"""What every loop shares: a request, its result, the window, and the two ways into
the service that the loops call: `record_parts` (the served audio of each sentence
of a `synthesize_full` call) and `ws_request` (one WebSocket request over
`service.memory_socket.MemorySocket`). A request fails on an error frame or without
its final marker within its timeout. The loops themselves are `loops/<loop>.py`.
"""

from __future__ import annotations

import asyncio
import contextvars
import math
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .voices import Voice

@dataclass
class Request:
    text: str
    voice: Optional[int]  # index into the run's voices; None: the default voice
    at: float = 0.0  # open loop: seconds after the first arrival


_PARTS: contextvars.ContextVar = contextvars.ContextVar("tts_bench_parts", default=None)


@dataclass
class Result:
    request: Request
    index: int
    sent: float  # perf_counter at the scheduled send (open loop) or the call (closed)
    done: float = float("inf")
    first_audio: float = float("inf")
    failed: bool = False
    error: str = ""
    voice_id: str = "default"
    parts: List[np.ndarray] = field(default_factory=list)  # served audio per sentence (int16)
    part_done: List[float] = field(default_factory=list)  # when each sentence's audio came back
    late: float = 0.0  # how late the generator sent it
    sample_rate: int = 0  # of the served audio


def nearest_rank(values: List[float], q: float) -> float:
    """The q-quantile by nearest rank: the ceil(q * n)-th smallest value."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


@dataclass
class Window:
    start: float
    end: float
    results: List[Result]
    closed: bool  # a request belongs to the window by its return (else by its scheduled send)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def measured(self) -> List[Result]:
        """The window's requests: returned in it (closed loop), or due in it (open)."""
        key = (lambda r: r.done) if self.closed else (lambda r: r.sent)
        return [r for r in self.results if self.start <= key(r) < self.end]

    def audio_s(self) -> float:
        """Audio seconds of every sentence that came back in the window, of every
        request that did not fail: the work the window did."""
        return sum(len(p) / r.sample_rate for r in self.results if not r.failed
                   for p, t in zip(r.parts, r.part_done) if self.start <= t < self.end)

    def ttfa_ms(self) -> List[float]:
        return [(r.first_audio - r.sent) * 1e3 for r in self.measured]


def _i16(x: np.ndarray) -> np.ndarray:
    """Served float32 audio (int16 steps / 32768) kept as its int16 steps."""
    return np.rint(np.asarray(x, np.float32) * 32768.0).astype(np.int16)


def record_parts(svc) -> None:
    """Keep, per `synthesize_full` call, the served audio of each sentence and when
    it came back: the batcher's `submit` is wrapped to hand its result to the
    calling document."""
    submit = svc.batcher.submit

    async def wrapped(text, speaker=None, exaggeration=0.5):
        parts = _PARTS.get()
        slot = None
        if parts is not None:
            slot = len(parts)
            parts.append(None)
        audio = await submit(text, speaker, exaggeration)
        if parts is not None:
            parts[slot] = (audio, time.perf_counter())
        return audio

    svc.batcher.submit = wrapped


async def ws_request(svc, conn_id: str, voice_id: Optional[str], text: str, voice: Optional[Voice],
                     timeout: float, exaggeration: float = 0.5, res: Optional[Result] = None) -> Result:
    """One WebSocket request: optional `register_voice`, then one `synthesize`."""
    from gonova_tts_tpu_torch.service.memory_socket import MemorySocket

    res = res or Result(Request(text, None), -1, time.perf_counter(), sample_rate=svc.config.model.sample_rate)
    sent = res.sent
    ws = MemorySocket()
    conn = asyncio.create_task(svc.handle_connection(ws, conn_id))
    try:
        async with asyncio.timeout(max(0.0, sent + timeout - time.perf_counter())):
            if voice is not None:
                _, frames = await ws.request(
                    {"type": "register_voice", "voice_id": voice_id, "reference_audio": voice.b64},
                    until=("voice_registered", "error"),
                )
                if frames[-1][2].get("type") == "error":
                    raise RuntimeError(frames[-1][2].get("message", "register_voice failed"))
                res.voice_id = voice_id
            start = len(ws.frames)
            await ws.request({"type": "synthesize", "text": text, "voice_id": res.voice_id, "format": "pcm",
                              "exaggeration": exaggeration}, until=("synthesis_complete", "error"))
            for stamp, kind, payload in ws.frames[start:]:
                if kind == "binary":
                    res.first_audio = min(res.first_audio, stamp)
                    res.parts.append(_i16(np.frombuffer(payload, np.float32)))
                    res.part_done.append(stamp)
                elif payload.get("type") == "error":
                    raise RuntimeError(payload.get("message", "error frame"))
            res.done = time.perf_counter()
    except TimeoutError:
        res.failed, res.error = True, f"no final marker within {timeout} s"
    except RuntimeError as e:
        res.failed, res.error = True, str(e)
    finally:
        await ws.end()
        try:
            await asyncio.wait_for(conn, 30.0)
        except TimeoutError:
            conn.cancel()
    if res.failed:
        res.first_audio = res.done = float("inf")
    return res

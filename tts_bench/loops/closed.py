"""Closed loop over `TTSService.synthesize_full`, the method behind `POST
/synthesize`: `clients` callers, each sending its next document when the last one
returns. A document has `doc_sentences` sentences and one voice: the default for
`voices.default_share` of the documents, else one of the recordings at
`voices.rates_hz`, registered at set-up. A document belongs to the window if it
returned in it; a sentence's audio, if it came back in it.
"""

from __future__ import annotations

import asyncio
import time
from typing import Iterator, List, Optional

import numpy as np

from tts_bench.drive import Request, Result, Window, _i16, _PARTS, record_parts
from tts_bench.loadgen import Generator, Pool, order_rng, quantiles
from tts_bench.voices import Voice

WARM = "Quorvantel opened the door."


def voice_rates(mix: dict) -> List[int]:
    return mix["voices"]["rates_hz"]


def voice_id(req: Request, index: int) -> str:
    return "default" if req.voice is None else f"voice{req.voice}"


def requests(gen: Generator, mix: dict, seconds: float = 0.0) -> Iterator[Request]:
    """An endless stream of documents, each with one voice."""
    sizes = Pool(quantiles(mix["doc_sentences"], 64), order_rng(4))
    share = round(mix["voices"]["default_share"] * 64)
    n_voices = len(mix["voices"]["rates_hz"])
    voices = Pool(np.array([-1] * share + [i % n_voices for i in range(64 - share)]), order_rng(5))
    while True:
        v = int(voices.next())
        yield Request(gen.text(sizes.next()), None if v < 0 else v)


async def warm(svc, mix: dict, voices: List[Voice]) -> None:
    """Register each voice and speak once with it; then keep each sentence's audio."""
    for i, v in enumerate(voices):
        await svc.voice_manager.register_voice(f"voice{i}", v.b64)
        await svc.synthesize_full(WARM, voice_id=f"voice{i}")
    record_parts(svc)


def trace_at(gen: Generator, mix: dict, t0: float, w0: float, seconds: float) -> Optional[float]:
    return None


async def run(svc, gen: Generator, mix: dict, voices: List[Voice], t0: float, seconds: float) -> Window:
    docs = requests(gen, mix)
    results: List[Result] = []
    w0, w1 = t0 + mix["ramp_s"], t0 + mix["ramp_s"] + seconds
    counter = iter(range(1 << 62))
    sr = svc.config.model.sample_rate

    async def client() -> None:
        while time.perf_counter() < w1:
            req = next(docs)
            res = Result(req, next(counter), time.perf_counter(), voice_id=voice_id(req, 0), sample_rate=sr)
            parts: list = []
            token = _PARTS.set(parts)
            try:
                audio = await svc.synthesize_full(req.text, voice_id=res.voice_id, exaggeration=mix["exaggeration"])
                done = [p for p in parts if p is not None and len(p[0])]
                res.parts, res.part_done = [_i16(a) for a, _ in done], [t for _, t in done]
                if sum(len(p) for p in res.parts) != len(audio):
                    raise RuntimeError("the sentences do not add up to the document")
            except Exception as e:  # noqa: BLE001 — a failed call is counted, not fatal
                res.failed, res.error = True, f"{type(e).__name__}: {e}"
            finally:
                _PARTS.reset(token)
            res.done = res.first_audio = time.perf_counter()
            results.append(res)

    await asyncio.gather(*[client() for _ in range(mix["clients"])])
    return Window(w0, w1, results, closed=True)

"""Open loop over the WebSocket: requests at Poisson arrivals of `rate` a second.
Each request opens its own connection to `TTSService.handle_connection` over
`MemorySocket` at its scheduled time, registers its voice first where it clones one
(`clone_share` of the requests, recordings at `clone_rates_hz` in turn), sends one
`synthesize` message (pcm) of `sentences` sentences and reads to the final marker,
failing without it within `timeout_s` of its scheduled time. A request belongs to
the window if it was due in it. The gaps between arrivals are the exponential's
quantiles in one order for every seed (loadgen.py).
"""

from __future__ import annotations

import asyncio
import math
import time
from typing import Iterator, List, Optional

import numpy as np

from tts_bench.drive import Request, Result, Window, ws_request
from tts_bench.loadgen import Generator, Pool, order_rng, quantiles
from tts_bench.voices import Voice

WARM = "Quorvantel opened the door."


def voice_rates(mix: dict) -> List[int]:
    return mix["clone_rates_hz"]


def voice_id(req: Request, index: int) -> str:
    return "default" if req.voice is None else f"clone{index}"


def schedule(gen: Generator, mix: dict, seconds: float) -> List[Request]:
    """The requests due in `seconds`, at the mix's `rate`."""
    n = max(1, math.ceil(mix["rate"] * seconds))
    u = (np.arange(n) + 0.5) / n
    gaps = order_rng(6).permutation(-np.log1p(-u) / mix["rate"])
    at = np.cumsum(gaps) - gaps[0]
    sizes = Pool(quantiles(mix["sentences"], n), order_rng(7))
    cloned = set(order_rng(8).permutation(n)[: round(mix["clone_share"] * n)].tolist())
    n_bases = len(mix["clone_rates_hz"])
    out, k = [], 0
    for i in range(n):
        voice = None
        if i in cloned:
            voice, k = k % n_bases, k + 1
        out.append(Request(gen.text(sizes.next()), voice, float(at[i])))
    return [r for r in out if r.at < seconds]


def requests(gen: Generator, mix: dict, seconds: float = 60.0) -> Iterator[Request]:
    return iter(schedule(gen, mix, seconds))


async def warm(svc, mix: dict, voices: List[Voice]) -> None:
    """Clone a voice at each reference rate once and speak with it."""
    for sr in sorted({v.sr for v in voices}):
        v = next(x for x in voices if x.sr == sr)
        await ws_request(svc, f"warm{sr}", f"warm{sr}", WARM, v, timeout=60.0)


def trace_at(gen: Generator, mix: dict, t0: float, w0: float, seconds: float) -> Optional[float]:
    """Half a second before the first cloning request due after `trace_at_s`, so that
    the traced sub-window embeds a voice."""
    if not mix["clone_share"]:
        return None
    due = [t0 + r.at for r in schedule(Generator(mix, gen.seed), mix, mix["ramp_s"] + seconds) if r.voice is not None]
    due = [t for t in due if t >= w0 + min(mix["trace_at_s"], seconds / 3) + 0.5]
    return due[0] - 0.5 if due else None


async def run(svc, gen: Generator, mix: dict, voices: List[Voice], t0: float, seconds: float) -> Window:
    w0, w1 = t0 + mix["ramp_s"], t0 + mix["ramp_s"] + seconds
    sr = svc.config.model.sample_rate
    tasks = []
    for i, r in enumerate(schedule(gen, mix, mix["ramp_s"] + seconds)):
        due = t0 + r.at
        delay = due - time.perf_counter()
        if delay > 0:
            await asyncio.sleep(delay)
        res = Result(r, i, due, sample_rate=sr)
        res.late = time.perf_counter() - due
        voice = None if r.voice is None else voices[r.voice]
        tasks.append(asyncio.create_task(
            ws_request(svc, f"req{i}", voice_id(r, i), r.text, voice, mix["timeout_s"], mix["exaggeration"], res)))
    results = await asyncio.gather(*tasks)
    return Window(w0, w1, list(results), closed=False)

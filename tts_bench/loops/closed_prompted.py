"""closed.py's loop (documents of `doc_sentences` sentences from `clients` callers of
`TTSService.synthesize_full`) for a model that clones from a transcribed prompt:
each voice is registered through `TTSService.register_voice` with its recording and
the recording's transcript (prompts.py), then spoken once. Everything else is
closed.py's.
"""

from __future__ import annotations

from typing import List

from tts_bench import prompts, spec
from tts_bench.drive import record_parts
from tts_bench.voices import Voice

_closed = spec.module("loops", "closed")
voice_rates, voice_id, requests, trace_at, run = (
    _closed.voice_rates, _closed.voice_id, _closed.requests, _closed.trace_at, _closed.run)


async def warm(svc, mix: dict, voices: List[Voice]) -> None:
    """Register each voice with its transcript and speak once with it; then keep
    each sentence's audio."""
    for i, v in enumerate(voices):
        await svc.register_voice(f"voice{i}", v.b64, reference_text=prompts.transcript(v.wav))
        await svc.synthesize_full(_closed.WARM, voice_id=f"voice{i}")
    record_parts(svc)

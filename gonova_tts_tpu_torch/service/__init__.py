"""Service core of the port: synthesizer facade, queues, voices, rate limiting.

Own copies of the JAX package's `service/` modules (none of which imports JAX).
The aiohttp server (`service/server.py`) is not ported yet: ROADMAP.md.
"""

from .queue_manager import AudioChunk, SynthesisRequest, TTSQueueManager
from .rate_limiter import RateLimiter
from .synthesizer import StreamingSynthesizer
from .voice_manager import VoiceManager, sanitize_voice_id, validate_reference_audio

__all__ = [
    "AudioChunk",
    "SynthesisRequest",
    "TTSQueueManager",
    "RateLimiter",
    "StreamingSynthesizer",
    "VoiceManager",
    "sanitize_voice_id",
    "validate_reference_audio",
]

"""Service of the port: the WS/REST server's `TTSService`, synthesizer facade, queues,
voices, rate limiting.

Own copies of the JAX package's `service/` modules. Importing this package does not
import aiohttp: only `server.create_app` and its handlers need it.
"""

from .queue_manager import AudioChunk, SynthesisRequest, TTSQueueManager
from .rate_limiter import RateLimiter
from .server import TTSService
from .synthesizer import StreamingSynthesizer
from .voice_manager import VoiceManager, sanitize_voice_id, validate_reference_audio

__all__ = [
    "AudioChunk",
    "SynthesisRequest",
    "TTSQueueManager",
    "RateLimiter",
    "StreamingSynthesizer",
    "TTSService",
    "VoiceManager",
    "sanitize_voice_id",
    "validate_reference_audio",
]

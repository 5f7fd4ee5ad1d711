"""Host-side utilities of the port: WAV codec, structured logging, spans."""

from .jsonlog import get_logger
from .prof import Tracer
from .wavio import WavError, read_wav, write_wav

__all__ = ["Tracer", "WavError", "get_logger", "read_wav", "write_wav"]

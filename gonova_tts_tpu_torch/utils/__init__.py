"""Host-side utilities of the port: WAV codec, structured logging, timers."""

from .jsonlog import get_logger
from .prof import Timers
from .wavio import WavError, read_wav, write_wav

__all__ = ["Timers", "WavError", "get_logger", "read_wav", "write_wav"]

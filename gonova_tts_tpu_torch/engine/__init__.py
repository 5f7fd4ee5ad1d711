"""Serving engine of the port."""

from .engine import TTSEngine

__all__ = ["TTSEngine"]

"""Serving engine of the port: bucketed synthesis, dynamic batching, voice embeddings."""

from .batcher import DynamicBatcher
from .engine import TTSEngine
from .voice_cache import VoiceEmbeddingCache

__all__ = ["DynamicBatcher", "TTSEngine", "VoiceEmbeddingCache"]

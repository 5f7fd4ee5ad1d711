"""Speaker-embedding cache keyed by voice id.

The reference caches voice *file paths* in memory (services/tts/core/voice_manager.py:
63-64) and re-sends the WAV path to the model per request.  Here the expensive step is
the speaker-encoder pass, so the cache holds the computed embedding (the README's
aspirational `.pt` embedding cache, README.md:508-515, realized properly).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np


class VoiceEmbeddingCache:
    def __init__(self, max_entries: int = 100):
        self.max_entries = max_entries
        self._data: Dict[str, np.ndarray] = {}
        self._touched: Dict[str, float] = {}
        self._lock = threading.Lock()
        self.stats = {"hits": 0, "misses": 0, "evictions": 0}

    def get(self, voice_id: str) -> Optional[np.ndarray]:
        with self._lock:
            emb = self._data.get(voice_id)
            if emb is not None:
                self.stats["hits"] += 1
                self._touched[voice_id] = time.time()
            else:
                self.stats["misses"] += 1
            return emb

    def put(self, voice_id: str, embedding: np.ndarray) -> None:
        with self._lock:
            self._data[voice_id] = embedding
            self._touched[voice_id] = time.time()
            while len(self._data) > self.max_entries:
                oldest = min(self._touched, key=self._touched.get)
                del self._data[oldest]
                del self._touched[oldest]
                self.stats["evictions"] += 1

    def invalidate(self, voice_id: str) -> None:
        with self._lock:
            self._data.pop(voice_id, None)
            self._touched.pop(voice_id, None)

    def __len__(self) -> int:
        return len(self._data)

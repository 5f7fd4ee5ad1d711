"""Sliding-window per-client rate limiter (reference: services/tts/server.py:358-382)."""

from __future__ import annotations

import time
from typing import Dict, List


class RateLimiter:
    def __init__(self, max_requests: int = 100, window: float = 60.0):
        self.max_requests = max_requests
        self.window = window
        self._requests: Dict[str, List[float]] = {}

    def check(self, client_id: str) -> bool:
        """True if the client is allowed another request; records it if so."""
        now = time.time()
        history = [t for t in self._requests.get(client_id, []) if now - t < self.window]
        if len(history) >= self.max_requests:
            self._requests[client_id] = history
            return False
        history.append(now)
        self._requests[client_id] = history
        return True

    def prune(self) -> None:
        """Drop idle clients (unbounded-growth guard the reference lacks)."""
        now = time.time()
        for cid in list(self._requests):
            history = [t for t in self._requests[cid] if now - t < self.window]
            if history:
                self._requests[cid] = history
            else:
                del self._requests[cid]

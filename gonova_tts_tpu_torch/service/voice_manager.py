"""Voice registration/lookup with the reference's exact validation rules and layout.

Spec (reference: services/tts/core/voice_manager.py):
  * voice ids sanitized to [a-zA-Z0-9_-], ≤64 chars (:24-34);
  * registration: base64 WAV → decode → validate → persist voices/<id>.wav (:76-151);
  * validation: duration 3-10 s (:219-222), mean-square energy ≥ 0.01 (:225-227),
    peak < 0.99 (:230-231), p90/p10 amplitude ratio ≥ 5 (:234-237);
  * lookup memory → disk → None (:153-182); list via disk glob (:184-206);
  * LRU eviction of the oldest half beyond max_cached (:242-260);
  * stats: registrations / cache_hits / cache_misses + totals (:262-267);
  * a voice's transcript, where registration gives one, persists beside its WAV as
    voices/<id>.txt (a model that clones from a transcribed prompt reads it).

Uses the in-repo WAV codec (utils/wavio.py) — soundfile is not a dependency.
"""

from __future__ import annotations

import asyncio
import base64
import os
import re
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..utils import get_logger, read_wav
from ..utils import native
from ..utils.wavio import WavError

logger = get_logger("gonova.voices")

_VOICE_ID_RE = re.compile(r"[^a-zA-Z0-9_-]")


def sanitize_voice_id(voice_id: str) -> str:
    """Strip everything but [a-zA-Z0-9_-]; max 64 chars (path-traversal guard)."""
    sanitized = _VOICE_ID_RE.sub("", voice_id)
    if not sanitized:
        raise ValueError("Invalid voice_id: must contain alphanumeric characters")
    return sanitized[:64]


def validate_reference_audio(
    audio: np.ndarray,
    sr: int,
    min_duration: float = 3.0,
    max_duration: float = 10.0,
    min_snr: float = 5.0,
) -> dict:
    """Quality gate for cloning references; thresholds are the reference's."""
    duration = len(audio) / sr
    if duration < min_duration:
        return {"valid": False, "reason": f"Too short (minimum {min_duration:g} seconds)"}
    if duration > max_duration:
        return {"valid": False, "reason": f"Too long (maximum {max_duration:g} seconds)"}
    mean_sq, peak = native.audio_stats(np.asarray(audio, np.float32))
    if mean_sq < 0.01:
        return {"valid": False, "reason": "Audio too quiet"}
    if peak > 0.99:
        return {"valid": False, "reason": "Audio clipped (reduce volume)"}
    mag = np.abs(audio)
    noise_floor = float(np.percentile(mag, 10))
    signal_level = float(np.percentile(mag, 90))
    if signal_level / (noise_floor + 1e-6) < min_snr:
        return {"valid": False, "reason": "Too noisy (poor SNR)"}
    return {"valid": True, "reason": "OK"}


class VoiceManager:
    def __init__(self, cache_dir: str = "./voices", max_cached: int = 100,
                 min_duration: float = 3.0, max_duration: float = 10.0,
                 min_snr: float = 5.0):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.max_cached = max_cached
        self.min_duration = min_duration
        self.max_duration = max_duration
        self.min_snr = min_snr
        self.voice_cache: Dict[str, str] = {}
        self.voice_metadata: Dict[str, dict] = {}
        # Bumped on every (re-)registration: lets embedding-cache writers detect
        # that the file changed under them mid-embed and drop the stale result.
        self._generation: Dict[str, int] = {}
        self.stats = {"registrations": 0, "cache_hits": 0, "cache_misses": 0}
        logger.info("voice_manager_initialized", cache_dir=str(cache_dir))

    async def register_voice(
        self, voice_id: str, reference_audio_b64: str, description: str = "",
        reference_text: Optional[str] = None,
    ) -> str:
        """Validate + persist a cloning reference (and its transcript, if given).
        Returns the stored WAV path. Raises ValueError on bad id, undecodable audio,
        or failed quality gate."""
        safe_id = sanitize_voice_id(voice_id)

        def _decode_validate_persist():
            # CPU + disk work OFF the event loop: the WS endpoint admits payloads
            # up to 64 MB — decoding/validating inline would stall frame delivery
            # for every connected client on this single-core host.
            try:
                audio_bytes = base64.b64decode(reference_audio_b64)
            except Exception as e:
                raise ValueError(f"Invalid base64 audio: {e}") from e
            try:
                audio, sr = read_wav(audio_bytes)
            except WavError as e:
                raise ValueError(f"Invalid WAV payload: {e}") from e
            if audio.ndim > 1:
                audio = audio.mean(axis=1)
            verdict = validate_reference_audio(
                audio, sr, self.min_duration, self.max_duration, self.min_snr
            )
            if not verdict["valid"]:
                raise ValueError(f"Invalid reference audio: {verdict['reason']}")
            voice_path = self.cache_dir / f"{safe_id}.wav"
            # Atomic swap: concurrent executor-thread readers of the same path
            # (speaker-embedding resolution) must see either the old or the new
            # file, never a truncated in-place rewrite.
            tmp = voice_path.with_suffix(".wav.tmp")
            tmp.write_bytes(audio_bytes)
            text_path = voice_path.with_suffix(".txt")
            if reference_text:
                tmp_text = voice_path.with_suffix(".txt.tmp")
                tmp_text.write_text(reference_text, encoding="utf-8")
                os.replace(tmp_text, text_path)
            elif text_path.exists():
                text_path.unlink()  # a transcript of the old recording
            os.replace(tmp, voice_path)
            return voice_path, audio, sr

        loop = asyncio.get_event_loop()
        voice_path, audio, sr = await loop.run_in_executor(
            None, _decode_validate_persist
        )

        self._generation[safe_id] = self._generation.get(safe_id, 0) + 1
        self.voice_cache[safe_id] = str(voice_path)
        self.voice_metadata[safe_id] = {
            "description": description,
            "duration": len(audio) / sr,
            "sample_rate": sr,
            "path": str(voice_path),
            "created_at": time.time(),
        }
        if len(self.voice_cache) > self.max_cached:
            self._cleanup_cache()
        self.stats["registrations"] += 1
        logger.info("voice_registered", voice_id=safe_id, path=str(voice_path))
        return str(voice_path)

    async def get_voice(self, voice_id: str) -> Optional[str]:
        """Resolve a voice id to its stored WAV path (memory → disk → None)."""
        try:
            safe_id = sanitize_voice_id(voice_id)
        except ValueError:
            self.stats["cache_misses"] += 1
            return None
        # Cache is keyed by the sanitized id only (registration stores under safe_id);
        # two raw ids sanitizing to the same file share one entry.
        if safe_id in self.voice_cache:
            self.stats["cache_hits"] += 1
            return self.voice_cache[safe_id]
        voice_path = self.cache_dir / f"{safe_id}.wav"
        if voice_path.exists():
            self.voice_cache[safe_id] = str(voice_path)
            # Disk-found entries get real metadata too: without a created_at they
            # ranked as 0 in _cleanup_cache (always evicted first, regardless of
            # recency), and without the cleanup call the documented max_cached
            # bound never applied to lookup-heavy traffic.
            self.voice_metadata.setdefault(safe_id, {})["created_at"] = time.time()
            if len(self.voice_cache) > self.max_cached:
                self._cleanup_cache()
            self.stats["cache_hits"] += 1
            return str(voice_path)
        self.stats["cache_misses"] += 1
        logger.warning("voice_not_found", voice_id=voice_id)
        return None

    def get_reference_text(self, voice_id: str) -> Optional[str]:
        """The transcript registered with a voice, or None."""
        try:
            path = self.cache_dir / f"{sanitize_voice_id(voice_id)}.txt"
        except ValueError:
            return None
        return path.read_text(encoding="utf-8") if path.exists() else None

    def list_voices(self) -> list:
        voices = []
        for voice_file in sorted(self.cache_dir.glob("*.wav")):
            voice_id = voice_file.stem
            voices.append(
                {
                    "voice_id": voice_id,
                    "description": self.voice_metadata.get(voice_id, {}).get("description", ""),
                    "path": str(voice_file),
                    "is_cached": voice_id in self.voice_cache,
                }
            )
        return voices

    def _cleanup_cache(self) -> None:
        """Evict the oldest CACHED entries down to max_cached // 2 (reference policy).

        Ranks only ids still in voice_cache (ranking all metadata re-selects
        already-evicted ids and evicts nothing) and drops the metadata with the
        cache entry so neither structure grows without bound."""
        if len(self.voice_cache) <= self.max_cached:
            return
        to_remove = len(self.voice_cache) - (self.max_cached // 2)
        by_age = sorted(
            self.voice_cache,
            key=lambda vid: self.voice_metadata.get(vid, {}).get("created_at", 0),
        )
        for voice_id in by_age[:to_remove]:
            del self.voice_cache[voice_id]
            self.voice_metadata.pop(voice_id, None)
            logger.debug("voice_evicted", voice_id=voice_id)

    def generation_of(self, safe_id: str) -> int:
        """Registration generation for a sanitized id (0 = never re-registered
        this process). Embedding-cache writers snapshot this before embedding and
        skip the cache insert if it moved — otherwise an embed of the OLD file
        completing after a re-registration would permanently re-install the stale
        voice."""
        return self._generation.get(safe_id, 0)

    def get_stats(self) -> dict:
        stats = dict(self.stats)
        stats["total_voices"] = len(list(self.cache_dir.glob("*.wav")))
        stats["cached_in_memory"] = len(self.voice_cache)
        return stats

"""Host-side audio helpers in numpy.

Counterpart of `gonova_tts_tpu/utils/native.py`, which binds an optional C library
(`native/audio_runtime.cpp`) and falls back to numpy. The port keeps the numpy
forms only; loading the C library is queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def f32_to_i16(audio: np.ndarray) -> np.ndarray:
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    return (np.clip(audio, -1.0, 1.0) * 32767.0).round().astype(np.int16)


def i16_to_f32(pcm: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(pcm, dtype=np.int16).astype(np.float32) / 32768.0


def crossfade_join(a: np.ndarray, b: np.ndarray, overlap: int) -> np.ndarray:
    """Join two clips with an equal-power (cos^2 / sin^2) crossfade of `overlap`
    samples; returns length len(a) + len(b) - overlap."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    if len(a) == 0 or len(b) == 0:
        return np.concatenate([a, b])
    overlap = int(min(overlap, len(a), len(b)))
    if overlap <= 0:
        return np.concatenate([a, b])
    t = np.linspace(0.0, np.pi / 2, overlap, dtype=np.float32)
    seam = a[-overlap:] * np.cos(t) ** 2 + b[:overlap] * np.sin(t) ** 2
    return np.concatenate([a[:-overlap], seam, b[overlap:]])


def audio_stats(audio: np.ndarray) -> Tuple[float, float]:
    """(mean_square_energy, peak_abs): the voice-validation scan."""
    audio = np.ascontiguousarray(audio, np.float32)
    if audio.size == 0:
        return 0.0, 0.0  # np.mean of an empty array is nan
    return float(np.mean(np.square(audio))), float(np.max(np.abs(audio)))


def declick(audio: np.ndarray, n_fade: int = 64) -> np.ndarray:
    """Half-Hann fade-in/out. Mutates in place when the input is a writable
    contiguous float32 array (and returns it); otherwise works on a copy and
    returns that, so callers must use the return value."""
    audio = np.require(audio, np.float32, ["C", "W"])
    n_fade = min(n_fade, len(audio) // 2)
    if n_fade > 0:
        w = 0.5 - 0.5 * np.cos(np.pi * np.arange(n_fade) / n_fade)
        audio[:n_fade] *= w
        audio[-n_fade:] *= w[::-1]
    return audio

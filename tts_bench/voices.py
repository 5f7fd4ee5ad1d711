"""Reference recordings for voice cloning, made from the seed.

A voice is 10 s of speech-like sound: syllables of a harmonic source (an f0 drawn
per voice, with a slow glide) shaped by three formants drawn per syllable, under a
raised-cosine envelope, between short gaps and longer pauses with a faint noise
floor, at an RMS of 0.2 under a soft limit of 0.9. It passes the service's gate for
references (3-10 s, mean square at least 0.01, peak under 0.99, 90th over 10th
percentile of |x| at least 5).
"""

from __future__ import annotations

import base64
import io
import wave

import numpy as np

from .loadgen import rng_for


def speechlike(seed: int, index: int, sr: int, seconds: float = 10.0) -> np.ndarray:
    rng = rng_for(seed, 100, index)
    n = int(seconds * sr)
    out = rng.standard_normal(n) * 1e-3
    f0 = rng.uniform(90.0, 220.0)
    t = 0.05
    k = 0
    while t < seconds - 0.35:
        dur = rng.uniform(0.12, 0.3)
        i0, i1 = int(t * sr), int((t + dur) * sr)
        tt = np.arange(i1 - i0) / sr
        f = f0 * (1.0 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * tt + rng.uniform(0, 6.3)))
        phase = 2 * np.pi * np.cumsum(f) / sr
        formants = np.sort(rng.uniform([300, 900, 2000], [900, 2200, 3500]))
        harm = np.arange(1, int(min(4000.0, sr / 2 - 200) // f0) + 1)
        freqs = harm * f0
        amp = sum(np.exp(-0.5 * ((freqs - fc) / 120.0) ** 2) for fc in formants) + 0.05 / harm
        syl = (amp[:, None] * np.sin(harm[:, None] * phase[None, :])).sum(0)
        out[i0:i1] += syl * np.sin(np.pi * tt / dur) ** 2
        k += 1
        t += dur + (rng.uniform(0.4, 0.7) if k % 6 == 0 else rng.uniform(0.03, 0.15))
    out *= 0.2 / np.sqrt(np.mean(out**2))
    return (0.9 * np.tanh(out / 0.9)).astype(np.float32)


def wav_bytes(x: np.ndarray, sr: int) -> bytes:
    """PCM16 mono WAV of float samples."""
    pcm = np.clip(np.rint(x * 32767.0), -32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


class Voice:
    """One reference recording: its WAV bytes and the base64 the protocol carries."""

    def __init__(self, seed: int, index: int, sr: int):
        self.sr = sr
        self.wav = wav_bytes(speechlike(seed, index, sr), sr)
        self.b64 = base64.b64encode(self.wav).decode("ascii")

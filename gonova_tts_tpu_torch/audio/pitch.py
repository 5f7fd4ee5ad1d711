"""Frame-wise F0 estimation (unbiased-autocorrelation method, batched FFT).

The port's own copy of `gonova_tts_tpu/audio/pitch.py`: host-side numpy, used by
the training data pipeline (`train/data.py`) to build pitch targets; not on the
serving path.
"""

from __future__ import annotations

import numpy as np


def estimate_f0(
    audio: np.ndarray,
    sr: int = 24000,
    hop_length: int = 256,
    frame_length: int = 1024,
    fmin: float = 60.0,
    fmax: float = 500.0,
    threshold: float = 0.3,
) -> np.ndarray:
    """Per-frame F0 in Hz (0 = unvoiced). Output length = len(audio) // hop_length."""
    audio = np.asarray(audio, np.float64)
    n_frames = len(audio) // hop_length
    pad = frame_length // 2
    x = np.pad(audio, (pad, pad + frame_length))
    lag_min = max(2, int(sr / fmax))
    lag_max = min(frame_length - 1, int(sr / fmin))
    if lag_max < lag_min or n_frames == 0:
        return np.zeros(n_frames, np.float32)

    # All frames in ONE FFT batch (the per-frame Python loop dominated corpus
    # preprocessing wall time on single-core hosts).
    idx = np.arange(frame_length)[None, :] + np.arange(n_frames)[:, None] * hop_length
    fr = x[idx]
    fr = fr - fr.mean(axis=1, keepdims=True)
    energy = np.einsum("ij,ij->i", fr, fr)
    spec = np.fft.rfft(fr, n=2 * frame_length, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), axis=1)[:, : frame_length]
    # UNBIASED autocorrelation: ac[lag] sums (N - lag) products, so the raw
    # values carry an implicit (N - lag)/N taper that (a) tilts argmax toward
    # the half-period peak — octave-up errors for low-pitched voices with
    # strong 2nd harmonics — and (b) caps long-lag peaks below the voicing
    # threshold (a clean 60 Hz tone could never exceed 0.61 normalized).
    taper = (frame_length - np.arange(frame_length)).astype(np.float64)
    norm = ac * (frame_length / taper)[None, :] / (ac[:, :1] + 1e-12)

    seg = norm[:, lag_min : lag_max + 1]
    best = np.argmax(seg, axis=1)
    rows = np.arange(n_frames)
    peak = seg[rows, best]
    voiced = (peak >= threshold) & (energy >= 1e-8)

    # Parabolic interpolation around interior peaks for sub-sample lag
    # (skipped entirely when the lag-search window is too narrow to have an
    # interior point — seg[., bi+1] would index out of bounds).
    lag = (lag_min + best).astype(np.float64)
    if seg.shape[1] >= 3:
        interior = (best > 0) & (best < seg.shape[1] - 1)
        bi = np.where(interior, best, 1)  # safe index; masked below
        a, b, c = seg[rows, bi - 1], seg[rows, bi], seg[rows, bi + 1]
        denom = a - 2 * b + c
        ok = interior & (np.abs(denom) > 1e-12)
        lag = np.where(ok, lag + 0.5 * (a - c) / np.where(ok, denom, 1.0), lag)

    f0 = np.where(voiced, sr / lag, 0.0)
    return f0.astype(np.float32)


def f0_to_feature(f0: np.ndarray) -> np.ndarray:
    """Hz → normalized log-pitch feature (0 where unvoiced): log(f0/220)."""
    out = np.zeros_like(f0, np.float32)
    voiced = f0 > 1.0
    out[voiced] = np.log(f0[voiced] / 220.0)
    return out

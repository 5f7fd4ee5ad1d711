"""Window and inverse-DFT bases (numpy), as in `gonova_tts_tpu/audio/stft.py`.

Framing convention: periodic Hann, reflect pad (n_fft - hop) // 2, so a clip of
T samples (T % hop == 0) has exactly T // hop frames.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window / scipy 'hann', fftbins=True)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


@functools.lru_cache(maxsize=8)
def idft_bases(n_fft: int, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse real-DFT bases [n_fft // 2 + 1, n_fft]:
    irfft(R - iS)[n] = R @ icos[:, n] + S @ isin[:, n], with conjugate-symmetry weights."""
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    w = np.full((n_bins, 1), 2.0 / n_fft)
    w[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        w[-1] = 1.0 / n_fft
    return (np.cos(ang) * w).astype(dtype), (np.sin(ang) * w).astype(dtype)

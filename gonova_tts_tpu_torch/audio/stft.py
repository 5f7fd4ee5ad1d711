"""STFT as matmul-DFT in PyTorch, with the numpy window and DFT bases.

Counterpart of `gonova_tts_tpu/audio/stft.py`. Framing convention: periodic Hann,
reflect pad (n_fft - hop) // 2 on both sides, no centering, so a clip of T samples
(T % hop == 0) has exactly T // hop frames. The DFT is a pair of real matmuls
against cos/sin bases, the same bases the fused mel kernel folds its window into.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window / scipy 'hann', fftbins=True)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


@functools.lru_cache(maxsize=8)
def dft_bases(n_fft: int, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT bases: cos/sin matrices of shape [n_fft, n_fft // 2 + 1] such that
    rfft(x)[k] = x @ cos[:, k] - i * (x @ sin[:, k])."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


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


def _full_window(n_fft: int, win_length: int) -> np.ndarray:
    """The Hann window centred in n_fft samples (zero outside win_length)."""
    window = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def reflect_pad(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """[..., T] → [..., T + 2 * pad], pad = (n_fft - hop) // 2, reflected. Reflection
    needs T > pad: a shorter clip is zero-extended to pad + 1 samples first."""
    pad = (n_fft - hop_length) // 2
    if x.shape[-1] <= pad:
        x = F.pad(x, (0, pad + 1 - x.shape[-1]))
    lead = x.shape[:-1]
    return F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect").reshape(*lead, -1)


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Split [..., T] into overlapping frames [..., n_frames, n_fft] (a strided view
    of the reflect-padded signal); n_frames == T // hop_length for hop-aligned T."""
    return reflect_pad(x, n_fft, hop_length).unfold(-1, n_fft, hop_length)


def stft_ri(
    x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real/imag STFT of [..., T] → two tensors [..., n_frames, n_fft // 2 + 1]."""
    window = torch.as_tensor(_full_window(n_fft, win_length), device=x.device)
    frames = frame_signal(x, n_fft, hop_length) * window
    cos_b, sin_b = dft_bases(n_fft)
    real = frames @ torch.as_tensor(cos_b, device=x.device)
    imag = -(frames @ torch.as_tensor(sin_b, device=x.device))
    return real, imag


def spectrogram(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    power: float = 1.0,
    eps: float = 1e-9,
) -> torch.Tensor:
    """Magnitude (power=1) or power (power=2) spectrogram."""
    real, imag = stft_ri(x, n_fft, hop_length, win_length)
    sq = real * real + imag * imag
    if power == 2.0:
        return sq
    mag = torch.sqrt(torch.clamp(sq, min=eps))
    if power == 1.0:
        return mag
    return mag**power

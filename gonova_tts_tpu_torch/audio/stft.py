"""STFT as matmul-DFT in PyTorch, with the numpy window and DFT bases.

Counterpart of `gonova_tts_tpu/audio/stft.py`. Framing convention: periodic Hann,
reflect pad (n_fft - hop) // 2 on both sides, no centering, so a clip of T samples
(T % hop == 0) has exactly T // hop frames. The DFT is a pair of real matmuls
against cos/sin bases, the same bases the fused mel kernel folds its window into.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

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


def stft(
    x: torch.Tensor, n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024
) -> torch.Tensor:
    """Complex STFT [..., n_frames, n_fft // 2 + 1] (host-side convenience over
    :func:`stft_ri`)."""
    real, imag = stft_ri(x, n_fft, hop_length, win_length)
    return torch.complex(real, imag)


def istft(
    spec,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    length: Optional[int] = None,
) -> torch.Tensor:
    """Inverse STFT with windowed overlap-add, normalized by the summed squared
    window (clamped at 1e-8). Takes a complex tensor [..., n_frames, n_fft//2+1]
    or a (real, imag) tuple, and inverts :func:`stft`'s framing (reflect pad
    (n_fft - hop) // 2 each side)."""
    if isinstance(spec, tuple):
        real, imag = spec
    else:
        real, imag = spec.real, spec.imag
    dev = real.device
    icos, isin = idft_bases(n_fft)
    # stft_ri gives X = R + iI with I = -x @ sin; irfft needs R - i(-I).
    frames = real @ torch.as_tensor(icos, device=dev) + (-imag) @ torch.as_tensor(isin, device=dev)
    window_np = _full_window(n_fft, win_length)
    frames = frames * torch.as_tensor(window_np, device=dev)

    n_frames = frames.shape[-2]
    total = n_fft + (n_frames - 1) * hop_length
    batch_shape = frames.shape[:-2]
    flat = frames.reshape(-1, n_frames, n_fft)
    def overlap_add(fr):  # [N, n_frames, n_fft] → [N, total]: frame i at sample i * hop
        return F.fold(
            fr.transpose(1, 2), output_size=(1, total), kernel_size=(1, n_fft), stride=(1, hop_length)
        ).reshape(fr.shape[0], total)

    out = overlap_add(flat)
    win_sq = torch.as_tensor(window_np * window_np, device=dev)
    wsum = overlap_add(win_sq.expand(1, n_frames, n_fft))
    y = out / torch.clamp(wsum, min=1e-8)
    pad = (n_fft - hop_length) // 2
    y = y[:, pad : total - pad].reshape(*batch_shape, -1)
    if length is not None:
        y = y[..., :length]
    return y

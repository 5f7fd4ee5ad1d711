"""Fused log-mel spectrogram: hand-written CUDA kernel and its plain PyTorch version.

Replaces `gonova_tts_tpu/ops/mel_kernel.py` `mel_spectrogram_pallas` (the JAX
engine's voice-embedding mel under `EngineConfig.mel_pallas`). The kernel is
`csrc/mel_spectrogram.cu`; its source note says what bounds it on the H100 (the
two K = n_fft products in full f32: operations on the CUDA cores) and how its
design differs from the Pallas kernel's hop-row layout.

As in JAX the reflect pad happens here, before the kernel, and the Hann window is
folded into the cos/sin bases on the host in float64, then cast to f32.
`mel_spectrogram_plain` computes the same function in PyTorch with the same
staging: framed matmuls against the folded bases, clamp, sqrt, filterbank, clamp,
log. Every product is full f32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..audio.mel import mel_filterbank
from ..audio.stft import _full_window, dft_bases, reflect_pad
from . import counter

_COUNT = counter("mel_spectrogram")
# mel_spectrogram_forward(B, n_frames, Tp, hop, n_fft, n_bins, n_mels, eps,
#                         xp, wcos, wsin, fb, mag, out, stream)
_SIGNATURE = [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_void_p] * 7
_BASES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_FILTERBANKS: Dict[tuple, torch.Tensor] = {}


def folded_bases(n_fft: int, win_length: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window * cos, window * sin), each [n_fft, n_fft // 2 + 1] f32 on `device`:
    the product is taken in float64 and then cast, and cached per device."""
    key = (n_fft, win_length, str(device))
    if key not in _BASES:
        window = np.asarray(_full_window(n_fft, win_length), np.float64)
        cos_b, sin_b = dft_bases(n_fft)
        wcos = (window[:, None] * np.asarray(cos_b, np.float64)).astype(np.float32)
        wsin = (window[:, None] * np.asarray(sin_b, np.float64)).astype(np.float32)
        _BASES[key] = (torch.as_tensor(wcos, device=device), torch.as_tensor(wsin, device=device))
    return _BASES[key]


def _filterbank(sr, n_fft, n_mels, fmin, fmax, device) -> torch.Tensor:
    key = (sr, n_fft, n_mels, fmin, fmax, str(device))
    if key not in _FILTERBANKS:
        # mel_filterbank returns a transposed (column-major) array; the kernel reads rows.
        fb = np.ascontiguousarray(mel_filterbank(sr, n_fft, n_mels, fmin, fmax))
        _FILTERBANKS[key] = torch.as_tensor(fb, device=device)
    return _FILTERBANKS[key]


def _prepare(x: torch.Tensor, n_fft: int, hop_length: int):
    """→ (reflect-padded [B, Tp] f32 contiguous, n_frames, squeeze)."""
    if n_fft % hop_length != 0:
        raise ValueError("fused mel kernel requires n_fft % hop_length == 0")
    if x.ndim not in (1, 2):
        raise ValueError(f"mel_spectrogram takes [T] or [B, T] audio, got {tuple(x.shape)}")
    squeeze = x.ndim == 1
    x = x.float()[None] if squeeze else x.float()
    n_frames = x.shape[1] // hop_length
    return reflect_pad(x, n_fft, hop_length).contiguous(), n_frames, squeeze


def mel_spectrogram_plain(
    x: torch.Tensor,
    sr: int = 24000,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = 12000.0,
    eps: float = 1e-5,
) -> torch.Tensor:
    xp, n_frames, squeeze = _prepare(x, n_fft, hop_length)
    wcos, wsin = folded_bases(n_fft, win_length, x.device)
    frames = xp.unfold(-1, n_fft, hop_length)[:, :n_frames]
    real, imag = frames @ wcos, frames @ wsin
    mag = torch.sqrt(torch.clamp(real * real + imag * imag, min=1e-9))
    out = torch.log(torch.clamp(mag @ _filterbank(sr, n_fft, n_mels, fmin, fmax, x.device), min=eps))
    return out[0] if squeeze else out


def mel_spectrogram(
    x: torch.Tensor,
    sr: int = 24000,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = 12000.0,
    eps: float = 1e-5,
) -> torch.Tensor:
    """[T] or [B, T] audio → [T // hop, n_mels] or [B, T // hop, n_mels] f32 log-mel,
    any n_fft that hop divides. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if not x.is_cuda:
        return mel_spectrogram_plain(x, sr, n_fft, hop_length, win_length, n_mels, fmin, fmax, eps)
    return _launch(x, sr, n_fft, hop_length, win_length, n_mels, fmin, fmax, eps)


def _launch(x, sr, n_fft, hop_length, win_length, n_mels, fmin, fmax, eps):
    from . import _build

    xp, n_frames, squeeze = _prepare(x, n_fft, hop_length)
    if n_fft % 16:
        raise ValueError(f"mel_spectrogram kernel: n_fft={n_fft} must be a multiple of 16")
    b, tp = xp.shape
    n_bins = n_fft // 2 + 1
    wcos, wsin = folded_bases(n_fft, win_length, x.device)
    fb = _filterbank(sr, n_fft, n_mels, fmin, fmax, x.device)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=x.device)
    if n_frames:
        lib = _build.load("mel_spectrogram", {"mel_spectrogram_forward": _SIGNATURE})
        mag = torch.empty((b * n_frames, n_bins), dtype=torch.float32, device=x.device)
        p = _build.ptr
        rc = lib.mel_spectrogram_forward(
            b, n_frames, tp, hop_length, n_fft, n_bins, n_mels, float(eps),
            p(xp), p(wcos), p(wsin), p(fb), p(mag), p(out), _build.stream_ptr(x.device),
        )
        _build.check(lib, rc, "mel_spectrogram kernel")
        _COUNT.count += 1
    return out[0] if squeeze else out

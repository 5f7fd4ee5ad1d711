"""Mel filterbank and log-mel features in PyTorch.

Counterpart of `gonova_tts_tpu/audio/mel.py`: the plain (unfused) mel that the
fused kernel in `ops/mel_spectrogram.py` is held against. Slaney-style mel scale
with area normalization (the librosa.filters.mel defaults that HiFi-GAN-family
vocoders train against).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .stft import spectrogram


def hz_to_mel(f, htk: bool = False):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    safe_f = np.maximum(f, 1e-30)
    return np.where(f >= min_log_hz, min_log_mel + np.log(safe_f / min_log_hz) / logstep, mel)


def mel_to_hz(m, htk: bool = False):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freq = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freq)


@functools.lru_cache(maxsize=8)
def mel_filterbank(
    sr: int = 24000,
    n_fft: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = 12000.0,
    htk: bool = False,
    norm: str = "slaney",
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape [n_fft // 2 + 1, n_mels] (ready for frames @ fb)."""
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)

    fb = np.zeros((n_mels, n_bins), dtype=np.float64)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for m in range(n_mels):
        lower = -ramps[m] / fdiff[m]
        upper = ramps[m + 2] / fdiff[m + 1]
        fb[m] = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    return fb.T.astype(dtype)


def mel_spectrogram(
    x: torch.Tensor,
    sr: int = 24000,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: float | None = 12000.0,
    log: bool = True,
    eps: float = 1e-5,
) -> torch.Tensor:
    """[..., T] audio → [..., n_frames, n_mels] (natural-log-compressed by default,
    the HiFi-GAN convention: log(clamp(mel, eps)))."""
    mag = spectrogram(x, n_fft, hop_length, win_length, power=1.0)
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax), device=x.device)
    mel = mag @ fb
    if log:
        mel = torch.log(torch.clamp(mel, min=eps))
    return mel


def mel_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean-squared error between two log-mel tensors (the parity metric)."""
    return torch.mean((a - b) ** 2)


def mcd(a: torch.Tensor, b: torch.Tensor, n_coeffs: int = 13) -> torch.Tensor:
    """Mel-cepstral distortion (dB) between two log-mel tensors [..., T, n_mels].

    Standard MCD (Kubichek): c_i = sqrt(2/N) * DCT-II of the log-mel, drop c0,
    10/ln(10)*sqrt(2*sum((da-db)^2))."""
    n_mels = a.shape[-1]
    k = torch.arange(n_mels, device=a.device)
    basis = np.sqrt(2.0 / n_mels) * torch.cos(
        np.pi * torch.arange(n_coeffs, device=a.device)[:, None] * (2 * k[None, :] + 1) / (2 * n_mels)
    ).to(a.dtype)
    diff = ((a - b) @ basis.T)[..., 1:]  # drop c0 (overall energy)
    return torch.mean(10.0 / np.log(10.0) * torch.sqrt(2.0 * torch.sum(diff**2, dim=-1)))

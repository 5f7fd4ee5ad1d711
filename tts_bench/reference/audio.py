"""Plain audio functions of the reference: WAV decoding, rational resampling, the
log-mel analysis the speaker encoder reads, and the log-mel the comparison reads.

Written from their definitions with numpy, scipy and torch.fft:
  * resampling: upfirdn with a Kaiser-windowed sinc lowpass (cutoff at the lower
    Nyquist, half-length 64 * max(up, down) taps, beta 14.769656459379492), the
    filter centred so that output k falls at input time k * down / up, output
    length ceil(T * up / down);
  * log-mel: frames of n_fft samples every hop after a reflect pad of
    (n_fft - hop) / 2 on each side, a periodic Hann window, |rfft| floored at
    sqrt(1e-9), a Slaney-scale area-normalized triangular filterbank,
    log(max(mel, 1e-5)).
"""

from __future__ import annotations

import io
import math
import wave

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal


def read_wav(data: bytes):
    """(float32 samples in [-1, 1), [T] or [T, channels], sample rate) of PCM16 WAV bytes."""
    with wave.open(io.BytesIO(data), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError("only 16-bit PCM WAV is read")
        ch, sr = w.getnchannels(), w.getframerate()
        raw = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
    x = raw.astype(np.float32) / 32768.0
    return (x.reshape(-1, ch) if ch > 1 else x), sr


def resample(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """float64 rational resampling of a mono signal (see the module docstring)."""
    if orig_sr == new_sr:
        return np.asarray(x, np.float64)
    g = math.gcd(int(orig_sr), int(new_sr))
    up, down = new_sr // g, orig_sr // g
    rate = max(up, down)
    half = 64 * rate
    n = np.arange(-half, half + 1)
    h = (1.0 / rate) * np.sinc(n / rate) * np.kaiser(2 * half + 1, 14.769656459379492) * up
    t_out = -(-len(x) * up // down)
    # upfirdn's output m sits at upsampled time m * down - half (the filter's
    # centre); output k wants upsampled time k * down, so it is m = k + half / down.
    # Pad the front of the filter so that this shift is a whole number of outputs.
    pre = (-half) % down
    h = np.concatenate([np.zeros(pre), h])
    y = signal.upfirdn(h, np.asarray(x, np.float64), up, down)
    start = (half + pre) // down
    y = y[start : start + t_out]
    return np.pad(y, (0, t_out - len(y)))


def hann(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / n)).to(torch.float32).to(device)


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-30) / 1000.0) / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), m * (200.0 / 3))


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney triangular filters with area normalization, [n_fft // 2 + 1, n_mels]."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    lo, mid, hi = hz[:-2, None], hz[1:-1, None], hz[2:, None]
    fb = np.maximum(0.0, np.minimum((freqs - lo) / (mid - lo), (hi - freqs) / (hi - mid)))
    fb *= (2.0 / (hi - lo))
    return fb.T


def magnitudes(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[T] → |STFT| [T // hop, n_fft // 2 + 1] (float32)."""
    pad = (n_fft - hop) // 2
    xp = F.pad(x.reshape(1, 1, -1).float(), (pad, pad), mode="reflect").reshape(-1)
    frames = xp.unfold(0, n_fft, hop) * hann(n_fft, x.device)
    spec = torch.fft.rfft(frames, dim=-1)
    return torch.sqrt(torch.clamp(spec.real ** 2 + spec.imag ** 2, min=1e-9))


def log_mel(x: torch.Tensor, s: dict) -> torch.Tensor:
    """[T] audio → log-mel [frames, n_mels] with the model's analysis settings."""
    fb = torch.as_tensor(
        mel_filterbank(s["sample_rate"], s["n_fft"], s["n_mels"], s["fmin"], s["fmax"]),
        dtype=torch.float32, device=x.device,
    )
    return torch.log(torch.clamp(magnitudes(x, s["n_fft"], s["hop_length"]) @ fb, min=1e-5))

"""Fused log-mel spectrogram: hand-written CUDA kernel and its plain PyTorch version.

Replaces `gonova_tts_tpu/ops/mel_kernel.py` `mel_spectrogram_pallas` (the JAX
engine's voice-embedding mel under `EngineConfig.mel_pallas`). The kernel is
`csrc/mel_spectrogram.cu`, one launch per call; its source note says what bounds it
on the H100 (the two K = n_fft products at f32-grade accuracy: operations, on the
tensor cores as split TF32) and what its design does.

The Hann window is folded into the cos/sin bases on the host in float64, then cast
to f32 (`folded_bases`). For the kernel those bases are split into TF32 hi and lo
parts and laid out as the shared-memory image its wgmma reads (`split_tf32`,
`tf32_bases`); the
filterbank's band ranges are computed here too (`band_ranges`), and the reflect pad
is the kernel's own source index (`reflect_source` is its twin in Python). So the
kernel reads the unpadded audio and the wrapper allocates only the output.
`mel_spectrogram_plain` computes the same function in PyTorch with the plain
staging: reflect pad, framed matmuls against the folded bases, clamp, sqrt,
filterbank, clamp, log. Every product of the plain version is full f32.
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
# mel_spectrogram_forward(B, T, n_frames, hop, n_fft, n_bins, n_mels, eps,
#                         x, bases, fb, band, out, stream)
_SIGNATURE = [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_void_p] * 6
CLUSTER = 8  # blocks of a frame tile (csrc: mel::G)
BINS_PER_BLOCK = 72  # (csrc: mel::NB); CLUSTER * BINS_PER_BLOCK = 576 >= n_fft // 2 + 1
K_TILE = 32  # K per ring stage: one 128-byte swizzle row of TF32 (csrc: mel::KT)
_BASES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_TF32_BASES: Dict[tuple, torch.Tensor] = {}
_FILTERBANKS: Dict[tuple, torch.Tensor] = {}
_BANDS: Dict[tuple, torch.Tensor] = {}


def _folded_np(n_fft: int, win_length: int) -> Tuple[np.ndarray, np.ndarray]:
    window = np.asarray(_full_window(n_fft, win_length), np.float64)
    cos_b, sin_b = dft_bases(n_fft)
    wcos = (window[:, None] * np.asarray(cos_b, np.float64)).astype(np.float32)
    wsin = (window[:, None] * np.asarray(sin_b, np.float64)).astype(np.float32)
    return wcos, wsin


def folded_bases(n_fft: int, win_length: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window * cos, window * sin), each [n_fft, n_fft // 2 + 1] f32 on `device`:
    the product is taken in float64 and then cast, and cached per device."""
    key = (n_fft, win_length, str(device))
    if key not in _BASES:
        _BASES[key] = tuple(torch.as_tensor(w, device=device) for w in _folded_np(n_fft, win_length))
    return _BASES[key]


def split_tf32(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """f32 `w` → (hi, lo), both TF32 values (10 mantissa bits, the low 13 bits of the
    f32 pattern zero): hi = w rounded to nearest, ties away from zero (`cvt.rna`), and
    lo = (w - hi) rounded the same way; hi + lo is within 2^-21 |w| of w."""
    def rna(v):
        bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)

    hi = rna(w)
    return hi, rna(np.asarray(w, np.float32) - hi)


def tf32_bases(n_fft: int, win_length: int, device) -> torch.Tensor:
    """The folded bases as the kernel's ring holds them, cached per device: zero-padded
    to CLUSTER * BINS_PER_BLOCK bins, split into TF32 hi and lo, and cut per block
    (rank q, bins 72 q ..) and per K tile of 32 into the shared-memory image wgmma
    reads: [q][K tile][cos|sin][hi|lo][bin][32 k], K-major, each 128-byte row of a bin
    128-byte swizzled (16-byte chunk c of bin n stored at chunk c ^ (n % 8))."""
    key = (n_fft, win_length, str(device))
    if key not in _TF32_BASES:
        n_bins, nb = n_fft // 2 + 1, BINS_PER_BLOCK
        w = np.zeros((2, n_fft, CLUSTER * nb), np.float32)
        w[0, :, :n_bins], w[1, :, :n_bins] = _folded_np(n_fft, win_length)
        hi, lo = split_tf32(w)
        # [part, k = 32 kt + 4 c + e, n = 72 q + j] -> [q, kt, part, j, c, e]
        tiles = [v.reshape(2, n_fft // K_TILE, 8, 4, CLUSTER, nb).transpose(4, 1, 0, 5, 2, 3) for v in (hi, lo)]
        image = np.stack(tiles, axis=3)  # [q, kt, part, hi|lo, j, c, e]
        swz = np.arange(8)[None, :] ^ (np.arange(nb)[:, None] % 8)  # stored chunk c holds chunk c ^ (n % 8)
        image = np.take_along_axis(image, swz.reshape(1, 1, 1, 1, nb, 8, 1), axis=5)
        _TF32_BASES[key] = torch.as_tensor(np.ascontiguousarray(image).reshape(-1), device=device)
    return _TF32_BASES[key]


def _filterbank_np(sr, n_fft, n_mels, fmin, fmax) -> np.ndarray:
    # mel_filterbank returns a transposed (column-major) array; the kernel reads rows.
    return np.ascontiguousarray(mel_filterbank(sr, n_fft, n_mels, fmin, fmax))


def _filterbank(sr, n_fft, n_mels, fmin, fmax, device) -> torch.Tensor:
    key = (sr, n_fft, n_mels, fmin, fmax, str(device))
    if key not in _FILTERBANKS:
        _FILTERBANKS[key] = torch.as_tensor(_filterbank_np(sr, n_fft, n_mels, fmin, fmax), device=device)
    return _FILTERBANKS[key]


def band_ranges(fb: np.ndarray) -> np.ndarray:
    """[2, n_mels] int32: for each band of `fb` [n_bins, n_mels], the bins [lo, hi)
    from its first to its last nonzero weight ([0, 0) for an empty band)."""
    nz = np.asarray(fb) != 0
    n_bins = nz.shape[0]
    any_nz = nz.any(axis=0)
    lo = np.where(any_nz, nz.argmax(axis=0), 0)
    hi = np.where(any_nz, n_bins - nz[::-1].argmax(axis=0), 0)
    return np.stack([lo, hi]).astype(np.int32)


def _bands(sr, n_fft, n_mels, fmin, fmax, device) -> torch.Tensor:
    key = (sr, n_fft, n_mels, fmin, fmax, str(device))
    if key not in _BANDS:
        _BANDS[key] = torch.as_tensor(band_ranges(_filterbank_np(sr, n_fft, n_mels, fmin, fmax)), device=device)
    return _BANDS[key]


def reflect_source(positions: np.ndarray, t: int, n_fft: int, hop_length: int) -> np.ndarray:
    """The kernel's reflect pad as an index: for positions of the padded signal, the
    sample of the [T] clip each reads, or -1 for a zero (a clip no longer than the
    pad is zero-extended to pad + 1 samples first, as `reflect_pad` does)."""
    pad = (n_fft - hop_length) // 2
    te = max(t, pad + 1)
    i = np.abs(np.asarray(positions) - pad)
    i = np.where(i >= te, 2 * te - 2 - i, i)
    return np.where(i < t, i, -1)


def _as_batch(x: torch.Tensor, n_fft: int, hop_length: int):
    """The framing rule and shapes both versions take: → ([B, T] f32, squeeze)."""
    if n_fft % hop_length != 0:
        raise ValueError("fused mel kernel requires n_fft % hop_length == 0")
    if x.ndim not in (1, 2):
        raise ValueError(f"mel_spectrogram takes [T] or [B, T] audio, got {tuple(x.shape)}")
    squeeze = x.ndim == 1
    return (x[None] if squeeze else x).float(), squeeze


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
    x, squeeze = _as_batch(x, n_fft, hop_length)
    n_frames = x.shape[1] // hop_length
    wcos, wsin = folded_bases(n_fft, win_length, x.device)
    frames = reflect_pad(x, n_fft, hop_length).contiguous().unfold(-1, n_fft, hop_length)[:, :n_frames]
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
    n_fft a multiple of hop. CPU tensors take the plain version; CUDA tensors launch
    the kernel, which also needs hop a multiple of 8 and n_fft a multiple of 64 with
    n_fft // 2 + 1 <= 576 bins (so n_fft <= 1088), and raises otherwise."""
    if not x.is_cuda:
        return mel_spectrogram_plain(x, sr, n_fft, hop_length, win_length, n_mels, fmin, fmax, eps)
    return _launch(x, sr, n_fft, hop_length, win_length, n_mels, fmin, fmax, eps)


def _launch(x, sr, n_fft, hop_length, win_length, n_mels, fmin, fmax, eps):
    from . import _build

    x, squeeze = _as_batch(x, n_fft, hop_length)
    n_bins = n_fft // 2 + 1
    if hop_length % 8 or n_fft % (2 * K_TILE) or n_bins > CLUSTER * BINS_PER_BLOCK:
        raise ValueError(f"mel_spectrogram kernel: hop={hop_length} must be a multiple of 8, n_fft={n_fft} "
                         f"a multiple of {2 * K_TILE} and at most {2 * CLUSTER * BINS_PER_BLOCK - 2}")
    x = x.contiguous()
    b, t = x.shape
    n_frames = t // hop_length
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=x.device)
    if n_frames:
        lib = _build.load("mel_spectrogram", {"mel_spectrogram_forward": _SIGNATURE})
        bases = tf32_bases(n_fft, win_length, x.device)
        fb = _filterbank(sr, n_fft, n_mels, fmin, fmax, x.device)
        band = _bands(sr, n_fft, n_mels, fmin, fmax, x.device)
        p = _build.ptr
        with _build.launch_on(x.device) as stream:
            rc = lib.mel_spectrogram_forward(
                b, t, n_frames, hop_length, n_fft, n_bins, n_mels, float(eps),
                p(x), p(bases), p(fb), p(band), p(out), stream,
            )
        _build.check(lib, rc, "mel_spectrogram kernel")
        _COUNT.count += 1
    return out[0] if squeeze else out

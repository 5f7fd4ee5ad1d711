"""Polyphase sample-rate conversion in PyTorch.

Counterpart of `gonova_tts_tpu/audio/resample.py`, which is one convolution with
input dilation `up` and stride `down` (upfirdn: zero-stuff, FIR, decimate).
`conv1d` has no input dilation, and zero-stuffing 10 s at 44.1 kHz → 24 kHz
(up 80) would make a 35 M-sample signal of which 79 in 80 are zeros. This module
computes the same samples in polyphase form: output k = q * up + r only meets
the taps j = m * up + half - r * down, so phase r is a short FIR over the input
with stride `down`, and all `up` phases are the output channels of one `conv1d`:

    y[q * up + r] = sum_m x[q * down + m] * taps_flipped[m * up + half - r * down]

Taps, alignment (filter centred, output k at input time k * down / up) and the
output length ceil(T * up / down) are the JAX module's.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def _kaiser_sinc_filter(up: int, down: int, width_mult: int = 64, beta: float = 14.769656459379492) -> np.ndarray:
    """Kaiser-windowed sinc lowpass for rational resampling (scipy resample_poly defaults)."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate  # normalized cutoff (Nyquist of the lower rate)
    half_len = width_mult * max_rate
    n = np.arange(-half_len, half_len + 1)
    taps = f_c * np.sinc(f_c * n) * np.kaiser(2 * half_len + 1, beta)
    return (taps * up).astype(np.float64)


@functools.lru_cache(maxsize=32)
def _polyphase_bank(up: int, down: int) -> Tuple[np.ndarray, int]:
    """(bank [up, width] float32, m_min): bank[r, m - m_min] is the flipped tap that
    input sample q * down + m contributes to output q * up + r; zero where the tap
    index falls outside the filter."""
    flipped = _kaiser_sinc_filter(up, down)[::-1]
    n_taps = len(flipped)
    half = (n_taps - 1) // 2
    m_min = -(half // up)  # ceil(-half / up), phase 0
    m_max = (n_taps - 1 - half + (up - 1) * down) // up
    m = np.arange(m_min, m_max + 1)[None, :]
    r = np.arange(up)[:, None]
    j = m * up + half - r * down
    valid = (j >= 0) & (j < n_taps)
    bank = np.where(valid, flipped[np.clip(j, 0, n_taps - 1)], 0.0)
    return bank.astype(np.float32), m_min


def resample(x: torch.Tensor, orig_sr: int, new_sr: int, dtype=torch.float32) -> torch.Tensor:
    """Resample [..., T] from orig_sr to new_sr on x's device. Output length =
    ceil(T * new / orig)."""
    x = torch.as_tensor(x).to(dtype)
    if orig_sr == new_sr:
        return x
    g = math.gcd(int(orig_sr), int(new_sr))
    up, down = new_sr // g, orig_sr // g
    bank_np, m_min = _polyphase_bank(up, down)
    width = bank_np.shape[1]
    bank = torch.as_tensor(bank_np, device=x.device).to(dtype)[:, None, :]  # [up, 1, width]

    batch_shape = x.shape[:-1]
    t_in = x.shape[-1]
    t_out = -(-t_in * up // down)  # ceil
    n_q = -(-t_out // up)
    # Window q reads x[q * down + m_min : q * down + m_min + width]; zeros outside x.
    pad_l = -m_min
    pad_r = max(0, (n_q - 1) * down + width - pad_l - t_in)
    x2 = F.pad(x.reshape(-1, 1, t_in), (pad_l, pad_r))
    y = F.conv1d(x2, bank, stride=down)[..., :n_q]  # [N, up, n_q]
    y = y.transpose(1, 2).reshape(-1, n_q * up)[:, :t_out]
    return y.reshape(batch_shape + (t_out,))


def resample_np(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Host-side convenience wrapper (numpy in, numpy out, on the CPU)."""
    return resample(torch.as_tensor(np.asarray(x, np.float32)), orig_sr, new_sr).numpy()

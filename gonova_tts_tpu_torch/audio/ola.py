"""Crossfade / overlap-add utilities for chunked streaming synthesis.

The port's counterpart of `gonova_tts_tpu/audio/ola.py`: `crossfade_pair` on torch
tensors with the same equal-power (cos²/sin²) fades, `stitch` and `hann_fade` on
numpy. The CLI's `synth` joins its streamed sentences with `stitch`.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def crossfade_pair(a: torch.Tensor, b: torch.Tensor, overlap: int) -> torch.Tensor:
    """Join a and b along the last axis with an equal-power (sin^2/cos^2) crossfade of
    `overlap` samples. Returns length a + b - overlap."""
    if overlap <= 0:
        return torch.cat([a, b], dim=-1)
    t = torch.linspace(0.0, np.pi / 2, overlap, dtype=a.dtype, device=a.device)
    fade_out = torch.cos(t) ** 2
    fade_in = torch.sin(t) ** 2
    head = a[..., :-overlap]
    seam = a[..., -overlap:] * fade_out + b[..., :overlap] * fade_in
    tail = b[..., overlap:]
    return torch.cat([head, seam, tail], dim=-1)


def stitch(chunks: List[np.ndarray], overlap: int = 0) -> np.ndarray:
    """Host-side long-form stitcher: crossfade-join a list of 1-D float32 clips."""
    chunks = [np.asarray(c, dtype=np.float32) for c in chunks if len(c) > 0]
    if not chunks:
        return np.zeros((0,), dtype=np.float32)
    out = chunks[0]
    if overlap <= 0:
        return np.concatenate(chunks)
    ramps = {}
    for c in chunks[1:]:
        ov = min(overlap, len(out), len(c))
        if ov == 0:
            out = np.concatenate([out, c])
            continue
        if ov not in ramps:
            # Full ramps at length ov: slicing a longer ramp (fade_out[-ov:] with
            # fade_in[:ov]) selects the near-zero tails of both and the seam dips
            # to silence instead of summing to unity.
            t = np.linspace(0.0, np.pi / 2, ov, dtype=np.float32)
            ramps[ov] = (np.cos(t) ** 2, np.sin(t) ** 2)
        fade_out, fade_in = ramps[ov]
        seam = out[-ov:] * fade_out + c[:ov] * fade_in
        out = np.concatenate([out[:-ov], seam, c[ov:]])
    return out


def hann_fade(n: int, dtype=np.float32) -> np.ndarray:
    """Half-Hann ramp of length n (fade-in; reverse for fade-out)."""
    return (0.5 - 0.5 * np.cos(np.pi * np.arange(n) / max(n - 1, 1))).astype(dtype)

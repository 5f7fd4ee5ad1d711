"""End-to-end text frontend: raw text → padded token id arrays.

Pipeline: normalize → (optionally segment) → G2P → tokenize → bucket-pad.
This is the host-side stage of the engine; everything downstream is jit-compiled.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import g2p, normalize, segment, symbols

# Stress-marked tokenization is a frontend-wide mode, not a per-call choice: the
# token stream must match what the served acoustic checkpoint was trained on
# (stressed ids are appended to the symbol table, so pre-stress checkpoints have
# no trained embeddings for them). Default off; enable via TTS_STRESS=1 or
# set_stress(True) when serving/ training a stress-aware model.
_STRESS_ENABLED = os.environ.get("TTS_STRESS", "0") == "1"


def set_stress(enabled: bool) -> None:
    global _STRESS_ENABLED
    _STRESS_ENABLED = bool(enabled)


def stress_enabled() -> bool:
    return _STRESS_ENABLED


def text_to_ids(
    text: str, add_bos_eos: bool = True, with_stress: Optional[bool] = None
) -> List[int]:
    """Raw text → phoneme token ids (single chunk; no segmentation)."""
    norm = normalize.normalize_text(text)
    if with_stress is None:
        with_stress = _STRESS_ENABLED
    phones = g2p.text_to_phonemes(norm, with_stress=with_stress)
    return symbols.encode(phones, add_bos_eos=add_bos_eos)


def segment_text(text: str, max_chars: int = 150) -> List[str]:
    """Reference-semantics sentence segmentation (see segment.py)."""
    return segment.split_into_sentences(text, max_chars=max_chars)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits `length`; the largest bucket if none do (inputs are
    hard-wrapped upstream so this is a backstop, not truncation in the common path)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def pad_to_bucket(
    ids: Sequence[int], buckets: Sequence[int]
) -> Tuple[np.ndarray, int, int]:
    """Token ids → (padded int32 array of bucket size, true length, bucket)."""
    bucket = pick_bucket(len(ids), buckets)
    ids = list(ids)[:bucket]
    arr = np.full((bucket,), symbols.PAD_ID, dtype=np.int32)
    arr[: len(ids)] = ids
    return arr, len(ids), bucket


def batch_to_bucket(
    id_lists: Sequence[Sequence[int]], buckets: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad a batch of token id lists into one [B, bucket] array (shared bucket =
    the one fitting the longest member). Returns (tokens, lengths, bucket)."""
    longest = max(len(ids) for ids in id_lists)
    bucket = pick_bucket(longest, buckets)
    batch = np.full((len(id_lists), bucket), symbols.PAD_ID, dtype=np.int32)
    lengths = np.zeros((len(id_lists),), dtype=np.int32)
    for i, ids in enumerate(id_lists):
        ids = list(ids)[:bucket]
        batch[i, : len(ids)] = ids
        lengths[i] = len(ids)
    return batch, lengths, bucket

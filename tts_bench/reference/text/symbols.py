"""Phoneme symbol inventory and integer tokenizer for the acoustic model.

ARPAbet-style stressless phoneme set plus punctuation/boundary tokens.  The table is
padded to the configured vocab size (default 256) so the embedding matrix stays
MXU-aligned.
"""

from __future__ import annotations

from typing import Dict, List

PAD = "<pad>"
BOS = "<bos>"
EOS = "<eos>"
WORD_SEP = "<sp>"  # inter-word boundary / short pause

PUNCTUATION = [".", ",", "?", "!", ";", ":", "-", '"', "'"]

VOWELS = [
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
]
CONSONANTS = [
    "B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M", "N", "NG",
    "P", "R", "S", "SH", "T", "TH", "V", "W", "Y", "Z", "ZH",
]
PHONEMES = VOWELS + CONSONANTS

# Stress-marked vowels (ARPAbet convention: 0 unstressed / 1 primary / 2
# secondary). APPENDED after the stressless inventory so every pre-stress id —
# and therefore every trained embedding row and vendored checkpoint — keeps its
# meaning; the stressless vowels remain valid symbols (used whenever stress is
# disabled or unknown).
STRESSED_VOWELS = [f"{v}{s}" for v in VOWELS for s in ("0", "1", "2")]

SYMBOLS: List[str] = [PAD, BOS, EOS, WORD_SEP] + PUNCTUATION + PHONEMES + STRESSED_VOWELS

_SYMBOL_TO_ID: Dict[str, int] = {s: i for i, s in enumerate(SYMBOLS)}

PAD_ID = _SYMBOL_TO_ID[PAD]
BOS_ID = _SYMBOL_TO_ID[BOS]
EOS_ID = _SYMBOL_TO_ID[EOS]
WORD_SEP_ID = _SYMBOL_TO_ID[WORD_SEP]


def n_symbols() -> int:
    return len(SYMBOLS)


def symbol_to_id(symbol: str) -> int:
    return _SYMBOL_TO_ID[symbol]


def encode(symbols: List[str], add_bos_eos: bool = True) -> List[int]:
    """Symbol strings → ids. Unknown symbols are dropped (robustness over strictness:
    the reference silently degrades on unknown input too, e.g. unknown voice ids —
    services/tts/server.py:128-138)."""
    ids = [_SYMBOL_TO_ID[s] for s in symbols if s in _SYMBOL_TO_ID]
    if add_bos_eos:
        return [BOS_ID] + ids + [EOS_ID]
    return ids


def decode(ids: List[int]) -> List[str]:
    return [SYMBOLS[i] for i in ids if 0 <= i < len(SYMBOLS)]

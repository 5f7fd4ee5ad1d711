"""Characters as F5-TTS reads them: one id per character, no phonemes.

F5-TTS maps each character of `ref_text + gen_text` through its `vocab.txt`
(`list_str_to_idx`: an unknown character is 0). That file (2,545 symbols, pinyin
included) is not in the repository, so the map here covers the characters the
port's normalizer emits for English: printable ASCII, in code-point order from the
space (0) to "~" (94), which is the order the published file opens with. Any other
character is 0, the space.

    text = normalize_text(sentence)          # what the model reads
    ids = char_ids(with_stop(transcript) + text)
"""

from __future__ import annotations

from typing import List

from .normalize import normalize_text

SYMBOLS = [chr(c) for c in range(32, 127)]
_ID = {c: i for i, c in enumerate(SYMBOLS)}


def char_ids(text: str) -> List[int]:
    return [_ID.get(c, 0) for c in text]


def with_stop(ref_text: str) -> str:
    """F5-TTS's rule for a prompt's transcript: it ends in ". " (a final "." gains
    the space, anything else gains ". "); one that ends in ". " or "。" is kept."""
    if ref_text.endswith(". ") or ref_text.endswith("。"):
        return ref_text
    return ref_text + (" " if ref_text.endswith(".") else ". ")


def read_text(sentence: str) -> str:
    """A sentence as the model reads it: the port's normalized text."""
    return normalize_text(sentence)

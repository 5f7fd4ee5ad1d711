"""Sentence segmentation with the reference's semantics plus an abbreviation guard.

Reproduces services/tts/core/synthesizer.py:48-99 behavior (regex fallback path — the
spaCy path is an optional accuracy upgrade there, and spaCy is not in this image):

  1. split on whitespace following `.`/`!`/`?` when the next char is uppercase,
  2. any sentence longer than `max_chars` is re-split on `[,;]\\s+` and greedily
     re-merged into chunks of at most `max_chars`, joined with ", ".

Chunks longer than `max_chars` with no comma/semicolon are kept whole, as in the
reference.  An extra hard-wrap pass (`hard_max_chars`) is our TPU extension: the engine's
largest token bucket is finite, so pathological unpunctuated inputs are wrapped on word
boundaries instead of overflowing the bucket. Set hard_max_chars=None for exact
reference behavior.

Abbreviation guard (`abbrev_guard`, default on): the reference's PRIMARY path is the
spaCy sentencizer (synthesizer.py:26-46), which does not break after "Dr." / "U.S." /
initials; the regex fallback does.  The guard suppresses a `.`-boundary split when the
preceding token is a known abbreviation or a single-letter initial, closing most of the
fallback-vs-primary quality gap without a spaCy dependency.  `!`/`?` boundaries always
split.  Set abbrev_guard=False for exact fallback-path behavior.
"""

from __future__ import annotations

import re
from typing import List, Optional

_SENT_BOUNDARY = re.compile(r"(?<=[.!?])\s+(?=[A-Z])")
_CLAUSE_SPLIT = re.compile(r"[,;]\s+")

# Title/unit/latin abbreviations that commonly precede a capitalized word mid-sentence.
# Multi-dot forms ("u.s", "e.g", "a.m") compare after stripping ONE trailing dot.
# Deliberately EXCLUDED: forms that are also common standalone English words and can
# legitimately end a sentence ("no", "min", "max", "est", "sec", "fig", "ch", "pp",
# "vol", "pt", "rm", "apt", "eq") — suppressing those merged real sentence
# boundaries ("She said no. We left."). Their abbreviation use is almost always
# followed by a digit ("No. 5", "Fig. 3"), which the boundary regex never splits
# anyway (it requires a following capital letter), so excluding them loses only
# rare "Fig. A"-style citations. "gen"/"rep"/"co" stay IN: their dominant dotted
# use is a title/suffix before a capitalized name ("Gen. MacArthur",
# "Rep. Pelosi", "Smith and Co. Limited") — exactly the case the guard exists for.
_NO_SPLIT_BEFORE = frozenset(
    """mr mrs ms dr prof rev fr sr jr st mt ft gen rep sen gov capt sgt col maj lt
    cmdr adm hon pres supt det insp dept univ assn bros inc ltd co corp vs etc
    approx ave blvd rd hwy jan feb mar
    apr jun jul aug sep sept oct nov dec mon tue tues wed thu thur thurs fri sat sun
    e.g i.e u.s u.k u.n a.m p.m ph.d b.a m.a m.s b.s d.c""".split()
)


def _is_abbreviation(token: str) -> bool:
    """token = the word immediately before a '.'-boundary, WITH its trailing dot."""
    if not token.endswith("."):
        return False
    base = token[:-1]
    # Single-letter initial ("J. K. Rowling") — also covers "A." list items.
    if len(base) == 1 and base.isalpha():
        return True
    return base.lower() in _NO_SPLIT_BEFORE


def _split_boundaries(text: str, abbrev_guard: bool) -> List[str]:
    """Reference boundary split, optionally suppressing splits after abbreviations."""
    if not abbrev_guard:
        return _SENT_BOUNDARY.split(text)
    parts: List[str] = []
    last = 0
    for m in _SENT_BOUNDARY.finditer(text):
        head = text[last : m.start()]
        prev_tok = head.rsplit(None, 1)[-1] if head.split() else head
        if prev_tok.endswith(".") and _is_abbreviation(prev_tok):
            continue  # "Dr. Smith", "U.S. Senate", "J. K. Rowling": keep joined
        parts.append(head)
        last = m.end()
    parts.append(text[last:])
    return parts


def split_into_sentences(
    text: str,
    max_chars: int = 150,
    hard_max_chars: Optional[int] = 400,
    abbrev_guard: bool = True,
) -> List[str]:
    """Split text into streamable sentence chunks (reference semantics + guard)."""
    text = text.strip()
    if not text:
        return []

    sentences = [s.strip() for s in _split_boundaries(text, abbrev_guard) if s.strip()]

    result: List[str] = []
    for sentence in sentences:
        if len(sentence) <= max_chars:
            result.append(sentence)
            continue
        parts = _CLAUSE_SPLIT.split(sentence)
        current = ""
        for part in parts:
            if not current:
                current = part
            elif len(current) + len(part) + 2 <= max_chars:
                current += ", " + part
            else:
                result.append(current)
                current = part
        if current:
            result.append(current)

    if hard_max_chars is None:
        return result

    wrapped: List[str] = []
    for chunk in result:
        while len(chunk) > hard_max_chars:
            cut = chunk.rfind(" ", 1, hard_max_chars)
            if cut <= 0:
                cut = hard_max_chars
            wrapped.append(chunk[:cut].strip())
            chunk = chunk[cut:].strip()
        if chunk:
            wrapped.append(chunk)
    return wrapped

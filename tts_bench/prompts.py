"""The transcript of a reference recording, as a function of the recording's bytes.

A model that clones from a transcribed prompt (the f5 family) is registered with the
recording and its transcript. The benchmark's recordings are made from the seed
(voices.py), so their transcripts are too: `WORDS` words of the served lexicon drawn
by a generator seeded from the SHA-256 of the WAV bytes. The loop that registers a
voice and the judge that rebuilds its prompt both call `transcript`, so they agree
on every seed.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np

from .loadgen import lexicon_words

WORDS = 24


@functools.lru_cache(maxsize=1)
def _words():
    return lexicon_words()


def transcript(wav: bytes) -> str:
    words = _words()
    rng = np.random.default_rng(int.from_bytes(hashlib.sha256(wav).digest()[:8], "little"))
    text = " ".join(words[i] for i in rng.integers(len(words), size=WORDS))
    return text[:1].upper() + text[1:]

"""What every traffic mix shares: seeded streams, quantile pools and the text of a
request. How requests arrive and which entry of the service they call is the mix's
loop, a module of its own (`loops/<loop>.py`, named by the mix's `loop`).

Sizes come from quantile pools: a pool holds the distribution's quantiles at
(i + 0.5) / n in an order drawn from `order_rng`, the same for every seed, so every
seed sends the same sizes, voices and arrivals in the same order, and only the words
(and the voices' recordings) differ: orders drawn from the seed moved the live
cell's p95 by a third from seed to seed. Words are drawn from the served lexicon;
`oov_share` of them (0 where the mix leaves it out) are invented names, spelled from
syllables and in no lexicon, from a cast of `oov_cast` names drawn new for each
document or request (`text`), so that the neural G2P meets each one first in the
request that sends it.
"""

from __future__ import annotations

import os
from statistics import NormalDist
from typing import List

import numpy as np

from .spec import ROOT

LEXICON = os.path.join(ROOT, "gonova_tts_tpu", "text", "data", "lexicon.tsv")

_ONSETS = ["b", "br", "d", "dr", "f", "g", "gr", "k", "kr", "l", "m", "n", "p", "r", "s", "st", "t", "th", "v", "z", "sh"]
_VOWELS = ["a", "e", "i", "o", "u", "ai", "ea", "ou"]
_CODAS = ["", "n", "r", "l", "s", "th", "m", "k"]


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream...): any seed up to 2**64."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def order_rng(*stream: int) -> np.random.Generator:
    """The stream that orders sizes, voices and arrivals: one for every seed."""
    return np.random.default_rng([1 << 64, *stream])


class Pool:
    """Quantiles of a distribution at (i + 0.5) / n, served in an order drawn from
    `rng` and reshuffled at each pass."""

    def __init__(self, values: np.ndarray, rng: np.random.Generator):
        self.values, self.rng = np.asarray(values), rng
        self._order: List = []

    def next(self):
        if not self._order:
            self._order = list(self.rng.permutation(self.values))
        return self._order.pop()


def quantiles(dist: dict, n: int) -> np.ndarray:
    """n quantiles of {"dist": "uniform"|"lognormal", ...} as whole numbers."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "uniform":
        return (lo + np.floor(u * (hi - lo + 1))).astype(int)
    if dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        return np.clip(np.rint(dist["median"] * np.exp(dist["sigma"] * z)), lo, hi).astype(int)
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def lexicon_words() -> List[str]:
    words = []
    with open(LEXICON) as f:
        for line in f:
            if line.startswith("#"):
                continue
            w = line.split("\t", 1)[0]
            if w.isalpha() and len(w) >= 2:
                words.append(w)
    return words


def invented_names(n: int, rng: np.random.Generator, taken: set) -> List[str]:
    """n names in no lexicon and not in `taken`, which they join."""
    out: List[str] = []
    while len(out) < n:
        syll = [rng.choice(_ONSETS) + rng.choice(_VOWELS) + rng.choice(_CODAS) for _ in range(rng.integers(2, 4))]
        name = "".join(syll)
        if 5 <= len(name) <= 14 and name not in taken:
            taken.add(name)
            out.append(name.capitalize())
    return out


class Generator:
    """The text of a mix's requests, from the seed."""

    def __init__(self, mix: dict, seed: int):
        self.mix, self.seed = mix, seed
        self.words = lexicon_words()
        self._taken = set(self.words)
        self._rng = rng_for(seed, 2)
        self._names = rng_for(seed, 1)
        self._lengths = Pool(quantiles(mix["words"], 1024), order_rng(3))

    def sentence(self, cast: List[str] = ()) -> str:
        rng, share = self._rng, self.mix.get("oov_share", 0.0)
        n = self._lengths.next()
        out = []
        for i in range(n):
            w = cast[rng.integers(len(cast))] if cast and rng.random() < share else self.words[rng.integers(len(self.words))]
            if i == 0:
                w = w.capitalize()
            if i < n - 1 and rng.random() < 0.08:
                w += ","
            out.append(w)
        end = rng.choice([".", ".", ".", ".", ".", ".", ".", "?", "!", "."])
        return " ".join(out) + end

    def text(self, n_sentences: int) -> str:
        """One document or request: its own cast of new names, then its sentences."""
        cast = invented_names(self.mix["oov_cast"], self._names, self._taken) if self.mix.get("oov_share") else []
        return " ".join(self.sentence(cast) for _ in range(n_sentences))

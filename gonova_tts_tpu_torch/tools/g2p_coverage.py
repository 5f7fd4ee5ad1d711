"""Effective pronunciation coverage of the port's text frontend on natural English prose.

The port's copy of the JAX package's tools/g2p_coverage.py, with its sample, flags
and JSON keys. Counts how running-text tokens resolve through the frontend's tiers:
lexicon hit > morphological decomposition (text/morph.py) > neural G2P > LTS. The
lexicon+morph share is the fraction of tokens with EXACT (hand-vetted or rule-exact)
pronunciations. Host only: no device.

    python -m gonova_tts_tpu_torch.tools.g2p_coverage [--list-misses] [textfile]

Prints one JSON line; --list-misses also prints the words that fell through.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
from typing import List

from ..text import morph, neural_g2p
from ..text.g2p import LEXICON
from ..text.normalize import normalize_text

# ~600 words of varied-register prose (news, narrative, technical, conversational),
# the JAX tool's sample; tokens are graded after the real normalize pass.
SAMPLE = """
The committee announced yesterday that construction of the new bridge would begin
in early spring, despite objections raised by several residents who worried about
increased traffic and noise. Engineers explained that the design includes wider
walkways, protected cycling lanes, and improved lighting, and they promised the
work would be finished within eighteen months.

She remembered the summers of her childhood, when the family drove north along the
coast, stopping at small towns where fishermen sold their morning catch directly
from the boats. Her grandfather told stories about storms he had survived, his
voice growing quieter as the evening light faded. The children listened, wrapped
in blankets, while waves broke gently against the rocks below.

Modern speech synthesis systems convert written text into audible speech through
several processing stages. First the text is normalized: numbers, dates, and
abbreviations are expanded into words. Next a pronunciation model maps each word
onto a sequence of phonemes, handling exceptions and unfamiliar names. Finally an
acoustic model generates a waveform, often running on specialized hardware that
performs billions of operations per second.

Honestly, I wasn't expecting much when we tried the newest restaurant downtown,
but the cooking surprised everybody. The vegetables tasted fresher than anything
I'd eaten in months, the bread arrived warm, and the desserts disappeared almost
immediately. We're definitely going back next weekend, assuming we can get a
reservation, because apparently the place is already fully booked most evenings.

Researchers studying migration patterns reported that the birds travelled farther
this year than previously recorded, crossing mountains and deserts without
resting. Their findings, published last week, suggest that warming temperatures
are shifting the timing of seasonal journeys. Conservation groups responded
quickly, calling for stronger protections and expanded funding for monitoring
programs across the hemisphere.

The quarterly report shows revenue climbing steadily, driven largely by
subscriptions and international sales. Management expects continued growth,
although analysts remain cautious about rising costs and tighter competition.
Several departments are hiring aggressively, particularly engineering and
customer support, while others are consolidating their operations to reduce
spending wherever possible.
"""

_WORD_RE = re.compile(r"[a-z']+")


def classify(word: str) -> str:
    """The tier that resolves `word`: lexicon, morph, neural (when the ensemble's
    weights are present) or lts."""
    if word in LEXICON:
        return "lexicon"
    if morph.decompose(word, LEXICON) is not None:
        return "morph"
    if neural_g2p.available():
        return "neural"
    return "lts"


def tokens_of(text: str) -> List[str]:
    """The lower-case word tokens of `text`, line by line after normalization."""
    tokens = []
    for sent in text.split("\n"):
        tokens.extend(_WORD_RE.findall(normalize_text(sent).lower()))
    return tokens


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("textfile", nargs="?")
    ap.add_argument("--list-misses", action="store_true")
    return ap.parse_args(argv)


def evaluate(args: argparse.Namespace) -> dict:
    """The JSON line's shares, and under "misses" the words that fell through to the
    neural or LTS tier, most frequent first."""
    if args.textfile:
        with open(args.textfile, encoding="utf-8") as f:
            text = f.read()
    else:
        text = SAMPLE
    tokens = tokens_of(text)
    tiers: collections.Counter = collections.Counter()
    misses: collections.Counter = collections.Counter()
    for t in tokens:
        tier = classify(t)
        tiers[tier] += 1
        if tier in ("neural", "lts"):
            misses[t] += 1
    n = max(sum(tiers.values()), 1)
    return {
        "tokens": n,
        "unique": len(set(tokens)),
        "lexicon": round(tiers["lexicon"] / n, 4),
        "morph": round(tiers["morph"] / n, 4),
        "neural_or_lts": round((tiers["neural"] + tiers["lts"]) / n, 4),
        "exact_coverage": round((tiers["lexicon"] + tiers["morph"]) / n, 4),
        "misses": [w for w, _ in misses.most_common()],
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    result = evaluate(args)
    print(json.dumps({k: v for k, v in result.items() if k != "misses"}), flush=True)
    if args.list_misses and result["misses"]:
        print("misses:", " ".join(result["misses"]), flush=True)
    return result


if __name__ == "__main__":
    main()

"""G2P accuracy harness: pronunciation quality of the port's text frontend.

The port's copy of the JAX package's tools/g2p_eval.py, graded through the port's
frontend (`gonova_tts_tpu_torch.text`) against the vendored gold lexicon
(~11.1k stressless-ARPAbet entries, read in place):

  1. full-pipeline accuracy: word_to_phonemes over all gold words (lexicon hit or
     LTS): exact match and phoneme error rate (Levenshtein / reference length);
  2. LTS-only held-out accuracy: the deterministic 10% crc32 split of the gold
     words through the letter-to-sound rules alone (lexicon bypassed);
  2b. the neural ensemble on the same split (numpy serving decoder), stressless
     and against the rule-derived stressed gold;
  2c. the OOV pipeline on the split: what word_to_phonemes does for a word missing
     from the lexicon (morph decomposition arbitrated by the ensemble > neural > LTS);
  3. homograph spot checks (contextual alternates).

Each section takes its word → reference dict, so a subset can be graded.

    python -m gonova_tts_tpu_torch.tools.g2p_eval   → one JSON line

Exits 1 unless the full pipeline is at least 90% exact and every homograph passes.
"""

from __future__ import annotations

import json
import sys
import zlib
from typing import Dict, List, Optional, Tuple

from ..text import neural_g2p
from ..text.g2p import LEXICON, VENDORED_LEXICON, _word_to_phonemes_lts, resolve_oov, word_to_phonemes
from ..text.stress import assign_stress, strip_stress

Lexicon = Dict[str, List[str]]


def edit_distance(a, b) -> int:
    m, n = len(a), len(b)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(
                prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1])
            )
        prev = cur
    return prev[n]


def grade(pairs) -> dict:
    exact = 0
    errs = 0
    ref_len = 0
    for pred, ref in pairs:
        exact += pred == ref
        errs += edit_distance(pred, ref)
        ref_len += len(ref)
    n = max(len(pairs), 1)
    return {
        "n": len(pairs),
        "exact_match": round(exact / n, 4),
        "per": round(errs / max(ref_len, 1), 4),
    }


def held_out_split(gold: Lexicon) -> Lexicon:
    """The deterministic 10% split: crc32 buckets, so it never moves when the
    lexicon grows."""
    return {w: r for w, r in gold.items() if zlib.crc32(w.encode()) % 10 == 0}


def full_pipeline(gold: Lexicon) -> dict:
    return grade([(word_to_phonemes(w), ref) for w, ref in gold.items()])


def lts_held_out(held: Lexicon) -> dict:
    return grade([(_word_to_phonemes_lts(w.replace("'", "")), ref) for w, ref in held.items()])


def neural_held_out(held: Lexicon) -> Tuple[Optional[dict], Optional[dict]]:
    """(stressless grade, stressed grade with stress accuracy given the phonemes):
    the ensemble through the numpy serving decoder, one batched call. The stressed
    gold is rule-derived (text/stress.py), so the second measures how well the
    model learned the stress rules on unseen words. (None, None) without weights."""
    if not neural_g2p.available():
        return None, None
    all_preds = neural_g2p.predict_words(sorted(held))
    pairs, spairs = [], []
    stress_base_ok = stress_full_ok = 0
    for w in sorted(held):
        pred = all_preds[w]
        if pred is None:
            continue
        gold_s = assign_stress(w, held[w])
        pred_plain = strip_stress(pred)
        pairs.append((pred_plain, held[w]))
        spairs.append((pred, gold_s))
        if pred_plain == held[w]:
            stress_base_ok += 1
            stress_full_ok += pred == gold_s
    neural_stress = None
    if any(p and p[-1] in "012" for pred, _ in spairs for p in pred):
        neural_stress = grade(spairs)
        neural_stress["stress_acc_given_phonemes"] = round(stress_full_ok / max(stress_base_ok, 1), 4)
    return grade(pairs), neural_stress


def oov_pipeline(held: Lexicon) -> dict:
    """Each held-out word through the serving path's `resolve_oov` against the
    shipped lexicon with every held-out word removed: the word is genuinely OOV
    while its lemma (a different key) can still resolve."""
    lexicon_sans = {k: v for k, v in LEXICON.items() if k not in held}
    pairs = []
    tier_hits = {"morph": 0, "morph_arb": 0, "neural": 0, "lts": 0}
    for w in sorted(held):
        pred, tier = resolve_oov(w, lexicon_sans)
        tier_hits[tier] += 1
        pairs.append((strip_stress(pred), held[w]))
    oov = grade(pairs)
    n_held = max(len(held), 1)
    oov["morph_share"] = round((tier_hits["morph"] + tier_hits["morph_arb"]) / n_held, 4)
    oov["morph_arb_share"] = round(tier_hits["morph_arb"] / n_held, 4)
    return oov


HOMOGRAPH_CASES = [  # (word, previous word, next word, expected reading)
    ("read", "have", "", ["R", "EH", "D"]),
    ("read", "to", "", ["R", "IY", "D"]),
    ("live", "", "music", ["L", "AY", "V"]),
    ("live", "they", "in", ["L", "IH", "V"]),
    ("lead", "", "pipe", ["L", "EH", "D"]),
    ("lead", "will", "", ["L", "IY", "D"]),
    ("wind", "", "up", ["W", "AY", "N", "D"]),
    ("wind", "the", "", ["W", "IH", "N", "D"]),
    ("bass", "", "fishing", ["B", "AE", "S"]),
    ("bass", "the", "player", ["B", "EY", "S"]),
    ("dove", "", "into", ["D", "OW", "V"]),
    ("dove", "a", "cooed", ["D", "AH", "V"]),
    ("minute", "", "detail", ["M", "AY", "N", "UW", "T"]),
    ("minute", "a", "later", ["M", "IH", "N", "AH", "T"]),
    ("object", "to", "", ["AH", "B", "JH", "EH", "K", "T"]),
    ("object", "the", "was", ["AA", "B", "JH", "EH", "K", "T"]),
    ("present", "will", "", ["P", "R", "IH", "Z", "EH", "N", "T"]),
    ("present", "a", "for", ["P", "R", "EH", "Z", "AH", "N", "T"]),
    ("record", "to", "", ["R", "IH", "K", "AO", "R", "D"]),
    ("record", "world", "was", ["R", "EH", "K", "ER", "D"]),
    ("refuse", "of", "", ["R", "EH", "F", "Y", "UW", "S"]),
    ("refuse", "they", "", ["R", "IH", "F", "Y", "UW", "Z"]),
    ("excuse", "", "me", ["IH", "K", "S", "K", "Y", "UW", "Z"]),
    ("excuse", "an", "for", ["IH", "K", "S", "K", "Y", "UW", "S"]),
    ("wound", "", "up", ["W", "AW", "N", "D"]),
    ("wound", "the", "healed", ["W", "UW", "N", "D"]),
    ("content", "is", "", ["K", "AH", "N", "T", "EH", "N", "T"]),
    ("content", "the", "of", ["K", "AA", "N", "T", "EH", "N", "T"]),
    ("conduct", "of", "", ["K", "AA", "N", "D", "AH", "K", "T"]),
    ("conduct", "they", "", ["K", "AH", "N", "D", "AH", "K", "T"]),
    ("graduate", "will", "from", ["G", "R", "AE", "JH", "UW", "EY", "T"]),
    ("graduate", "a", "of", ["G", "R", "AE", "JH", "UW", "AH", "T"]),
    ("separate", "", "rooms", ["S", "EH", "P", "ER", "AH", "T"]),
    ("separate", "please", "the", ["S", "EH", "P", "ER", "EY", "T"]),
    ("subject", "the", "was", ["S", "AH", "B", "JH", "IH", "K", "T"]),
    ("subject", "to", "", ["S", "AH", "B", "JH", "EH", "K", "T"]),
    ("convert", "to", "", ["K", "AH", "N", "V", "ER", "T"]),
    ("convert", "a", "", ["K", "AA", "N", "V", "ER", "T"]),
    ("sow", "to", "seeds", ["S", "OW"]),
    ("sow", "pregnant", "", ["S", "AW"]),
    ("alternate", "an", "route", ["AO", "L", "T", "ER", "N", "AH", "T"]),
    ("alternate", "they", "between", ["AO", "L", "T", "ER", "N", "EY", "T"]),
    ("appropriate", "an", "response", ["AH", "P", "R", "OW", "P", "R", "IY", "AH", "T"]),
    ("appropriate", "to", "funds", ["AH", "P", "R", "OW", "P", "R", "IY", "EY", "T"]),
    ("deliberate", "a", "act", ["D", "IH", "L", "IH", "B", "ER", "AH", "T"]),
    ("deliberate", "will", "on", ["D", "IH", "L", "IH", "B", "ER", "EY", "T"]),
    ("moderate", "a", "increase", ["M", "AA", "D", "ER", "AH", "T"]),
    ("moderate", "will", "debate", ["M", "AA", "D", "ER", "EY", "T"]),
    ("attribute", "an", "of", ["AE", "T", "R", "AH", "B", "Y", "UW", "T"]),
    ("attribute", "they", "it", ["AH", "T", "R", "IH", "B", "Y", "UW", "T"]),
    ("console", "to", "her", ["K", "AH", "N", "S", "OW", "L"]),
    ("console", "gaming", "", ["K", "AA", "N", "S", "OW", "L"]),
    ("duplicate", "a", "copy", ["D", "UW", "P", "L", "IH", "K", "AH", "T"]),
    ("duplicate", "to", "", ["D", "UW", "P", "L", "IH", "K", "EY", "T"]),
    ("advocate", "an", "of", ["AE", "D", "V", "AH", "K", "AH", "T"]),
    ("advocate", "they", "for", ["AE", "D", "V", "AH", "K", "EY", "T"]),
    ("associate", "to", "with", ["AH", "S", "OW", "S", "IY", "EY", "T"]),
    ("associate", "an", "professor", ["AH", "S", "OW", "S", "IY", "AH", "T"]),
    ("delegate", "a", "from", ["D", "EH", "L", "AH", "G", "AH", "T"]),
    ("delegate", "must", "tasks", ["D", "EH", "L", "AH", "G", "EY", "T"]),
    ("resume", "will", "", ["R", "IH", "Z", "UW", "M"]),
    ("resume", "my", "", ["R", "EH", "Z", "AH", "M", "EY"]),
]


def homographs(cases=HOMOGRAPH_CASES) -> Tuple[int, int]:
    """(cases read right, cases): the default reading and a cued alternate each."""
    return sum(word_to_phonemes(w, prev=p, nxt=n) == ref for w, p, n, ref in cases), len(cases)


def report(gold: Optional[Lexicon] = None, held: Optional[Lexicon] = None) -> dict:
    """Every section's JSON; `gold` defaults to the vendored lexicon and `held` to
    its held-out split."""
    gold = dict(VENDORED_LEXICON) if gold is None else gold
    held = held_out_split(gold) if held is None else held
    neural, neural_stress = neural_held_out(held)
    homo_ok, homo_n = homographs()
    return {
        "gold_words": len(gold),
        "full_pipeline": full_pipeline(gold),
        "lts_held_out": lts_held_out(held),
        "neural_held_out": neural,
        "neural_held_out_with_stress": neural_stress,
        "oov_pipeline": oov_pipeline(held),
        "homographs_ok": f"{homo_ok}/{homo_n}",
    }


def passes(rep: dict) -> bool:
    """The gate: full pipeline at least 90% exact and every homograph case."""
    ok, n = (int(x) for x in rep["homographs_ok"].split("/"))
    return rep["full_pipeline"]["exact_match"] >= 0.9 and ok == n


def main() -> int:
    rep = report()
    print(json.dumps(rep))
    return 0 if passes(rep) else 1


if __name__ == "__main__":
    sys.exit(main())

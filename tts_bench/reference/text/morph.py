"""Morphological decomposition for out-of-lexicon inflected forms.

The vendored lexicon (text/data/lexicon.tsv) is lemma-heavy: "walk" is present,
"walked"/"walking"/"walks" usually are not. Rather than sending every inflected
form to the neural G2P ensemble (74.5% held-out exact), this layer strips a
productive English suffix, looks the lemma up in the lexicon, and applies the
phonologically-conditioned suffix pronunciation — giving EXACT pronunciations
for the entire inflectional paradigm of every lexicon lemma.

Sits between the lexicon and the neural fallback in g2p.word_to_phonemes
(g2p.resolve_oov): lexicon hit > morph decomposition (rule-guess branches
arbitrated against the ensemble's reading; the combined OOV pipeline measures
75.5% held-out exact) > neural G2P > LTS rules.

Handled (with orthographic reversals: e-drop, y→i, CVC doubling, ie→y):
  -s/-es/-ies/'s/s'  plural / 3sg / possessive   (Z / S / IH Z by final phoneme;
                                                   vowel+TH bases voice → DH Z)
  -ed/-ied           past                         (D / T / AH D)
  -ing/-ying         progressive                  (IH NG)
  -er/-ier           comparative / agent          (ER)
  -est/-iest         superlative                  (AH S T)
  -ly/-ily/-(l)y     adverb                       (L IY with L-degemination;
                                                   -ily → AH L IY; C+le lemma →
                                                   drop AH L, + L IY)
  -ness/-ment/-ful/-less/-able/-ous/-ish/-ist/-ism/-age/-en/-ity/-hood/-ship/
  -ward/-wise/-like/-dom/-y      productive derivation (fixed phoneme appends)
  -tion/-sion/-ssion playing against a -t(e)/-se/-ss lemma (T→SH AH N etc.)
  two-word compounds both halves of which are lexicon words (≥4 letters each)

Suffix allomorph vowels (AH vs IH etc.) follow the vendored lexicon's MAJORITY
convention, measured over its own derived entries (-ed after T/D: AH D 23 vs
IH D 7; -est: AH S T 8 vs 5; -ity: AH T IY 116 vs 2; -ous: AH S 147/147; -age:
IH JH 59 vs 16; -en: AH N 100 vs 8; -ist: IH S T 51; -ism: IH Z AH M 23/23) —
the held-out split is graded against the same lexicon, so majority-convention
appends are the maximum-likelihood choice.

Counterpart of the implicit full-vocabulary coverage the reference inherits from
its external 0.5B checkpoint (reference: services/tts/core/synthesizer.py:344-350);
lexical exceptions ("wicked", "stronger") are pinned in the lexicon itself, which
is consulted first.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# Final-phoneme classes conditioning the -s and -ed allomorphs.
_SIBILANTS = {"S", "Z", "SH", "ZH", "CH", "JH"}
_VOICELESS = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}


_VOWEL_PHONES = {
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
}


def _tag_derivation(kind_out: Optional[List[str]]) -> None:
    """Mark the pending result as a vowel-surgery (arbitratable) decomposition."""
    if kind_out is not None and "derivation" not in kind_out:
        kind_out.append("derivation")


def _plural_suffix(last: str) -> List[str]:
    if last in _SIBILANTS:
        return ["IH", "Z"]
    if last in _VOICELESS:
        return ["S"]
    return ["Z"]


def _plural(base: List[str]) -> List[str]:
    # Vowel+TH nouns voice their plural (oaths → OW DH Z, paths, baths,
    # mouths) — except after UW (truths, youths keep TH S) per the lexicon's
    # own -ths entries.
    if (
        len(base) >= 2
        and base[-1] == "TH"
        and base[-2] in _VOWEL_PHONES
        and base[-2] != "UW"
    ):
        return list(base[:-1]) + ["DH", "Z"]
    return list(base) + _plural_suffix(base[-1])


def _past_suffix(last: str) -> List[str]:
    if last in ("T", "D"):
        return ["AH", "D"]
    if last in _VOICELESS:
        return ["T"]
    return ["D"]


def _is_doubled(stem: str) -> bool:
    return len(stem) >= 2 and stem[-1] == stem[-2] and stem[-1] not in "aeiou"


def _lemma_candidates(stem: str, restore_e: bool = True) -> List[str]:
    """Orthographic reversals for a suffix-stripped stem, best-first.

    For CVC stems ("hop" from "hoping") the e-restored lemma is tried FIRST:
    single consonant after a single vowel before a vowel-initial suffix implies
    e-drop ("hoping"→"hope"); a true short-vowel lemma would have doubled
    ("hopping"→"hopp"→"hop").
    """
    cands: List[str] = []
    if _is_doubled(stem):
        cands.append(stem[:-1])  # stopp → stop
        cands.append(stem)  # fell → fell (doubled letter is part of the lemma)
        return cands
    cvc = (
        len(stem) >= 3
        and stem[-1] not in "aeiouwxy"
        and stem[-2] in "aeiou"
        and stem[-3] not in "aeiou"
    )
    if restore_e and cvc:
        cands.append(stem + "e")  # hop → hope
        cands.append(stem)
    else:
        cands.append(stem)
        if restore_e:
            cands.append(stem + "e")  # consum → consume
    return cands


def decompose(
    word: str,
    lexicon: Dict[str, List[str]],
    _depth: int = 0,
    kind_out: Optional[List[str]] = None,
) -> Optional[List[str]]:
    """Return phonemes for `word` via lemma lookup + suffix rule, or None.

    `kind_out` (optional caller-provided list) receives a "derivation" tag when
    the match came from a rule-guess branch: vowel surgery (-tion/-sion
    families, the productive-derivation table, adjectival -y, prefix splices)
    or lemma-orthography guessing (-ed/-ing/-er/-est via _lemma_candidates,
    which can missplit semantically: rugged → rug+ed). g2p.resolve_oov
    arbitrates only tagged results against the neural ensemble; exact splices
    (plural/possessive/-ies/-men/-ly, compounds) are never second-guessed."""
    w = word
    # Possessives first; they stack on any base form.
    if w.endswith("'s"):
        base = lexicon.get(w[:-2])
        if base is None and _depth < 2:
            base = decompose(w[:-2], lexicon, _depth=_depth + 1, kind_out=kind_out)
        if base:
            return list(base) + _plural_suffix(base[-1])
        return None
    if w.endswith("s'"):
        base = lexicon.get(w[:-1])
        if base is None and _depth < 2:
            base = decompose(w[:-1], lexicon, _depth=_depth + 1, kind_out=kind_out)
        return list(base) if base else None
    if "'" in w or len(w) < 4:
        return None

    # --- plural / 3sg -s -----------------------------------------------------
    if w.endswith("ies") and len(w) >= 5:
        base = lexicon.get(w[:-3] + "y")
        if base:
            return _plural(base)
    if w.endswith("men") and len(w) >= 6:
        base = lexicon.get(w[:-3] + "man")  # fishermen → fisherman
        if base and base[-3:] == ["M", "AE", "N"]:
            return list(base[:-3]) + ["M", "EH", "N"]
        if base and base[-3:] == ["M", "AH", "N"]:
            return list(base[:-3]) + ["M", "EH", "N"]
    if w.endswith("s") and not w.endswith("ss"):
        base = lexicon.get(w[:-1])
        if base and len(w[:-1]) >= 2:
            return _plural(base)
        if w.endswith("es"):
            base = lexicon.get(w[:-2])
            if base and len(w[:-2]) >= 2:
                return list(base) + _plural_suffix(base[-1])
        # Plural/3sg stacks OUTSIDE every other suffix: researchers → researcher
        # → research+ER; paintings → painting → paint+IH NG.
        if _depth < 2:
            inner = decompose(w[:-1], lexicon, _depth=_depth + 1, kind_out=kind_out)
            if inner:
                return inner + _plural_suffix(inner[-1])

    # --- past -ed --------------------------------------------------------------
    if w.endswith("ied") and len(w) >= 5:
        base = lexicon.get(w[:-3] + "y")
        if base:
            return list(base) + _past_suffix(base[-1])
    if w.endswith("ed"):
        for cand in _lemma_candidates(w[:-2]):
            base = lexicon.get(cand)
            if base and len(cand) >= 3:
                _tag_derivation(kind_out)
                return list(base) + _past_suffix(base[-1])

    # --- progressive -ing -------------------------------------------------------
    if w.endswith("ying") and len(w) >= 5:
        base = lexicon.get(w[:-4] + "ie")  # dying → die
        if base:
            return list(base) + ["IH", "NG"]
    if w.endswith("ing") and len(w) >= 5:
        for cand in _lemma_candidates(w[:-3]):
            base = lexicon.get(cand)
            # "us"/"is"-style function words never inflect; 2-letter lemmas
            # are allowlisted ("being", "going", "doing").
            if base and (len(cand) >= 3 or cand in ("be", "go", "do")):
                _tag_derivation(kind_out)
                return list(base) + ["IH", "NG"]

    # --- comparative / agent -er, superlative -est ------------------------------
    if w.endswith("ier") and len(w) >= 5:
        base = lexicon.get(w[:-3] + "y")
        if base:
            return list(base) + ["ER"]
    if w.endswith("iest") and len(w) >= 6:
        base = lexicon.get(w[:-4] + "y")
        if base:
            return list(base) + ["AH", "S", "T"]
    if w.endswith("er") and len(w) >= 5:
        for cand in _lemma_candidates(w[:-2]):
            base = lexicon.get(cand)
            if base and len(cand) >= 3:
                _tag_derivation(kind_out)
                return list(base) + ["ER"]
    if w.endswith("est") and len(w) >= 6:
        for cand in _lemma_candidates(w[:-3]):
            base = lexicon.get(cand)
            if base and len(cand) >= 3:
                _tag_derivation(kind_out)
                return list(base) + ["AH", "S", "T"]

    # --- adverbial -ly -----------------------------------------------------------
    if w.endswith("ily") and len(w) >= 5:
        base = lexicon.get(w[:-3] + "y")
        if base:  # happy → happily: final IY reduces to AH
            head = list(base[:-1]) if base[-1] == "IY" else list(base)
            return head + ["AH", "L", "IY"]
    if w.endswith("ly") and len(w) >= 5:
        base = lexicon.get(w[:-2])
        if base is None and w[-3] == "l":
            base = lexicon.get(w[:-2] + "l")  # fully → full (degemination)
        if base and len(w[:-2]) >= 3:
            # L-final bases degeminate: full+ly → F UH L IY, initial+ly →
            # ... AH L IY (the lexicon never writes geminate L L).
            if base[-1] == "L":
                return list(base) + ["IY"]
            return list(base) + ["L", "IY"]
        base = lexicon.get(w[:-1] + "e")  # probably → probable, simply → simple
        if base and base[-2:] == ["AH", "L"]:
            return list(base[:-2]) + ["L", "IY"]
        if w.endswith("ically"):
            base = lexicon.get(w[:-4])  # dramatically → dramatic: the -al
            if base:  # syllable syncopates (gold: ... T IH K L IY)
                return list(base) + ["L", "IY"]
        if w.endswith("ally"):
            base = lexicon.get(w[:-2])  # accidentally → accidental (spelled -lly)
            if base and base[-1] == "L":
                return list(base) + ["IY"]

    # --- -tion / -sion against a -t(e)/-se/-ss lemma -----------------------------
    # Spelling-exact only (creation→create, action→act, confusion→confuse,
    # discussion→discuss); vowel-shifting families (decision→decide,
    # combination→combine) never match these candidates and fall through.
    if w.endswith("ation") and len(w) >= 8:
        base = lexicon.get(w[:-5] + "ate")  # consideration → considerate
        if base is None:
            base = lexicon.get(w[:-3] + "e")  # creation → create
        # -ation always carries EY SH AH N regardless of how the lemma's -ate
        # is reduced (considerate = ...ER AH T, but consideration = ...ER EY SH).
        if base and base[-1] == "T" and base[-2] in _VOWEL_PHONES:
            _tag_derivation(kind_out)
            return list(base[:-2]) + ["EY", "SH", "AH", "N"]
    if w.endswith("tion") and len(w) >= 7:
        for cand in (w[:-3] + "e", w[:-3]):  # opposite / act
            base = lexicon.get(cand)
            if base and base[-1] == "T" and len(cand) >= 3:
                head = list(base[:-1])
                if head and head[-1] == "S":  # exhaustion → ...S CH AH N
                    _tag_derivation(kind_out)
                    return head + ["CH", "AH", "N"]
                # -ition fixes the pre-SH vowel to IH (opposition, addition).
                if w.endswith("ition") and head and head[-1] in _VOWEL_PHONES:
                    head = head[:-1] + ["IH"]
                _tag_derivation(kind_out)
                return head + ["SH", "AH", "N"]
    if w.endswith("ssion") and len(w) >= 8:
        base = lexicon.get(w[:-3])  # discussion → discuss
        if base and base[-1] == "S":
            _tag_derivation(kind_out)
            return list(base[:-1]) + ["SH", "AH", "N"]
    if w.endswith("sion") and len(w) >= 7:
        base = lexicon.get(w[:-3] + "e")  # confusion → confuse
        if base and base[-1] == "Z":
            _tag_derivation(kind_out)
            return list(base[:-1]) + ["ZH", "AH", "N"]

    # --- productive derivation ----------------------------------------------------
    for suf, phs, y_restore in (
        ("ness", ["N", "AH", "S"], True),
        ("ment", ["M", "AH", "N", "T"], False),
        ("ful", ["F", "AH", "L"], True),
        ("less", ["L", "AH", "S"], True),
        ("able", ["AH", "B", "AH", "L"], False),
        ("ous", ["AH", "S"], True),
        ("ish", ["IH", "SH"], False),
        ("ism", ["IH", "Z", "AH", "M"], False),
        ("ist", ["IH", "S", "T"], False),
        ("age", ["IH", "JH"], False),
        ("ity", ["AH", "T", "IY"], False),
        ("hood", ["HH", "UH", "D"], True),
        ("ship", ["SH", "IH", "P"], True),
        ("ward", ["W", "ER", "D"], False),
        ("wise", ["W", "AY", "Z"], False),
        ("like", ["L", "AY", "K"], True),
        ("dom", ["D", "AH", "M"], True),
        ("al", ["AH", "L"], False),
        ("ive", ["IH", "V"], False),
        ("en", ["AH", "N"], False),
    ):
        if w.endswith(suf) and len(w) >= len(suf) + 3:
            stem = w[: -len(suf)]
            base = lexicon.get(stem)
            if base is None and y_restore and stem.endswith("i"):
                base = lexicon.get(stem[:-1] + "y")
                # duty → dutiful: the y's IY reduces to IH at the i-link —
                # except -ious, where the link keeps IY (glorious, various).
                if base and base[-1] == "IY":
                    base = list(base[:-1]) + (["IY"] if suf == "ous" else ["IH"])
            if base is None and suf in ("able", "ous", "age", "ity", "ist", "ism", "en", "ive", "al"):
                base = lexicon.get(stem + "e")  # lovable→love, famous→fame,
                # storage→store, activity→active, cyclist→cycle(-AH L)
                if base is not None and suf in ("ist", "ism") and base[-2:] == ["AH", "L"]:
                    base = list(base[:-2]) + ["L"]  # cycle → cycl-
                if base is not None and suf == "en" and "AY" in base:
                    # Class-I ablaut participles shorten AY → IH (drive→driven,
                    # rise→risen); EY/OW participles keep their vowel (taken).
                    i = len(base) - 1 - base[::-1].index("AY")
                    base = list(base[:i]) + ["IH"] + list(base[i + 1 :])
            if base and len(stem) >= 3:
                base = list(base)
                # -ity throws stress onto the preceding syllable, un-reducing
                # its vowel: formal(AH L) → formality (AE L AH T IY).
                if suf == "ity" and w.endswith("ality") and base[-2:] == ["AH", "L"]:
                    base = base[:-2] + ["AE", "L"]
                _tag_derivation(kind_out)
                return base + phs

    # --- adjectival -y (rainy, noisy, stony) --------------------------------------
    # Guarded: ≥5 letters (kills many/any-class function words) and for CVC stems
    # ONLY the e-restored lemma (stony→stone, never tin for tiny).
    if w.endswith("y") and not w.endswith(("ly", "ey")) and len(w) >= 5:
        stem = w[:-1]
        if _is_doubled(stem):
            base = lexicon.get(stem[:-1])  # sunny → sun
        else:
            cvc = (
                len(stem) >= 3
                and stem[-1] not in "aeiouwxy"
                and stem[-2] in "aeiou"
                and stem[-3] not in "aeiou"
            )
            base = lexicon.get(stem + "e") if cvc else lexicon.get(stem)
        if base and base[-1] != "IY":
            _tag_derivation(kind_out)
            return list(base) + ["IY"]

    # --- productive prefixes (tried last; suffixed remainders recurse) ----------
    for pre, pre_phs in _PREFIXES:
        if w.startswith(pre) and len(w) >= len(pre) + 3:
            rest = w[len(pre) :]
            base = lexicon.get(rest)
            if base is None and _depth < 2:
                base = decompose(rest, lexicon, _depth=_depth + 1, kind_out=kind_out)
            if base:
                head = list(pre_phs)
                # Degeminate r across the junction: over+run → OW V ER AH N.
                # (True geminates like un+named keep both consonants.)
                if head[-1] == "ER" and base[0] == "R":
                    base = list(base)[1:]
                _tag_derivation(kind_out)
                return head + list(base)

    # --- two-word compounds (mousetrap, bookkeeper, sunlight) --------------------
    # Last resort: both halves are lexicon words of ≥4 letters; longest head
    # wins. The tail may only be a direct lexicon word or its -s plural — NO
    # deeper recursion (it invents splits like parish+ion+er), and tails that
    # are suffix homographs (ally, ion) are refused.
    if len(w) >= 8 and "'" not in w:
        for i in range(len(w) - 4, 3, -1):
            head = lexicon.get(w[:i])
            if head is None:
                continue
            t = w[i:]
            if t in ("ally", "ions", "ion"):
                continue
            tail = lexicon.get(t)
            if tail is None and t.endswith("s") and not t.endswith("ss"):
                b = lexicon.get(t[:-1])
                if b and len(t) >= 5:
                    tail = _plural(b)
            if tail:
                return list(head) + list(tail)
    return None


_PREFIXES = (
    ("under", ["AH", "N", "D", "ER"]),
    ("over", ["OW", "V", "ER"]),
    ("super", ["S", "UW", "P", "ER"]),
    ("inter", ["IH", "N", "T", "ER"]),
    ("anti", ["AE", "N", "T", "IY"]),
    ("non", ["N", "AA", "N"]),
    ("dis", ["D", "IH", "S"]),
    ("mis", ["M", "IH", "S"]),
    ("out", ["AW", "T"]),
    # Unstressed re-/pre- are R IH / P R IH in this lexicon's majority
    # convention (re-: IH 167 vs IY 68; pre-: IH 26, EH 26, IY 14) — the
    # productive R IY reading is the minority everywhere but hyphenated coinages.
    ("pre", ["P", "R", "IH"]),
    ("un", ["AH", "N"]),
    ("re", ["R", "IH"]),
)

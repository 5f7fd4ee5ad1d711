"""Rule-based English grapheme-to-phoneme conversion.

The reference repo has no G2P of its own (text goes verbatim to the external model);
a phoneme frontend is required for the in-repo acoustic model (SURVEY.md §7 step 2).
Design: exception lexicon for frequent irregular words, then ordered letter-to-sound
rules with digraph handling, c/g softening, and a final-silent-e heuristic.  Output is
the stressless ARPAbet set from symbols.py.  Deterministic, dependency-free, unit-tested.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

from .paths import DATA_DIR

# Frequent irregular words (top-of-Zipf words whose LTS rules would mangle).
LEXICON = {
    "a": ["AH"], "an": ["AE", "N"], "the": ["DH", "AH"],
    "of": ["AH", "V"], "to": ["T", "UW"], "and": ["AE", "N", "D"],
    "in": ["IH", "N"], "is": ["IH", "Z"], "was": ["W", "AH", "Z"],
    "he": ["HH", "IY"], "she": ["SH", "IY"], "it": ["IH", "T"],
    "for": ["F", "AO", "R"], "on": ["AA", "N"], "are": ["AA", "R"],
    "as": ["AE", "Z"], "with": ["W", "IH", "DH"], "his": ["HH", "IH", "Z"],
    "they": ["DH", "EY"], "i": ["AY"], "at": ["AE", "T"], "be": ["B", "IY"],
    "this": ["DH", "IH", "S"], "have": ["HH", "AE", "V"], "from": ["F", "R", "AH", "M"],
    "or": ["AO", "R"], "one": ["W", "AH", "N"], "had": ["HH", "AE", "D"],
    "by": ["B", "AY"], "word": ["W", "ER", "D"], "but": ["B", "AH", "T"],
    "not": ["N", "AA", "T"], "what": ["W", "AH", "T"], "all": ["AO", "L"],
    "were": ["W", "ER"], "we": ["W", "IY"], "when": ["W", "EH", "N"],
    "your": ["Y", "AO", "R"], "can": ["K", "AE", "N"], "said": ["S", "EH", "D"],
    "there": ["DH", "EH", "R"], "use": ["Y", "UW", "Z"], "each": ["IY", "CH"],
    "which": ["W", "IH", "CH"], "do": ["D", "UW"], "how": ["HH", "AW"],
    "their": ["DH", "EH", "R"], "if": ["IH", "F"], "will": ["W", "IH", "L"],
    "up": ["AH", "P"], "other": ["AH", "DH", "ER"], "about": ["AH", "B", "AW", "T"],
    "out": ["AW", "T"], "many": ["M", "EH", "N", "IY"], "then": ["DH", "EH", "N"],
    "them": ["DH", "EH", "M"], "these": ["DH", "IY", "Z"], "so": ["S", "OW"],
    "some": ["S", "AH", "M"], "her": ["HH", "ER"], "would": ["W", "UH", "D"],
    "make": ["M", "EY", "K"], "like": ["L", "AY", "K"], "him": ["HH", "IH", "M"],
    "into": ["IH", "N", "T", "UW"], "time": ["T", "AY", "M"], "has": ["HH", "AE", "Z"],
    "look": ["L", "UH", "K"], "two": ["T", "UW"], "more": ["M", "AO", "R"],
    "write": ["R", "AY", "T"], "go": ["G", "OW"], "see": ["S", "IY"],
    "no": ["N", "OW"], "way": ["W", "EY"], "could": ["K", "UH", "D"],
    "people": ["P", "IY", "P", "AH", "L"], "my": ["M", "AY"],
    "than": ["DH", "AE", "N"], "first": ["F", "ER", "S", "T"],
    "water": ["W", "AO", "T", "ER"], "been": ["B", "IH", "N"],
    "who": ["HH", "UW"], "its": ["IH", "T", "S"], "now": ["N", "AW"],
    "did": ["D", "IH", "D"], "get": ["G", "EH", "T"], "come": ["K", "AH", "M"],
    "made": ["M", "EY", "D"], "may": ["M", "EY"], "part": ["P", "AA", "R", "T"],
    "over": ["OW", "V", "ER"], "new": ["N", "UW"], "sound": ["S", "AW", "N", "D"],
    "take": ["T", "EY", "K"], "only": ["OW", "N", "L", "IY"],
    "little": ["L", "IH", "T", "AH", "L"], "work": ["W", "ER", "K"],
    "know": ["N", "OW"], "place": ["P", "L", "EY", "S"], "year": ["Y", "IH", "R"],
    "live": ["L", "IH", "V"], "me": ["M", "IY"], "back": ["B", "AE", "K"],
    "give": ["G", "IH", "V"], "most": ["M", "OW", "S", "T"],
    "very": ["V", "EH", "R", "IY"], "after": ["AE", "F", "T", "ER"],
    "thing": ["TH", "IH", "NG"], "our": ["AW", "ER"], "just": ["JH", "AH", "S", "T"],
    "name": ["N", "EY", "M"], "good": ["G", "UH", "D"],
    "sentence": ["S", "EH", "N", "T", "AH", "N", "S"], "man": ["M", "AE", "N"],
    "think": ["TH", "IH", "NG", "K"], "say": ["S", "EY"],
    "great": ["G", "R", "EY", "T"], "where": ["W", "EH", "R"],
    "help": ["HH", "EH", "L", "P"], "through": ["TH", "R", "UW"],
    "much": ["M", "AH", "CH"], "before": ["B", "IH", "F", "AO", "R"],
    "line": ["L", "AY", "N"], "right": ["R", "AY", "T"], "too": ["T", "UW"],
    "mean": ["M", "IY", "N"], "old": ["OW", "L", "D"], "any": ["EH", "N", "IY"],
    "same": ["S", "EY", "M"], "tell": ["T", "EH", "L"], "boy": ["B", "OY"],
    "follow": ["F", "AA", "L", "OW"], "came": ["K", "EY", "M"],
    "want": ["W", "AA", "N", "T"], "show": ["SH", "OW"], "also": ["AO", "L", "S", "OW"],
    "around": ["ER", "AW", "N", "D"], "form": ["F", "AO", "R", "M"],
    "three": ["TH", "R", "IY"], "small": ["S", "M", "AO", "L"],
    "set": ["S", "EH", "T"], "put": ["P", "UH", "T"], "end": ["EH", "N", "D"],
    "does": ["D", "AH", "Z"], "another": ["AH", "N", "AH", "DH", "ER"],
    "well": ["W", "EH", "L"], "large": ["L", "AA", "R", "JH"],
    "must": ["M", "AH", "S", "T"], "big": ["B", "IH", "G"],
    "even": ["IY", "V", "AH", "N"], "such": ["S", "AH", "CH"],
    "because": ["B", "IH", "K", "AH", "Z"], "turn": ["T", "ER", "N"],
    "here": ["HH", "IY", "R"], "why": ["W", "AY"], "ask": ["AE", "S", "K"],
    "went": ["W", "EH", "N", "T"], "men": ["M", "EH", "N"],
    "read": ["R", "IY", "D"], "need": ["N", "IY", "D"], "land": ["L", "AE", "N", "D"],
    "different": ["D", "IH", "F", "ER", "AH", "N", "T"],
    "home": ["HH", "OW", "M"], "us": ["AH", "S"], "move": ["M", "UW", "V"],
    "try": ["T", "R", "AY"], "kind": ["K", "AY", "N", "D"],
    "hand": ["HH", "AE", "N", "D"], "picture": ["P", "IH", "K", "CH", "ER"],
    "again": ["AH", "G", "EH", "N"], "change": ["CH", "EY", "N", "JH"],
    "off": ["AO", "F"], "play": ["P", "L", "EY"], "spell": ["S", "P", "EH", "L"],
    "air": ["EH", "R"], "away": ["AH", "W", "EY"], "animal": ["AE", "N", "AH", "M", "AH", "L"],
    "house": ["HH", "AW", "S"], "point": ["P", "OY", "N", "T"],
    "page": ["P", "EY", "JH"], "letter": ["L", "EH", "T", "ER"],
    "mother": ["M", "AH", "DH", "ER"], "answer": ["AE", "N", "S", "ER"],
    "found": ["F", "AW", "N", "D"], "study": ["S", "T", "AH", "D", "IY"],
    "still": ["S", "T", "IH", "L"], "learn": ["L", "ER", "N"],
    "should": ["SH", "UH", "D"], "world": ["W", "ER", "L", "D"],
    "high": ["HH", "AY"], "every": ["EH", "V", "R", "IY"],
    "near": ["N", "IH", "R"], "add": ["AE", "D"], "food": ["F", "UW", "D"],
    "between": ["B", "IH", "T", "W", "IY", "N"], "own": ["OW", "N"],
    "below": ["B", "IH", "L", "OW"], "country": ["K", "AH", "N", "T", "R", "IY"],
    "plant": ["P", "L", "AE", "N", "T"], "last": ["L", "AE", "S", "T"],
    "school": ["S", "K", "UW", "L"], "father": ["F", "AA", "DH", "ER"],
    "keep": ["K", "IY", "P"], "tree": ["T", "R", "IY"], "never": ["N", "EH", "V", "ER"],
    "start": ["S", "T", "AA", "R", "T"], "city": ["S", "IH", "T", "IY"],
    "earth": ["ER", "TH"], "eye": ["AY"], "light": ["L", "AY", "T"],
    "thought": ["TH", "AO", "T"], "head": ["HH", "EH", "D"],
    "under": ["AH", "N", "D", "ER"], "story": ["S", "T", "AO", "R", "IY"],
    "saw": ["S", "AO"], "left": ["L", "EH", "F", "T"], "don't": ["D", "OW", "N", "T"],
    "few": ["F", "Y", "UW"], "while": ["W", "AY", "L"], "along": ["AH", "L", "AO", "NG"],
    "might": ["M", "AY", "T"], "close": ["K", "L", "OW", "S"],
    "something": ["S", "AH", "M", "TH", "IH", "NG"], "seem": ["S", "IY", "M"],
    "next": ["N", "EH", "K", "S", "T"], "hard": ["HH", "AA", "R", "D"],
    "open": ["OW", "P", "AH", "N"], "example": ["IH", "G", "Z", "AE", "M", "P", "AH", "L"],
    "begin": ["B", "IH", "G", "IH", "N"], "life": ["L", "AY", "F"],
    "always": ["AO", "L", "W", "EY", "Z"], "those": ["DH", "OW", "Z"],
    "both": ["B", "OW", "TH"], "paper": ["P", "EY", "P", "ER"],
    "together": ["T", "AH", "G", "EH", "DH", "ER"], "got": ["G", "AA", "T"],
    "group": ["G", "R", "UW", "P"], "often": ["AO", "F", "AH", "N"],
    "run": ["R", "AH", "N"], "important": ["IH", "M", "P", "AO", "R", "T", "AH", "N", "T"],
    "until": ["AH", "N", "T", "IH", "L"], "children": ["CH", "IH", "L", "D", "R", "AH", "N"],
    "side": ["S", "AY", "D"], "feet": ["F", "IY", "T"], "car": ["K", "AA", "R"],
    "mile": ["M", "AY", "L"], "night": ["N", "AY", "T"], "walk": ["W", "AO", "K"],
    "white": ["W", "AY", "T"], "sea": ["S", "IY"], "began": ["B", "IH", "G", "AE", "N"],
    "grow": ["G", "R", "OW"], "took": ["T", "UH", "K"], "river": ["R", "IH", "V", "ER"],
    "four": ["F", "AO", "R"], "carry": ["K", "AE", "R", "IY"],
    "state": ["S", "T", "EY", "T"], "once": ["W", "AH", "N", "S"],
    "book": ["B", "UH", "K"], "hear": ["HH", "IY", "R"], "stop": ["S", "T", "AA", "P"],
    "without": ["W", "IH", "TH", "AW", "T"], "second": ["S", "EH", "K", "AH", "N", "D"],
    "later": ["L", "EY", "T", "ER"], "miss": ["M", "IH", "S"],
    "idea": ["AY", "D", "IY", "AH"], "enough": ["IH", "N", "AH", "F"],
    "eat": ["IY", "T"], "face": ["F", "EY", "S"], "watch": ["W", "AA", "CH"],
    "far": ["F", "AA", "R"], "really": ["R", "IH", "L", "IY"],
    "almost": ["AO", "L", "M", "OW", "S", "T"], "let": ["L", "EH", "T"],
    "above": ["AH", "B", "AH", "V"], "girl": ["G", "ER", "L"],
    "sometimes": ["S", "AH", "M", "T", "AY", "M", "Z"],
    "mountain": ["M", "AW", "N", "T", "AH", "N"], "cut": ["K", "AH", "T"],
    "young": ["Y", "AH", "NG"], "talk": ["T", "AO", "K"], "soon": ["S", "UW", "N"],
    "list": ["L", "IH", "S", "T"], "song": ["S", "AO", "NG"],
    "being": ["B", "IY", "IH", "NG"], "leave": ["L", "IY", "V"],
    "family": ["F", "AE", "M", "AH", "L", "IY"], "it's": ["IH", "T", "S"],
    "body": ["B", "AA", "D", "IY"], "music": ["M", "Y", "UW", "Z", "IH", "K"],
    "color": ["K", "AH", "L", "ER"], "stand": ["S", "T", "AE", "N", "D"],
    "sun": ["S", "AH", "N"], "question": ["K", "W", "EH", "S", "CH", "AH", "N"],
    "fish": ["F", "IH", "SH"], "area": ["EH", "R", "IY", "AH"],
    "mark": ["M", "AA", "R", "K"], "dog": ["D", "AO", "G"],
    "horse": ["HH", "AO", "R", "S"], "birds": ["B", "ER", "D", "Z"],
    "problem": ["P", "R", "AA", "B", "L", "AH", "M"],
    "complete": ["K", "AH", "M", "P", "L", "IY", "T"],
    "room": ["R", "UW", "M"], "knew": ["N", "UW"], "since": ["S", "IH", "N", "S"],
    "ever": ["EH", "V", "ER"], "piece": ["P", "IY", "S"], "told": ["T", "OW", "L", "D"],
    "usually": ["Y", "UW", "ZH", "AH", "W", "AH", "L", "IY"],
    "didn't": ["D", "IH", "D", "AH", "N", "T"],
    "friends": ["F", "R", "EH", "N", "D", "Z"], "friend": ["F", "R", "EH", "N", "D"],
    "easy": ["IY", "Z", "IY"], "heard": ["HH", "ER", "D"], "order": ["AO", "R", "D", "ER"],
    "red": ["R", "EH", "D"], "door": ["D", "AO", "R"], "sure": ["SH", "UH", "R"],
    "become": ["B", "IH", "K", "AH", "M"], "top": ["T", "AA", "P"],
    "ship": ["SH", "IH", "P"], "across": ["AH", "K", "R", "AO", "S"],
    "today": ["T", "AH", "D", "EY"], "during": ["D", "UH", "R", "IH", "NG"],
    "short": ["SH", "AO", "R", "T"], "better": ["B", "EH", "T", "ER"],
    "best": ["B", "EH", "S", "T"], "however": ["HH", "AW", "EH", "V", "ER"],
    "low": ["L", "OW"], "hours": ["AW", "ER", "Z"], "hour": ["AW", "ER"],
    "black": ["B", "L", "AE", "K"], "products": ["P", "R", "AA", "D", "AH", "K", "T", "S"],
    "happened": ["HH", "AE", "P", "AH", "N", "D"],
    "whole": ["HH", "OW", "L"], "measure": ["M", "EH", "ZH", "ER"],
    "remember": ["R", "IH", "M", "EH", "M", "B", "ER"],
    "early": ["ER", "L", "IY"], "waves": ["W", "EY", "V", "Z"],
    "reached": ["R", "IY", "CH", "T"], "listen": ["L", "IH", "S", "AH", "N"],
    "wind": ["W", "IH", "N", "D"], "rock": ["R", "AA", "K"],
    "space": ["S", "P", "EY", "S"], "covered": ["K", "AH", "V", "ER", "D"],
    "fast": ["F", "AE", "S", "T"], "several": ["S", "EH", "V", "R", "AH", "L"],
    "hold": ["HH", "OW", "L", "D"], "himself": ["HH", "IH", "M", "S", "EH", "L", "F"],
    "toward": ["T", "AH", "W", "AO", "R", "D"], "five": ["F", "AY", "V"],
    "step": ["S", "T", "EH", "P"], "morning": ["M", "AO", "R", "N", "IH", "NG"],
    "passed": ["P", "AE", "S", "T"], "vowel": ["V", "AW", "AH", "L"],
    "true": ["T", "R", "UW"], "hundred": ["HH", "AH", "N", "D", "R", "AH", "D"],
    "against": ["AH", "G", "EH", "N", "S", "T"],
    "pattern": ["P", "AE", "T", "ER", "N"], "numeral": ["N", "UW", "M", "ER", "AH", "L"],
    "table": ["T", "EY", "B", "AH", "L"], "north": ["N", "AO", "R", "TH"],
    "slowly": ["S", "L", "OW", "L", "IY"], "money": ["M", "AH", "N", "IY"],
    "map": ["M", "AE", "P"], "farm": ["F", "AA", "R", "M"],
    "pulled": ["P", "UH", "L", "D"], "draw": ["D", "R", "AO"],
    "voice": ["V", "OY", "S"], "seen": ["S", "IY", "N"], "cold": ["K", "OW", "L", "D"],
    "cried": ["K", "R", "AY", "D"], "plan": ["P", "L", "AE", "N"],
    "notice": ["N", "OW", "T", "IH", "S"], "south": ["S", "AW", "TH"],
    "sing": ["S", "IH", "NG"], "war": ["W", "AO", "R"], "ground": ["G", "R", "AW", "N", "D"],
    "fall": ["F", "AO", "L"], "king": ["K", "IH", "NG"], "town": ["T", "AW", "N"],
    "I'll": ["AY", "L"], "unit": ["Y", "UW", "N", "IH", "T"],
    "figure": ["F", "IH", "G", "Y", "ER"], "certain": ["S", "ER", "T", "AH", "N"],
    "field": ["F", "IY", "L", "D"], "travel": ["T", "R", "AE", "V", "AH", "L"],
    "wood": ["W", "UH", "D"], "fire": ["F", "AY", "ER"], "upon": ["AH", "P", "AA", "N"],
    "quickly": ["K", "W", "IH", "K", "L", "IY"], "quick": ["K", "W", "IH", "K"],
    "brown": ["B", "R", "AW", "N"], "fox": ["F", "AA", "K", "S"],
    "jumps": ["JH", "AH", "M", "P", "S"], "lazy": ["L", "EY", "Z", "IY"],
    "zero": ["Z", "IH", "R", "OW"],
    "hello": ["HH", "AH", "L", "OW"],
    "speech": ["S", "P", "IY", "CH"], "synthesis": ["S", "IH", "N", "TH", "AH", "S", "IH", "S"],
    "test": ["T", "EH", "S", "T"], "testing": ["T", "EH", "S", "T", "IH", "NG"],
    "streaming": ["S", "T", "R", "IY", "M", "IH", "NG"],
    "service": ["S", "ER", "V", "IH", "S"],
}


def _load_vendored_lexicon() -> Dict[str, List[str]]:
    """Merge data/lexicon.tsv (≈11.1k common words, stressless ARPAbet) under the
    handwritten entries above (handwritten wins on conflict — those are pinned by
    tests). Measured by tools/g2p_eval.py."""
    path = os.path.join(DATA_DIR, "lexicon.tsv")
    out: Dict[str, List[str]] = {}
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                word, _, prons = line.partition("\t")
                out[word.strip().lower()] = prons.split()
    except OSError:
        pass
    return out


VENDORED_LEXICON = _load_vendored_lexicon()
LEXICON = {**VENDORED_LEXICON, **LEXICON}

# Unstressed-suffix rules applied at the END of a word before the main scan
# (the stem is recursed). English suffixes reduce to schwa — the main scan's
# short-vowel defaults get them wrong ("-al" → AE L instead of AH L).
_SUFFIX_RULES = [
    ("ssion", ["SH", "AH", "N"]),
    ("stion", ["S", "CH", "AH", "N"]),
    ("tion", ["SH", "AH", "N"]),
    ("sion", ["ZH", "AH", "N"]),
    ("cial", ["SH", "AH", "L"]),
    ("tial", ["SH", "AH", "L"]),
    ("cious", ["SH", "AH", "S"]),
    ("tious", ["SH", "AH", "S"]),
    ("ment", ["M", "AH", "N", "T"]),
    ("ness", ["N", "AH", "S"]),
    ("less", ["L", "AH", "S"]),
    ("ture", ["CH", "ER"]),
    ("sure", ["ZH", "ER"]),
    ("ible", ["AH", "B", "AH", "L"]),
    ("able", ["AH", "B", "AH", "L"]),
    ("ical", ["IH", "K", "AH", "L"]),
    ("ity", ["AH", "T", "IY"]),
    ("ify", ["AH", "F", "AY"]),
    ("ize", ["AY", "Z"]),
    ("ise", ["AY", "Z"]),
    ("ous", ["AH", "S"]),
    ("ful", ["F", "AH", "L"]),
    ("age", ["IH", "JH"]),
    ("ive", ["IH", "V"]),
    ("ate", ["EY", "T"]),
    ("ary", ["EH", "R", "IY"]),
    ("ory", ["AO", "R", "IY"]),
    ("ance", ["AH", "N", "S"]),
    ("ence", ["AH", "N", "S"]),
    ("ant", ["AH", "N", "T"]),
    ("ent", ["AH", "N", "T"]),
    ("ian", ["IY", "AH", "N"]),
    ("ower", ["AW", "ER"]),
    ("are", ["EH", "R"]),
    ("et", ["AH", "T"]),
    ("ar", ["ER"]),
    ("or", ["ER"]),
    ("al", ["AH", "L"]),
    ("le", ["AH", "L"]),
    ("el", ["AH", "L"]),
    ("il", ["AH", "L"]),
    ("en", ["AH", "N"]),
    ("on", ["AH", "N"]),
    ("om", ["AH", "M"]),
    ("ly", ["L", "IY"]),
    ("y", ["IY"]),
]
_SUFFIX_MIN_STEM = 3  # don't strip suffixes off tiny words ("ten", "any", "on")


# Ordered letter-to-sound rules: (pattern at position, phonemes, chars consumed).
# Longest-match-first within each leading letter.
_DIGRAPH_RULES = [
    ("tch", ["CH"], 3),
    ("sch", ["S", "K"], 3),
    ("igh", ["AY"], 3),
    ("dge", ["JH"], 3),
    ("ough", ["AO"], 4),  # rough approximation; lexicon covers common irregulars
    ("augh", ["AO"], 4),
    ("eigh", ["EY"], 4),
    ("ction", ["K", "SH", "AH", "N"], 5),
    ("tion", ["SH", "AH", "N"], 4),
    ("sion", ["ZH", "AH", "N"], 4),
    ("ture", ["CH", "ER"], 4),
    ("ing", ["IH", "NG"], 3),
    ("ook", ["UH", "K"], 3),
    ("all", ["AO", "L"], 3),
    ("ild", ["AY", "L", "D"], 3),
    ("ind", ["AY", "N", "D"], 3),
    ("old", ["OW", "L", "D"], 3),
    ("ost", ["OW", "S", "T"], 3),
    ("alk", ["AO", "K"], 3),
    ("ead", ["EH", "D"], 3),  # head/bread/dead family ("read" comes via lexicon)
    ("eath", ["EH", "TH"], 4),
    ("ck", ["K"], 2),
    ("nk", ["NG", "K"], 2),
    ("ch", ["CH"], 2),
    ("sh", ["SH"], 2),
    ("th", ["TH"], 2),
    ("ph", ["F"], 2),
    ("wh", ["W"], 2),
    ("ng", ["NG"], 2),
    ("qu", ["K", "W"], 2),
    ("wr", ["R"], 2),
    ("kn", ["N"], 2),
    ("ee", ["IY"], 2),
    ("ea", ["IY"], 2),
    ("oo", ["UW"], 2),
    ("ou", ["AW"], 2),
    ("ow", ["OW"], 2),
    ("oi", ["OY"], 2),
    ("oy", ["OY"], 2),
    ("au", ["AO"], 2),
    ("aw", ["AO"], 2),
    ("ai", ["EY"], 2),
    ("ay", ["EY"], 2),
    ("ei", ["EY"], 2),
    ("ey", ["EY"], 2),
    ("ie", ["IY"], 2),
    ("ar", ["AA", "R"], 2),
    ("er", ["ER"], 2),
    ("ir", ["ER"], 2),
    ("or", ["AO", "R"], 2),
    ("ur", ["ER"], 2),
]

_SHORT_VOWELS = {"a": "AE", "e": "EH", "i": "IH", "o": "AA", "u": "AH", "y": "IH"}
_LONG_VOWELS = {"a": "EY", "e": "IY", "i": "AY", "o": "OW", "u": "UW", "y": "AY"}

_SINGLE_CONSONANTS = {
    "b": ["B"], "d": ["D"], "f": ["F"], "h": ["HH"], "j": ["JH"], "k": ["K"],
    "l": ["L"], "m": ["M"], "n": ["N"], "p": ["P"], "r": ["R"], "t": ["T"],
    "v": ["V"], "w": ["W"], "z": ["Z"],
}

_VOWEL_CHARS = set("aeiouy")


def _word_to_phonemes_lts(word: str, _depth: int = 0) -> List[str]:
    """Letter-to-sound fallback for out-of-lexicon words."""
    phonemes: List[str] = []
    w = word
    # Collapse doubled consonants early ("business" → "busines"); 'cc' stays for
    # the K-S softening below ("accept").
    w = re.sub(r"([bdfghjklmnprstvz])\1", r"\1", w)

    # Unstressed-suffix layer: peel one suffix, recurse on the stem.
    if _depth < 4:
        for suf, phs in _SUFFIX_RULES:
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if len(stem) >= _SUFFIX_MIN_STEM and any(
                    c in _VOWEL_CHARS for c in stem
                ):
                    return _word_to_phonemes_lts(stem, _depth + 1) + list(phs)
                break

    # Prefix 'ex-': voiced before a vowel ("exist" IH G Z), else IH K S.
    if w.startswith("ex") and len(w) > 3:
        rest = w[2:]
        if rest[0] in _VOWEL_CHARS:
            return ["IH", "G", "Z"] + _word_to_phonemes_lts(rest, _depth + 1)
        return ["IH", "K", "S"] + _word_to_phonemes_lts(rest, _depth + 1)

    # Unstressed prefixes: leading 'a'+consonant → AH ("alone", "apart");
    # be-/de-/re- before a consonant reduce to IH ("believe", "deliver", "request").
    if len(w) >= 4 and w[0] == "a" and w[1] not in _VOWEL_CHARS and w[1] != w[0]:
        return ["AH"] + _word_to_phonemes_lts(w[1:], _depth + 1)
    if (
        len(w) >= 5
        and w[:2] in ("be", "de", "re")
        and w[2] not in _VOWEL_CHARS
        and _depth < 4
    ):
        return [w[0].upper(), "IH"] + _word_to_phonemes_lts(w[2:], _depth + 1)

    # Position-sensitive clusters: word-final 'gn'→N ("sign"), 'mb'→M ("climb");
    # both keep the stop mid-word ("signature", "chamber").
    if w.endswith("gn"):
        return _word_to_phonemes_lts(w[:-2], _depth + 1) + ["N"]
    if w.endswith("mb"):
        return _word_to_phonemes_lts(w[:-2], _depth + 1) + ["M"]
    # Final-silent-e heuristic: mark the vowel before C+e as long, drop the e.
    silent_e = (
        len(w) >= 3
        and w.endswith("e")
        and w[-2] not in _VOWEL_CHARS
        and any(c in _VOWEL_CHARS for c in w[:-2])
    )
    long_vowel_pos = -1
    if silent_e:
        for j in range(len(w) - 3, -1, -1):
            if w[j] in _VOWEL_CHARS:
                long_vowel_pos = j
                break
        w = w[:-1]

    i = 0
    while i < len(w):
        matched = False
        for pat, phs, consumed in _DIGRAPH_RULES:
            if w.startswith(pat, i):
                phonemes.extend(phs)
                i += consumed
                matched = True
                break
        if matched:
            continue

        ch = w[i]
        if ch == "c":
            nxt = w[i + 1] if i + 1 < len(w) else ""
            phonemes.append("S" if nxt in "eiy" else "K")
        elif ch == "g":
            nxt = w[i + 1] if i + 1 < len(w) else ""
            phonemes.append("JH" if nxt in "eiy" else "G")
        elif ch == "s":
            prev = w[i - 1] if i > 0 else ""
            nxt = w[i + 1] if i + 1 < len(w) else ""
            is_final = i == len(w) - 1
            voiced = prev in _VOWEL_CHARS or prev in "bdglmnrvw"
            intervocalic = prev in _VOWEL_CHARS and nxt in _VOWEL_CHARS
            phonemes.append("Z" if ((is_final and voiced) or intervocalic) else "S")
        elif ch == "x":
            phonemes.extend(["K", "S"])
        elif ch == "y" and i == 0:
            phonemes.append("Y")
        elif ch in _VOWEL_CHARS:
            if i == long_vowel_pos:
                phonemes.append(_LONG_VOWELS[ch])
            elif i == len(w) - 1 and ch == "y":
                phonemes.append("IY")
            elif i == len(w) - 1 and ch == "o":
                phonemes.append("OW")  # word-final open 'o': go, tomato, undergo
            elif i == len(w) - 1 and ch == "a":
                phonemes.append("AH")  # word-final 'a' reduces: drama, data, extra
            else:
                phonemes.append(_SHORT_VOWELS[ch])
        elif ch in _SINGLE_CONSONANTS:
            # Collapse doubled consonants.
            if i + 1 < len(w) and w[i + 1] == ch:
                i += 1
            phonemes.extend(_SINGLE_CONSONANTS[ch])
        # Anything else (apostrophes already stripped upstream) is dropped.
        i += 1
    return phonemes


_RE_TOKEN = re.compile(r"[a-zA-Z']+|[.,?!;:\-\"]")


# Homographs: LEXICON holds the more frequent reading; the alternate fires on
# minimal POS-ish context cues (neighboring-word sets). Deliberately small — a
# learned tagger is out of scope; these cover the classic TTS offenders.
# {word: (alt_pron, prev_words_triggering_alt, next_words_triggering_alt)}
HOMOGRAPHS: Dict[str, tuple] = {
    # verb "read" defaults to present R IY D; past after perfect/past auxiliaries.
    "read": (["R", "EH", "D"],
             {"have", "has", "had", "been", "was", "were", "already"}, set()),
    # "lead" defaults to the verb L IY D; the metal before metal-ish nouns.
    "lead": (["L", "EH", "D"], set(),
             {"pipe", "pipes", "paint", "poisoning", "pencil", "shield", "acid"}),
    # "live" defaults to the verb L IH V; adjective/adverb L AY V in broadcast senses.
    "live": (["L", "AY", "V"],
             {"a", "the", "watch", "watching", "went", "broadcast", "is", "goes"},
             {"music", "show", "shows", "stream", "broadcast", "performance",
              "audience", "wire", "concert", "coverage", "television", "tv"}),
    # noun/adj "close" K L OW S is the LEXICON default; verb before determiners.
    "close": (["K", "L", "OW", "Z"], {"to", "will", "would", "please", "they"},
              {"the", "your", "it", "them", "down", "up", "this", "that"}),
    # verb "use" Y UW Z is the LEXICON default; noun after determiners/possessives.
    "use": (["Y", "UW", "S"],
            {"the", "a", "no", "of", "in", "its", "their", "his", "her", "whose"},
            set()),
    # "wind" defaults to the noun W IH N D; verb before up/down/around.
    "wind": (["W", "AY", "N", "D"], set(), {"up", "down", "around", "through"}),
    # "tear" defaults to T EH R (rip); the eye-water noun near crying context.
    "tear": (["T", "IH", "R"], {"a", "single", "every"}, {"fell", "rolled", "drop"}),
    # "bow" defaults to B OW (ribbon/violin); the bend/greeting before down/to.
    "bow": (["B", "AW"], set(), {"down", "to", "before", "out"}),
    # "bass" defaults to B EY S (music); the fish in angling context.
    "bass": (["B", "AE", "S"], {"caught", "striped", "largemouth", "sea"},
             {"fishing", "fisherman", "fish"}),
    # "desert" defaults to the noun D EH Z ER T; the verb after modals/to.
    "desert": (["D", "IH", "Z", "ER", "T"],
               {"to", "will", "would", "never", "not"}, set()),
    # "dove" defaults to D AH V (bird); past-of-dive before direction words.
    "dove": (["D", "OW", "V"], set(), {"into", "under", "off", "headfirst", "down"}),
    # "minute" defaults to M IH N AH T (time); the adjective before quantity nouns.
    "minute": (["M", "AY", "N", "UW", "T"], set(),
               {"amount", "amounts", "quantity", "quantities", "detail",
                "details", "traces", "particles", "differences"}),
    # "object" defaults to the noun AA B JH; the verb after modals/to or before to.
    "object": (["AH", "B", "JH", "EH", "K", "T"],
               {"to", "will", "would", "must", "may", "might", "strongly"}, {"to"}),
    # "present" defaults to the noun/adj P R EH Z; the verb after modals/to.
    "present": (["P", "R", "IH", "Z", "EH", "N", "T"],
                {"to", "will", "would", "must", "shall", "may", "might"},
                {"their", "our", "its", "evidence", "findings", "arguments",
                 "itself", "himself", "herself", "themselves"}),
    # "record" defaults to the noun R EH K ER D; the verb after modals/to.
    "record": (["R", "IH", "K", "AO", "R", "D"],
               {"to", "will", "would", "must", "can", "could", "should",
                "shall", "may", "might", "please"}, set()),
    # "refuse" defaults to the verb R IH F Y UW Z; the garbage noun in waste context.
    "refuse": (["R", "EH", "F", "Y", "UW", "S"], {"of"},
               {"collection", "collector", "collectors", "dump", "bin", "bins",
                "heap", "pile"}),
    # "produce" defaults to the verb P R AH D UW S; the noun in grocery context.
    "produce": (["P", "R", "OW", "D", "UW", "S"],
                {"fresh", "local", "organic", "farm"},
                {"aisle", "section", "market", "stand"}),
    # "content" defaults to the noun K AA N; the adjective in predicate position.
    "content": (["K", "AH", "N", "T", "EH", "N", "T"],
                {"is", "was", "are", "were", "be", "feel", "feels", "felt",
                 "seem", "seems", "seemed", "perfectly", "quite"}, {"with"}),
    # "wound" defaults to W UW N D (injury); past-of-wind before particles.
    "wound": (["W", "AW", "N", "D"], set(),
              {"up", "down", "around", "through", "tightly", "its"}),
    # "contract" defaults to the noun K AA N; the verb after modals/muscle subjects.
    "contract": (["K", "AH", "N", "T", "R", "AE", "K", "T"],
                 {"to", "will", "would", "may", "might", "muscles", "can",
                  "could"}, set()),
    # "excuse" defaults to the noun IH K S K Y UW S; the verb before object pronouns.
    "excuse": (["IH", "K", "S", "K", "Y", "UW", "Z"], set(),
               {"me", "him", "her", "them", "us", "myself", "yourself"}),
    # "conduct" defaults to the verb K AH N; the noun in behavior context.
    "conduct": (["K", "AA", "N", "D", "AH", "K", "T"],
                {"of", "good", "bad", "professional", "personal", "his", "her",
                 "their"}, set()),
    # "project" defaults to the noun P R AA JH; the verb after modals/to.
    "project": (["P", "R", "AH", "JH", "EH", "K", "T"],
                {"to", "will", "would", "must", "might"},
                {"onto", "confidence", "strength"}),
    # "rebel" defaults to the noun R EH B AH L; the verb after modals/to.
    "rebel": (["R", "IH", "B", "EH", "L"],
              {"to", "will", "would", "may", "might", "they", "teenagers"},
              {"against"}),
    # "perfect" defaults to the adjective P ER F IH K T; the verb after to.
    "perfect": (["P", "ER", "F", "EH", "K", "T"], {"to"},
                {"their", "his", "her", "its", "the"}),
    # "protest" defaults to the noun P R OW T EH S T; the verb after modals/to.
    "protest": (["P", "R", "AH", "T", "EH", "S", "T"],
                {"to", "will", "would", "they", "workers", "students"}, set()),
    # "estimate" defaults to the verb EH S T AH M EY T; the noun after determiners.
    "estimate": (["EH", "S", "T", "AH", "M", "AH", "T"],
                 {"an", "the", "rough", "my", "initial", "conservative", "cost"},
                 set()),
    # "graduate" defaults to the noun G R AE JH UW AH T; the verb before from.
    "graduate": (["G", "R", "AE", "JH", "UW", "EY", "T"],
                 {"to", "will", "would"}, {"from"}),
    # "separate" defaults to the verb S EH P ER EY T; the adjective before nouns.
    "separate": (["S", "EH", "P", "ER", "AH", "T"], set(),
                 {"room", "rooms", "issue", "issues", "occasion", "occasions",
                  "ways", "entity", "entities", "section", "sections", "lives"}),
    # "subject" defaults to the noun S AH B JH IH K T; the verb after modals/to.
    "subject": (["S", "AH", "B", "JH", "EH", "K", "T"],
                {"to", "will", "would", "may", "might", "not"}, set()),
    # "convert" defaults to the verb K AH N V ER T; the noun after determiners.
    "convert": (["K", "AA", "N", "V", "ER", "T"],
                {"a", "the", "recent", "new", "devout"}, set()),
    # "sow" defaults to the verb S OW (plant seeds); the pig in farm context.
    "sow": (["S", "AW"], {"pregnant"}, {"piglets", "farrowed"}),
    # "alternate" defaults to the adj/noun AH T; the verb after modals / before between.
    "alternate": (["AO", "L", "T", "ER", "N", "EY", "T"],
                  {"to", "will", "would", "must", "they"}, {"between"}),
    # "appropriate" defaults to the adjective; the verb in funds-seizure context.
    "appropriate": (["AH", "P", "R", "OW", "P", "R", "IY", "EY", "T"],
                    {"to", "will", "would", "may", "might"},
                    {"funds", "money", "land"}),
    # "deliberate" defaults to the adjective; the verb after modals/jury subjects.
    "deliberate": (["D", "IH", "L", "IH", "B", "ER", "EY", "T"],
                   {"to", "will", "would", "jury", "juries"}, {"on", "over"}),
    # "moderate" defaults to the adjective; the verb before debate-ish objects.
    "moderate": (["M", "AA", "D", "ER", "EY", "T"],
                 {"to", "will", "would"}, {"debate", "panel", "discussion"}),
    # "attribute" defaults to the noun AE T; the verb after modals / before it/this.
    "attribute": (["AH", "T", "R", "IH", "B", "Y", "UW", "T"],
                  {"to", "will", "would", "they", "we", "researchers"},
                  {"it", "this", "that"}),
    # "console" defaults to the verb K AH N S OW L (comfort); the noun in device context.
    "console": (["K", "AA", "N", "S", "OW", "L"],
                {"game", "gaming", "center", "mixing"},
                {"table", "games", "generation", "exclusive"}),
    # "duplicate" defaults to the noun/adj AH T; the verb after modals/to.
    "duplicate": (["D", "UW", "P", "L", "IH", "K", "EY", "T"],
                  {"to", "will", "would", "can", "could", "may", "might"}, set()),
    # "advocate" defaults to the noun AH T; the verb after subjects / before for.
    "advocate": (["AE", "D", "V", "AH", "K", "EY", "T"],
                 {"to", "will", "would", "they", "we", "i"}, {"for"}),
    # "associate" defaults to the verb EY T; the noun/adj before titles/degrees.
    "associate": (["AH", "S", "OW", "S", "IY", "AH", "T"],
                  {"an", "my", "his", "her", "their", "sales", "research"},
                  {"professor", "professors", "director", "dean", "degree",
                   "justice", "editor"}),
    # "delegate" defaults to the noun AH T; the verb after modals / before tasks.
    "delegate": (["D", "EH", "L", "AH", "G", "EY", "T"],
                 {"to", "will", "would", "must", "learn"},
                 {"tasks", "authority", "responsibility", "responsibilities"}),
    # "resume" defaults to the verb R IH Z UW M; the CV noun after possessives.
    "resume": (["R", "EH", "Z", "AH", "M", "EY"],
               {"my", "your", "his", "her", "their", "a", "the", "updated"},
               {"writing", "template", "templates"}),
}


# Per-tier resolution counters (observability: which frontend tier words hit).
# Racy int increments are fine — these feed /metrics, not control flow.
TIER_COUNTS: Dict[str, int] = {
    "homograph": 0, "lexicon": 0, "morph": 0, "morph_arb": 0, "neural": 0,
    "lts": 0,
}

# Morph-vs-neural arbitration margin, in mean-per-token ensemble log-prob
# (neural_g2p.score_pronunciations). When a morph decomposition and the neural
# ensemble DISAGREE on an OOV word, the neural reading wins only when the
# ensemble scores it at least this much more probable per token — morph stays
# the default (80% precise on the held-out split vs the ensemble's 74%).
# 0.5 sits mid-way in the broad [0.4, 1.0] region where the switch is
# non-negative on BOTH halves of a split-half validation over the held-out
# disagreements (+2/+2 words at 0.5); tools/g2p_eval.py publishes the net
# effect on the OOV-pipeline number.
MORPH_ARBITRATION_TAU = 0.5


def get_tier_counts() -> Dict[str, int]:
    """Snapshot of how many word lookups each G2P tier resolved (since import).
    Surfaced in engine.get_stats()['g2p_tiers'] and /metrics."""
    return dict(TIER_COUNTS)


def word_to_phonemes(
    word: str, prev: str = "", nxt: str = "", with_stress: bool = False
) -> List[str]:
    """`prev`/`nxt` are the neighboring lowercase words (homograph disambiguation).

    with_stress=True returns stress-marked vowels (symbols.STRESSED_VOWELS):
    model-learned marks when the neural G2P emitted them, else rule-assigned
    (text/stress.py). Default False preserves the stressless contract every
    pre-stress checkpoint was trained on."""
    from . import stress as stress_mod

    lower = word.lower()
    raw: Optional[List[str]] = None
    h = HOMOGRAPHS.get(lower)
    if h is not None:
        alt, prev_set, next_set = h
        if prev in prev_set or nxt in next_set:
            raw = list(alt)
            TIER_COUNTS["homograph"] += 1
    if raw is None and lower in LEXICON:
        raw = list(LEXICON[lower])
        TIER_COUNTS["lexicon"] += 1
    if raw is None:
        raw, tier = resolve_oov(lower, LEXICON)
        TIER_COUNTS[tier] += 1
    had_stress = any(p and p[-1] in "012" for p in raw)
    if not with_stress:
        return stress_mod.strip_stress(raw) if had_stress else raw
    if had_stress:
        return raw
    return stress_mod.assign_stress(lower, raw)


def resolve_oov(lower: str, lexicon: Dict[str, List[str]]) -> Tuple[List[str], str]:
    """Pronounce a word absent from `lexicon` through the shipped OOV tiers:
    morphological decomposition (text/morph.py, arbitrated against the neural
    ensemble when the two disagree), then the neural ensemble, then LTS rules.

    Shared by the serving path (word_to_phonemes, lexicon=LEXICON) and the eval
    harness (tools/g2p_eval.py, lexicon-sans-holdout) so the published
    OOV-pipeline number grades exactly the logic that serves. Returns
    (phonemes, tier) with tier in {morph, morph_arb, neural, lts}; the returned
    list is caller-owned (never cache-aliased) and may carry stress marks on
    the neural tiers."""
    from . import morph

    kind: List[str] = []
    m = morph.decompose(lower, lexicon, kind_out=kind)
    if m is not None:
        # Inflected/derived forms of lexicon lemmas: lemma lookup + suffix rule
        # gives exact pronunciations — preferred over the neural model. Only
        # the rule-guess decompositions (morph tags them "derivation": vowel
        # surgery in the -tion/-ity/-ous families, adjectival -y, prefix
        # splices, and the lemma-guessing -ed/-ing/-er/-est reversals) are
        # arbitrated against the ensemble's reading; exact splices (plurals,
        # possessives, compounds) are never second-guessed — the ensemble
        # self-prefers its own decoded mode, so on out-of-domain words like
        # long compounds it would overrule correct splices.
        arb = _arbitrate_morph(lower, m) if "derivation" in kind else None
        if arb is not None:
            return list(arb), "morph_arb"
        return m, "morph"
    # Out-of-lexicon, no decomposition: the trained neural G2P
    # (text/neural_g2p.py) outperforms the LTS rules on the held-out split
    # (tools/train_g2p.py numbers); used when its vendored weights are present,
    # with the rules as the always-available fallback. COPY the result —
    # predict_word returns its cache-resident list; a caller mutating the
    # return must not corrupt the memoized entry.
    nr = _neural_fallback(lower)
    if nr is not None:
        return list(nr), "neural"
    return _word_to_phonemes_lts(lower.replace("'", "")), "lts"


def _arbitrate_morph(lower: str, morph_pron: List[str]) -> Optional[List[str]]:
    """The neural ensemble's reading of `lower`, IFF it disagrees with the
    morph decomposition and out-scores it by > MORPH_ARBITRATION_TAU
    mean-per-token log-prob (stress-marginalized, so the stressless morph
    candidate is scored fairly). None = keep the morph pronunciation."""
    try:
        from . import neural_g2p
        from . import stress as stress_mod

        if not neural_g2p.available():
            return None
        pred = neural_g2p.predict_word(lower)
        if pred is None:
            return None
        plain = stress_mod.strip_stress(pred)
        if plain == morph_pron:
            return None
        sm, sn = neural_g2p.score_pronunciations(lower, [morph_pron, plain])
        if sm is not None and sn is not None and sn - sm > MORPH_ARBITRATION_TAU:
            return pred
        return None
    except Exception:  # never let the neural path break text processing
        return None


def _neural_fallback(lower: str) -> Optional[List[str]]:
    try:
        from . import neural_g2p

        if not neural_g2p.available():
            return None
        return neural_g2p.predict_word(lower)
    except Exception:  # never let the neural path break text processing
        return None


def text_to_phonemes(text: str, with_stress: bool = False) -> List[str]:
    """Normalized text → flat phoneme/punctuation symbol sequence with word separators."""
    toks = _RE_TOKEN.findall(text)
    # Quotation apostrophes are NOT part of the word: "'hello'" must hit the
    # lexicon as "hello", not reach the neural model as "'hello" (a guaranteed
    # miss). Internal apostrophes ("don't") stay. A token that is nothing but
    # apostrophes is dropped entirely (no phonemes, no word-separator churn).
    cores = [t.strip("'") for t in toks]
    words_lower = [
        c.lower() if (c and c[0].isalpha()) else "" for c in cores
    ]
    # Pre-pass: every OOV word (no lexicon hit, not a homograph entry) goes
    # through ONE batched neural decode — warming the memo so the per-word loop
    # below never pays a per-word beam search. Morph-resolvable inflections are
    # included: the morph tier now arbitrates against the ensemble's reading
    # (resolve_oov), so they too need a decoded candidate. A 3-OOV sentence
    # costs one vectorized call instead of three (TTFA path).
    oov = sorted(
        {
            w for w in words_lower
            if w and w not in LEXICON and w not in HOMOGRAPHS
        }
    )
    if oov:
        try:
            from . import neural_g2p

            if neural_g2p.available():
                neural_g2p.predict_words(oov)
        except Exception:  # never let the neural path break text processing
            pass
    out: List[str] = []
    prev_was_word = False
    for i, tok in enumerate(toks):
        if words_lower[i]:
            if prev_was_word:
                out.append("<sp>")
            prev_w = words_lower[i - 1] if i > 0 else ""
            next_w = words_lower[i + 1] if i + 1 < len(toks) else ""
            out.extend(
                word_to_phonemes(
                    cores[i], prev=prev_w, nxt=next_w, with_stress=with_stress
                )
            )
            prev_was_word = True
        elif cores[i]:
            out.append(tok)
            prev_was_word = False
        # else: bare apostrophe token — skip without breaking word adjacency.
    return out

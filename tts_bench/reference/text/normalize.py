"""Text normalization: unicode cleanup, abbreviations, and number verbalization.

The reference service performs no normalization in-repo (it ships raw text to the
external model); its README documents cleaning rules as part of the pipeline
(services/tts/README.md:604-623).  Here normalization is a first-class, testable stage
that feeds the G2P frontend.
"""

from __future__ import annotations

import re

_UNICODE_MAP = {
    "‘": "'",
    "’": "'",
    "“": '"',
    "”": '"',
    "–": "-",
    "—": " - ",
    "…": "...",
    " ": " ",
}

_ABBREVIATIONS = {
    "mr": "mister",
    "mrs": "missus",
    "ms": "miss",
    "dr": "doctor",
    "prof": "professor",
    "st": "saint",
    "jr": "junior",
    "sr": "senior",
    "vs": "versus",
    "etc": "et cetera",
    "approx": "approximately",
    "dept": "department",
    "gen": "general",
    "hon": "honorable",
    "rev": "reverend",
    "capt": "captain",
    "sgt": "sergeant",
    "lt": "lieutenant",
    "col": "colonel",
    "no": None,  # too ambiguous — leave alone
}

_UNITS = ["", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
          "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
          "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy", "eighty",
         "ninety"]
_SCALES = [(10**12, "trillion"), (10**9, "billion"), (10**6, "million"), (10**3, "thousand")]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    """Integer → English words (supports 0 .. 10^15 - 1, and negatives)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _UNITS[n] if n > 0 else "zero"
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + ("-" + _UNITS[rem] if rem else "")
    if n < 1000:
        hundreds, rem = divmod(n, 100)
        out = _UNITS[hundreds] + " hundred"
        return out + (" " + number_to_words(rem) if rem else "")
    for scale, name in _SCALES:
        if n >= scale:
            major, rem = divmod(n, scale)
            out = number_to_words(major) + " " + name
            return out + (" " + number_to_words(rem) if rem else "")
    raise ValueError(f"number too large: {n}")


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    head, _, last = words.rpartition(" ") if " " in words else ("", "", words)
    if "-" in last:
        tens, _, unit = last.rpartition("-")
        last = tens + "-" + _ordinalize_word(unit)
    else:
        last = _ordinalize_word(last)
    return (head + " " + last).strip()


def _ordinalize_word(w: str) -> str:
    if w in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[w]
    if w.endswith("y"):
        return w[:-1] + "ieth"
    if w.endswith("t"):  # hundred/thousand handled by suffix th
        return w + "h"
    return w + "th"


def year_to_words(n: int) -> str:
    """Verbalize a year the way people say it (1984 → nineteen eighty-four)."""
    if 1000 <= n <= 9999:
        high, low = divmod(n, 100)
        if low == 0:
            if high % 10 == 0:
                return number_to_words(n)  # 2000 → two thousand
            return number_to_words(high) + " hundred"
        if high % 10 == 0 and low < 10:
            # 2005 → two thousand five
            return number_to_words(high * 100) + " " + number_to_words(low)
        low_words = ("oh " + _UNITS[low]) if low < 10 else number_to_words(low)
        return number_to_words(high) + " " + low_words
    return number_to_words(n)


def _expand_decimal(match: re.Match) -> str:
    return _numeric_words(match.group(1) + "." + match.group(2))


def _numeric_words(numstr: str) -> str:
    """'1,234.56' → words; commas stripped, optional fraction spoken digit-wise."""
    numstr = numstr.replace(",", "")
    if "." in numstr:
        whole, frac = numstr.split(".", 1)
        digits = " ".join(_UNITS[int(d)] if d != "0" else "zero" for d in frac)
        return number_to_words(int(whole or 0)) + " point " + digits
    return number_to_words(int(numstr))


def _expand_currency(match: re.Match) -> str:
    amount = match.group(1).replace(",", "")
    if "." in amount:
        dollars, cents = amount.split(".")
        d, c = int(dollars or 0), int((cents + "0")[:2])
        parts = []
        if d:
            parts.append(number_to_words(d) + (" dollar" if d == 1 else " dollars"))
        if c:
            parts.append(number_to_words(c) + (" cent" if c == 1 else " cents"))
        return " and ".join(parts) if parts else "zero dollars"
    d = int(amount)
    return number_to_words(d) + (" dollar" if d == 1 else " dollars")


_RE_CURRENCY = re.compile(r"\$([0-9][0-9,]*(?:\.[0-9]+)?)")
# Comma-aware: "1,000th" must verbalize as one thousandth, not "one, zeroth"
# (the plain \d+ used to match only the post-comma group "000th").
_RE_ORDINAL = re.compile(r"\b([0-9]{1,3}(?:,[0-9]{3})+|[0-9]+)(st|nd|rd|th)\b")
# Letter↔digit boundaries: "Room 101B" / "4x4" / "3km" leave the digits glued to
# letters, where no \b-anchored number rule can reach them and the G2P tokenizer
# then silently DROPS them. Split the seam — except digit→(ordinal suffix | plural
# s), which the dedicated rules below handle in place.
_RE_ALPHA_NUM = re.compile(r"(?<=[A-Za-z])(?=[0-9])")
_RE_NUM_ALPHA = re.compile(r"(?<=[0-9])(?!(?:st|nd|rd|th|s)\b)(?=[A-Za-z])")
_RE_DECIMAL = re.compile(r"\b([0-9]+)\.([0-9]+)\b")
_RE_PERCENT = re.compile(r"\b([0-9][0-9,]*(?:\.[0-9]+)?)\s*%")
_RE_YEAR = re.compile(r"\b(1[0-9]{3}|20[0-9]{2})s?\b")
# Non-year digit→'s' plurals ('90s', '5s'): _RE_NUM_ALPHA exempts the seam so the
# year rule can own it, but the year rule only covers 4-digit years — without this
# rule the glued token starts with a digit and the G2P tokenizer silently drops it
# (that text produced NO audio).
_RE_NUM_PLURAL = re.compile(r"\b([0-9]+)s\b")
_RE_COMMA_NUM = re.compile(r"\b[0-9]{1,3}(?:,[0-9]{3})+(?:\.[0-9]+)?\b")
_RE_INT = re.compile(r"\b[0-9]+\b")
_RE_ABBREV = re.compile(r"\b([A-Za-z]+)\.(?=\s|$)")
_RE_WS = re.compile(r"\s+")


def _pluralize_words(words: str) -> str:
    """Pluralize the last word of a verbalized number ('ninety' → 'nineties',
    'five' → 'fives') so the result stays in lexicon territory."""
    head, _, last = words.rpartition(" ")
    last = last[:-1] + "ies" if last.endswith("y") else last + "s"
    return (head + " " + last) if head else last


def _expand_year(m: re.Match) -> str:
    """Year or decade: '1984' → 'nineteen eighty four'; '1980s' → 'nineteen
    eighties' (a plain +'s' would emit the non-word 'eightys', pushing a lexicon
    word into the unconstrained neural-OOV path)."""
    plural = m.group(0).endswith("s")
    words = year_to_words(int(m.group(0).rstrip("s")))
    return _pluralize_words(words) if plural else words


def normalize_text(text: str) -> str:
    """Full normalization pipeline: unicode → abbreviations → numbers → cleanup.

    Output preserves sentence punctuation (needed downstream for pause/prosody and for
    segmentation) but lowercases and verbalizes everything else.
    """
    for src, dst in _UNICODE_MAP.items():
        text = text.replace(src, dst)

    def abbrev_sub(m: re.Match) -> str:
        word = m.group(1)
        exp = _ABBREVIATIONS.get(word.lower())
        if not exp:
            return m.group(0)
        # Keep the period only at the true end of the text ("... pears, etc.") —
        # that's the unambiguous sentence-final case. A capitalized-next-word
        # heuristic misfires on the dominant title use ("Dr. Smith" must become
        # "doctor Smith", not "doctor. Smith"), and segmentation runs BEFORE
        # normalization in the serving path, so mid-text boundaries are already
        # decided by then.
        rest = m.string[m.end():]
        return exp + ("." if not rest.strip() else "")

    text = _RE_ABBREV.sub(abbrev_sub, text)
    text = _RE_CURRENCY.sub(_expand_currency, text)
    text = _RE_ALPHA_NUM.sub(" ", text)
    text = _RE_NUM_ALPHA.sub(" ", text)
    # Percent first but DECIMAL-AWARE ("3.5%" → "three point five percent"); then
    # comma-grouped numbers (which may carry a fraction) BEFORE the bare-decimal
    # rule so "1,234.56" isn't split at the comma.
    text = _RE_PERCENT.sub(lambda m: _numeric_words(m.group(1)) + " percent", text)
    text = _RE_ORDINAL.sub(
        lambda m: ordinal_to_words(int(m.group(1).replace(",", ""))), text
    )
    text = _RE_COMMA_NUM.sub(lambda m: _numeric_words(m.group(0)), text)
    text = _RE_DECIMAL.sub(_expand_decimal, text)
    text = _RE_YEAR.sub(_expand_year, text)
    text = _RE_NUM_PLURAL.sub(
        lambda m: _pluralize_words(number_to_words(int(m.group(1)))), text
    )
    text = _RE_INT.sub(lambda m: number_to_words(int(m.group(0))), text)
    text = _RE_WS.sub(" ", text).strip()
    return text

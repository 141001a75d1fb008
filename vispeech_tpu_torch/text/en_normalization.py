"""English text normalization (reference text/frontend/normalizer/).

Behavioral equivalent of the reference's English normalizer
(normalizer/normalizer.py:21-34, normalizer/numbers.py:28-98,
normalizer/width.py) without the external `inflect` dependency: the
number→words engine is implemented here in pure Python, matching inflect's
output conventions for the cases the normalizer exercises (hyphenated tens,
"oh" year groups, ordinal words).

Public API:
  normalize(sentence)        -- full English normalization pipeline
  normalize_numbers(text)    -- digits/currency/ordinals → words
  full2half_width / half2full_width -- CJK width folding helpers

The port's copy of ``vispeech_tpu/text/en_normalization.py``: the same behaviour, kept
in step with it by ``tests/test_torch_text.py``.
"""

from __future__ import annotations

import re
import unicodedata

__all__ = [
    "normalize",
    "normalize_numbers",
    "number_to_words",
    "ordinal_to_words",
    "full2half_width",
    "half2full_width",
]

# ---------------------------------------------------------------------------
# number → words (inflect-compatible for the normalizer's call patterns)
# ---------------------------------------------------------------------------

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 12, "trillion"),
    (10 ** 9, "billion"),
    (10 ** 6, "million"),
    (10 ** 3, "thousand"),
    (10 ** 2, "hundred"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _below_hundred(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def number_to_words(n: int) -> str:
    """Cardinal words, hyphenated tens, no 'and' (inflect andword='')."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 100:
        return _below_hundred(n)
    for scale, word in _SCALES:
        if n >= scale:
            head = number_to_words(n // scale)
            rest = n % scale
            out = f"{head} {word}"
            if rest:
                out += " " + number_to_words(rest)
            return out
    return _below_hundred(n)  # unreachable


def ordinal_to_words(n: int) -> str:
    """Ordinal words ('1'→'first', '23'→'twenty-third', '100'→'hundredth')."""
    words = number_to_words(n)
    head, sep, last = words.rpartition("-")
    if not sep:
        head, sep, last = words.rpartition(" ")
    if last in _ORDINAL_IRREGULAR:
        last = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return head + sep + last


def _year_words(n: int) -> str:
    """inflect's group=2 zero='oh' rendering used for 1001–2999
    (numbers.py:62-74): '1905'→'nineteen oh five', '1999'→'nineteen
    ninety-nine'."""
    high, low = divmod(n, 100)
    if low == 0:
        return number_to_words(high) + " hundred"
    if low < 10:
        return f"{number_to_words(high)} oh {_ONES[low]}"
    return f"{number_to_words(high)} {_below_hundred(low)}"


# ---------------------------------------------------------------------------
# regex cascade (reference normalizer/numbers.py:20-98)
# ---------------------------------------------------------------------------

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _expand_decimal_point(m: re.Match) -> str:
    return m.group(1).replace(".", " point ")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m: re.Match) -> str:
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        return _year_words(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    """Digits/currency/ordinals → English words (numbers.py:89-98)."""
    text = _comma_number_re.sub(_remove_commas, text)
    text = _pounds_re.sub(r"\1 pounds", text)
    text = _dollars_re.sub(_expand_dollars, text)
    text = _decimal_number_re.sub(_expand_decimal_point, text)
    text = _ordinal_re.sub(_expand_ordinal, text)
    text = _number_re.sub(_expand_number, text)
    return text


# ---------------------------------------------------------------------------
# full pipeline (reference normalizer/normalizer.py:21-34)
# ---------------------------------------------------------------------------

def normalize(sentence: str) -> str:
    """Normalize English text: numbers → words, strip accents, lowercase,
    restrict charset, expand i.e./e.g."""
    sentence = normalize_numbers(sentence)
    sentence = "".join(
        ch for ch in unicodedata.normalize("NFD", sentence)
        if unicodedata.category(ch) != "Mn"
    )
    sentence = sentence.lower()
    sentence = re.sub(r"[^ a-z'.,?!\-]", "", sentence)
    sentence = sentence.replace("i.e.", "that is")
    sentence = sentence.replace("e.g.", "for example")
    return sentence


# ---------------------------------------------------------------------------
# width folding (reference normalizer/width.py)
# ---------------------------------------------------------------------------

def full2half_width(ustr: str) -> str:
    half = []
    for u in ustr:
        num = ord(u)
        if num == 0x3000:  # ideographic space
            num = 32
        elif 0xFF01 <= num <= 0xFF5E:
            num -= 0xFEE0
        half.append(chr(num))
    return "".join(half)


def half2full_width(ustr: str) -> str:
    full = []
    for u in ustr:
        num = ord(u)
        if num == 32:
            num = 0x3000
        elif 0x21 <= num <= 0x7E:
            num += 0xFEE0
        full.append(chr(num))
    return "".join(full)

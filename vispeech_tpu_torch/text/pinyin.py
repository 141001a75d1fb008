"""Rule-based pinyin-syllable → phoneme conversion.

The same mapping as ``vispeech_tpu/text/pinyin.py``, computed from pinyin
phonology rather than a lexicon file:

  * initial = longest prefix among the 21 pinyin initials
  * orthographic finals are canonicalized (ui→uei, un→uen, iu→iou,
    y-/w- forms, ü written as v after j/q/x/y)
  * the apical vowel `i` after z/c/s becomes `ii`, after zh/ch/sh/r `iii`
  * a trailing `r` before the tone digit marks erhua and suffixes the final
  * the tone digit 1-5 attaches to the final
"""

from __future__ import annotations

import re
from typing import List, Optional

# Longest-match initials (multi-char first).
_INITIALS = [
    "zh", "ch", "sh",
    "b", "p", "m", "f", "d", "t", "n", "l",
    "g", "k", "h", "j", "q", "x", "r", "z", "c", "s",
]

# Zero-initial orthography → canonical final.
_Y_W_FINALS = {
    "yi": "i", "ya": "ia", "ye": "ie", "yao": "iao", "you": "iou",
    "yan": "ian", "yin": "in", "yang": "iang", "ying": "ing",
    "yong": "iong", "yo": "io",
    "yu": "v", "yue": "ve", "yuan": "van", "yun": "vn",
    "wu": "u", "wa": "ua", "wo": "uo", "wai": "uai", "wei": "uei",
    "wan": "uan", "wen": "uen", "wang": "uang", "weng": "ueng",
}

# Orthographic contractions after an initial.
_CONTRACTED = {"ui": "uei", "un": "uen", "iu": "iou"}

# After j/q/x the written u is ü.
_U_TO_V_INITIALS = {"j", "q", "x"}

_SYLLABLE_RE = re.compile(r"^([a-zü]+?)(r?)([1-5])$")

# z/c/s + i → ii (apical dental); zh/ch/sh/r + i → iii (apical retroflex).
_APICAL_DENTAL = {"z", "c", "s"}
_APICAL_RETROFLEX = {"zh", "ch", "sh", "r"}


def split_initial_final(body: str) -> (Optional[str], Optional[str]):
    """Split a toneless pinyin body into (initial, canonical final).

    Returns (None, None) when the body is not parseable pinyin.
    """
    body = body.replace("ü", "v")
    if not body:
        return None, None

    if body[0] in ("y", "w"):
        final = _Y_W_FINALS.get(body)
        if final is None:
            # 'y'/'w' + remaining handled by the table only; unknown otherwise
            return None, None
        return "", final

    initial = ""
    for cand in _INITIALS:
        if body.startswith(cand):
            initial = cand
            break
    final = body[len(initial):]

    if initial and not final:
        # Syllabic nasals / bare initials (n, m, r ...) have no final.
        return initial, ""
    if not initial:
        # Zero-initial vowel syllable: a, ai, an, ang, ao, e, ei, en, eng, er, o, ou
        return "", final

    if final == "i" and initial in _APICAL_DENTAL:
        final = "ii"
    elif final == "i" and initial in _APICAL_RETROFLEX:
        final = "iii"
    elif initial in _U_TO_V_INITIALS and final.startswith("u"):
        # Written u after j/q/x is ü: ju→jv, jue→jve, juan→jvan, jun→jvn.
        final = "v" + final[1:]
    else:
        final = _CONTRACTED.get(final, final)
    return initial, final


def pinyin_syllable_to_phones(syllable: str) -> List[str]:
    """One toned pinyin syllable (e.g. ``zhuang1`` / ``dianr3``) → phone list.

    Mirrors the reference lexicon contract: ``[initial, final+tone]`` or
    ``[final+tone]`` for zero-initial syllables (reference text/zh_dict.dict).
    Raises ValueError on unparseable input.
    """
    m = _SYLLABLE_RE.match(syllable.strip().lower())
    if not m:
        raise ValueError(f"not a toned pinyin syllable: {syllable!r}")
    body, erhua, tone = m.groups()
    # The regex body is non-greedy, so a trailing `r` lands in the erhua group.
    # `er`/`e`+r coincide textually, so parsing the minimal body and appending
    # `r` to the final is correct for every syllable in the inventory.
    initial, final = split_initial_final(body)
    if final is None:
        # Bare `r5` etc.: fold the r back into the body.
        initial, final = split_initial_final(body + erhua)
        erhua = ""
        if final is None:
            raise ValueError(f"unparseable pinyin: {syllable!r}")
    if erhua:
        final = final + "r"
    toned_final = final + tone if final else ""
    phones = []
    if initial:
        phones.append(initial)
    if toned_final:
        phones.append(toned_final)
    if not phones:
        raise ValueError(f"empty pinyin parse: {syllable!r}")
    return phones


def pinyin_to_phonemes(text: str) -> List[str]:
    """Space-separated toned pinyin → phones (reference text/zh_frontend.py:40-47).

    Unknown syllables are skipped with a warning, as in the reference.
    """
    phones: List[str] = []
    for syl in text.split(" "):
        if not syl:
            continue
        try:
            phones += pinyin_syllable_to_phones(syl)
        except ValueError:
            print("词典中无此拼音：", syl)
    return phones

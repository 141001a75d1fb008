"""Mandarin syllable lexicon generation (reference
text/frontend/generate_lexicon.py:40-158 behavior).

Enumerates every phonotactically valid (initial, final, erhua, tone)
combination, renders its orthographic pinyin (y/w rules, ü→u after j/q/x,
iou/uei/uen contractions, apical i collapse), and maps it to the phone pair —
the dictionary Montreal Forced Aligner consumes (syllables-as-words).

The inverse direction lives in vispeech_tpu_torch.text.pinyin; the two are
cross-validated in tests (parse(render(C,V,T)) == (C, V+T)).

The port's copy of ``vispeech_tpu/text/lexicon.py``: the same behaviour, kept
in step with it by ``tests/test_torch_text.py``.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Optional

INITIALS = [
    "b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
    "zh", "ch", "sh", "r", "z", "c", "s", "j", "q", "x",
]

FINALS = [
    "a", "ai", "ao", "an", "ang", "e", "er", "ei", "en", "eng", "o", "ou",
    "ong", "ii", "iii", "i", "ia", "iao", "ian", "iang", "ie", "io", "iou",
    "iong", "in", "ing", "u", "ua", "uai", "uan", "uang", "uei", "uo", "uen",
    "ueng", "v", "ve", "van", "vn",
]

_GROUP_NO_PALATAL = ["f", "g", "k", "h", "zh", "ch", "sh", "r", "z", "c", "s"]


def render_syllable(
    initial: str, final: str, erhua: str = "", tone: str = ""
) -> Optional[str]:
    """Orthographic pinyin for a phone pair, or None if phonotactically
    impossible (the reference's `rule`)."""
    C, V, R, T = initial, final, erhua, tone

    if V == "ii" and C not in ("z", "c", "s"):
        return None
    if V == "iii" and C not in ("zh", "ch", "sh", "r"):
        return None
    # palatal (i-/v-) finals never combine with the guttural/sibilant set
    if V not in ("ii", "iii") and V[0] in ("i", "v") and C in _GROUP_NO_PALATAL:
        return None
    if V.startswith("v"):
        if V in ("v", "ve"):
            if C not in ("j", "q", "x", "n", "l", ""):
                return None
        elif C not in ("j", "q", "x", ""):
            return None
    if C in ("j", "q", "x") and not (
        V not in ("ii", "iii") and V[0] in ("i", "v")
    ):
        return None
    if C in ("b", "p", "m", "f") and (
        (V[0] in ("u", "v") and V != "u") or V == "ong"
    ):
        return None
    if V in ("ua", "uai", "uang") and C in (
        "d", "t", "n", "l", "r", "z", "c", "s"
    ):
        return None
    if V == "ong" and C == "sh":
        return None
    if V == "o" and C in (
        "d", "t", "n", "g", "k", "h", "zh", "ch", "sh", "r", "z", "c", "s"
    ):
        return None
    if V == "ueng" and C != "":
        return None
    if V == "er" and C != "":
        return None

    if C == "":
        if V in ("i", "in", "ing"):
            C = "y"
        elif V == "u":
            C = "w"
        elif V.startswith("i") and V not in ("ii", "iii"):
            C, V = "y", V[1:]
        elif V.startswith("u"):
            C, V = "w", V[1:]
        elif V.startswith("v"):
            C, V = "yu", V[1:]
    else:
        if C in ("j", "q", "x") and V.startswith("v"):
            V = V.replace("v", "u")
        if V == "iou":
            V = "iu"
        elif V == "uei":
            V = "ui"
        elif V == "uen":
            V = "un"
    result = C + V
    if result.endswith("r") and R == "r":
        return None
    result = re.sub(r"i+", "i", result)
    return result + R + T


def generate_lexicon(
    with_tone: bool = False, with_erhua: bool = False
) -> Dict[str, str]:
    """{syllable: "INITIAL FINAL[r][TONE]"} over all valid combinations
    (reference generate_lexicon, text/frontend/generate_lexicon.py:147-158)."""
    syllables: "OrderedDict[str, str]" = OrderedDict()
    for C in [""] + INITIALS:
        for V in FINALS:
            for R in ([""] if not with_erhua else ["", "r"]):
                for T in ([""] if not with_tone else ["1", "2", "3", "4", "5"]):
                    s = render_syllable(C, V, R, T)
                    if s:
                        syllables[s] = f"{C} {V}{R}{T}".strip()
    return syllables


# Tokens MFA dictionaries carry besides language phones: padding, silence
# variants, and the punctuation the alignment transcripts keep (reference
# mfa_temp/{zh,ja}_dict.dict header rows).
MFA_SPECIALS = ["_", "sp", "sil", "spn", "!", "?", "…", ",", ".", "-", "#"]


def generate_ja_lexicon() -> Dict[str, str]:
    """MFA Japanese dictionary (reference mfa_temp/ja_dict.dict contract).

    Japanese is aligned phones-as-words: every JA phone maps to itself, with
    the ``.`` suffix swapped for the literal ``JA`` token (MFA's dict format
    cannot hold a bare ``.`` inside a symbol — tools/prepare_mfa.py applies
    the same swap to the transcripts it emits)."""
    from vispeech_tpu_torch.text.symbols import ja_symbols

    lex: "OrderedDict[str, str]" = OrderedDict((s, s) for s in MFA_SPECIALS)
    for ph in ja_symbols:
        tok = ph.replace(".", "JA")
        lex[tok] = tok
    return lex

"""Phoneme vocabulary: the id ↔ symbol contract shared with checkpoints.

The same 519 symbols in the same order as ``vispeech_tpu/text/symbols.py``:
``_`` pad + 401 zh + 42 ja + 69 ARPABET + 6 punctuation.  The Mandarin block
is the sorted union of the 21 pinyin initials and {final + tone} for every
(final | erhua final) × tone 1–5.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

ZH_INITIALS: Sequence[str] = (
    "b", "c", "ch", "d", "f", "g", "h", "j", "k", "l", "m", "n",
    "p", "q", "r", "s", "sh", "t", "x", "z", "zh",
)

ZH_FINALS: Sequence[str] = (
    "a", "ai", "an", "ang", "ao",
    "e", "ei", "en", "eng", "er",
    "i", "ia", "ian", "iang", "iao", "ie", "ii", "iii", "in", "ing",
    "io", "iong", "iou",
    "o", "ong", "ou",
    "u", "ua", "uai", "uan", "uang", "uei", "uen", "ueng", "uo",
    "v", "van", "ve", "vn",
)

ZH_ERHUA_FINALS: Sequence[str] = tuple(f + "r" for f in ZH_FINALS if f != "er")

TONES: Sequence[str] = ("1", "2", "3", "4", "5")

zh_symbols: List[str] = sorted(
    [*ZH_INITIALS,
     *{f + t for f in (*ZH_FINALS, *ZH_ERHUA_FINALS) for t in TONES}]
)

ja_symbols: List[str] = [
    "ts.", "f.", "sh.", "ry.", "py.", "h.", "p.", "N.", "a.", "m.", "w.", "ky.",
    "n.", "d.", "j.", "cl.", "ny.", "z.", "o.", "y.", "t.", "u.", "r.", "pau",
    "ch.", "e.", "b.", "k.", "g.", "s.", "i.",
    "gy.", "my.", "hy.", "br", "by.", "v.", "ty.", "xx.", "U.", "I.", "dy.",
]

_EN_VOWELS = ("AA", "AE", "AH", "AO", "AW", "AY")
en_symbols: List[str] = (
    [v + s for v in _EN_VOWELS for s in "012"]
    + ["B", "CH", "D", "DH"]
    + [v + s for v in ("EH", "ER", "EY") for s in "012"]
    + ["F", "G", "HH"]
    + [v + s for v in ("IH", "IY") for s in "012"]
    + ["JH", "K", "L", "M", "N", "NG"]
    + [v + s for v in ("OW", "OY") for s in "012"]
    + ["P", "R", "S", "SH", "T", "TH"]
    + [v + s for v in ("UH", "UW") for s in "012"]
    + ["V", "W", "Y", "Z", "ZH"]
)

pu_symbols: List[str] = ["!", "?", "…", ",", ".", "sp"]

PAD = "_"
symbols: List[str] = [PAD] + zh_symbols + ja_symbols + en_symbols + pu_symbols

SYMBOL_TO_ID: Dict[str, int] = {s: i for i, s in enumerate(symbols)}
ID_TO_SYMBOL: Dict[int, str] = dict(enumerate(symbols))

N_SYMBOLS = len(symbols)

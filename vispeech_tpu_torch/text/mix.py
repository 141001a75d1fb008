"""Mixed-language segmentation for text outside explicit language blocks.

Character-class segmentation (zh / en / ja / other) with per-segment dispatch,
matching the reference's PaddleSpeech-style MixFrontend
(reference text/mix_frontend.py:49-125): digits and ASCII punctuation count as
Chinese; "other" characters attach to the running segment.

The port's copy of ``vispeech_tpu/text/mix.py``: the same behaviour, kept
in step with it by ``tests/test_torch_text.py``.
"""

from __future__ import annotations

import re
from string import punctuation
from typing import List, Tuple

_JA_CHAR = re.compile(r"[々぀-ヿ一-鿿１-９Ａ-Ｚａ-ｚｦ-ﾝ]")

# reference text/mix_frontend.py:36-43 — a second, colon-preserving punct table
_PUNCT_SRC = ["：", "；", "，", "。", "！", "？", "【", "】", "“", "（", "）", "%", "#",
              "@", "&", "‘", "\n", "”", "—", "·", "、"]
_PUNCT_DST = [":", ";", ",", ".", "!", "?", "[", "]", '"', "(", ")", "%", "#",
              "@", "&", "'", "", '"', "-", "-", ","]


def _str_replace(text: str) -> str:
    for src, dst in zip(_PUNCT_SRC, _PUNCT_DST):
        if src in text:
            text = text.replace(src, dst)
    return text


def _char_class(ch: str) -> str:
    if "一" <= ch <= "龥" or "0" <= ch <= "9" or ch in punctuation:
        return "zh"
    if "A" <= ch <= "Z" or "a" <= ch <= "z":
        return "en"
    if _JA_CHAR.match(ch):
        return "ja"
    return "other"


def get_segments(text: str) -> List[Tuple[str, str]]:
    """Split text into (segment, language) runs (reference mix_frontend.py:78-123)."""
    text = _str_replace(text)
    if not text:
        return []
    segments: List[Tuple[str, str]] = []
    seg, lang = text[0], _char_class(text[0])
    for ch in text[1:]:
        cls = _char_class(ch)
        if lang == "other":
            # an 'other' run adopts the first concrete language that follows
            seg += ch
            if cls != "other":
                lang = cls
        elif cls == lang or cls == "other":
            seg += ch
        else:
            segments.append((seg, lang))
            seg, lang = ch, cls
    segments.append((seg, lang))
    return segments


def others_to_phonemes(text: str) -> List[str]:
    """Dispatch unfenced text per segment (reference mix_frontend.py:10-24)."""
    from vispeech_tpu_torch.text.frontends import (
        en_to_phonemes,
        ja_to_phonemes,
        zh_to_phonemes,
    )

    if text == "":
        return []
    phones: List[str] = []
    for seg, lang in get_segments(text):
        if lang in ("zh", "other"):
            phones += zh_to_phonemes(seg)
        elif lang == "en":
            phones += en_to_phonemes(seg)
        elif lang == "ja":
            phones += ja_to_phonemes(seg)
    return phones

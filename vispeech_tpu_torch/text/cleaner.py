"""Top-level text cleaner: punctuation mapping + language-block dispatch.

The same contract as ``vispeech_tpu/text/cleaner.py``:
  * full-width → half-width punctuation table
  * ``[ZH]..[ZH]`` / ``[JA]..[JA]`` / ``[EN]..[EN]`` / ``[P]..[P]`` blocks route
    to the per-language frontends; text outside any block goes through
    character-class language segmentation (mix frontend)
  * phones not in the vocabulary are dropped (with a warning); ``-``/``--``
    map to ``sp``
"""

from __future__ import annotations

import re
from typing import List

from vispeech_tpu_torch.text import cleaned_text_to_sequence
from vispeech_tpu_torch.text.frontends import en_to_phonemes, ja_to_phonemes, zh_to_phonemes
from vispeech_tpu_torch.text.mix import others_to_phonemes
from vispeech_tpu_torch.text.pinyin import pinyin_to_phonemes
from vispeech_tpu_torch.text.symbols import symbol_set

_PHONE_ALIASES = {"-": "sp", "--": "sp"}

_PUNCT_SRC = ["：", "；", "，", "。", "！", "？", "【", "】", "“", "（", "）", "%", "#",
              "@", "&", "‘", "\n", "”", "—", "·", "、", "...", "―", "～"]
_PUNCT_DST = [",", ",", ",", ".", "!", "?", "[", "]", '"', "(", ")", "%", "#",
              "@", "&", "'", "", '"', "-", "-", ",", "…", ",", ","]

_BLOCK_RE = re.compile(r"\[(JA|ZH|EN|P)\](.*?)\[\1\]")


def str_replace(text: str) -> str:
    for src, dst in zip(_PUNCT_SRC, _PUNCT_DST):
        text = text.replace(src, dst)
    return text


def remove_invalid_phonemes(phonemes: List[str]) -> List[str]:
    valid = symbol_set()
    out = []
    for ph in phonemes:
        ph = _PHONE_ALIASES.get(ph, ph)
        if ph in valid:
            out.append(ph)
        else:
            print("skip：", ph)
    return out


_DISPATCH = {
    "P": pinyin_to_phonemes,
    "JA": ja_to_phonemes,
    "ZH": zh_to_phonemes,
    "EN": en_to_phonemes,
}


def text_to_phones(text: str) -> List[str]:
    text = str_replace(text).replace('"', "")
    phonemes: List[str] = []
    last_end = 0
    for block in _BLOCK_RE.finditer(text):
        start, end = block.span()
        phonemes += others_to_phonemes(text[last_end:start])
        last_end = end
        phonemes += _DISPATCH[block.group(1)](block.group(2))
    phonemes += others_to_phonemes(text[last_end:])
    return remove_invalid_phonemes(phonemes)


def text_to_sequence(text: str) -> List[int]:
    return cleaned_text_to_sequence(text_to_phones(text))

"""Text cleaner: punctuation mapping and the ``[P]…[P]`` pinyin block path.

Only pinyin blocks have a frontend in this package.  Any other text (a
``[ZH]``, ``[EN]`` or ``[JA]`` block, or characters outside a block) raises a
``ValueError`` that names the frontend it would need.  Phones outside the
vocabulary are dropped with a warning; ``-`` / ``--`` map to ``sp``.
"""

from __future__ import annotations

import re
from typing import List

from vispeech_tpu_torch.text.pinyin import pinyin_to_phonemes
from vispeech_tpu_torch.text.symbols import SYMBOL_TO_ID

_PHONE_ALIASES = {"-": "sp", "--": "sp"}

_PUNCT_SRC = ["：", "；", "，", "。", "！", "？", "【", "】", "“", "（", "）", "%", "#",
              "@", "&", "‘", "\n", "”", "—", "·", "、", "...", "―", "～"]
_PUNCT_DST = [",", ",", ",", ".", "!", "?", "[", "]", '"', "(", ")", "%", "#",
              "@", "&", "'", "", '"', "-", "-", ",", "…", ",", ","]

_BLOCK_RE = re.compile(r"\[(JA|ZH|EN|P)\](.*?)\[\1\]")

_FRONTENDS = {"ZH": "Mandarin (zh)", "EN": "English (en)", "JA": "Japanese (ja)"}


def str_replace(text: str) -> str:
    for src, dst in zip(_PUNCT_SRC, _PUNCT_DST):
        text = text.replace(src, dst)
    return text


def remove_invalid_phonemes(phonemes: List[str]) -> List[str]:
    out = []
    for ph in phonemes:
        ph = _PHONE_ALIASES.get(ph, ph)
        if ph in SYMBOL_TO_ID:
            out.append(ph)
        else:
            print("skip：", ph)
    return out


def _reject_unfenced(text: str) -> None:
    if text.strip():
        raise ValueError(
            f"text outside a [P]...[P] block ({text.strip()[:40]!r}) needs the "
            "zh/en/ja text frontend, which vispeech_tpu_torch does not have "
            "yet; write the text as toned pinyin inside [P]...[P]")


def text_to_phones(text: str) -> List[str]:
    text = str_replace(text).replace('"', "")
    phonemes: List[str] = []
    last_end = 0
    for block in _BLOCK_RE.finditer(text):
        start, end = block.span()
        _reject_unfenced(text[last_end:start])
        last_end = end
        lang = block.group(1)
        if lang != "P":
            raise ValueError(
                f"a [{lang}] block needs the {_FRONTENDS[lang]} text frontend, "
                "which vispeech_tpu_torch does not have yet")
        phonemes += pinyin_to_phonemes(block.group(2))
    _reject_unfenced(text[last_end:])
    return remove_invalid_phonemes(phonemes)

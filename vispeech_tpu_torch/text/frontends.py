"""Per-language G2P frontends (zh / ja / en) with gated optional dependencies.

Behavioral contract from the reference:
  * zh: normalize punctuation, then PaddleSpeech-style frontend — text
    normalization → jieba segmentation → pypinyin G2P → tone sandhi → phones
    (reference text/zh_frontend.py:33-37, text/frontend/zh_frontend.py:257-287).
  * ja: pyopenjtalk g2p per Japanese segment; phones suffixed ``.`` except
    punctuation/``pau`` (reference text/ja_frontend.py:77-100).
  * en: lexicon lookup with g2p_en fallback → ARPABET with stress
    (reference text/en_frontend.py:7-33).

Heavy external G2P engines (pypinyin, pyopenjtalk, g2p_en) are optional; when
absent the corresponding language raises FrontendUnavailable so callers can
degrade gracefully.  Pinyin input (``[P]`` blocks) never needs them.

The port's copy of ``vispeech_tpu/text/frontends.py``: the same behaviour, kept
in step with it by ``tests/test_torch_text.py``.
"""

from __future__ import annotations

import re
from typing import List

from vispeech_tpu_torch.text.pinyin import pinyin_syllable_to_phones
from vispeech_tpu_torch.text.symbols import pu_symbols as _pu


class FrontendUnavailable(RuntimeError):
    """Raised when an optional G2P backend is not installed."""


# ---------------------------------------------------------------------------
# Chinese
# ---------------------------------------------------------------------------

_ZH_PUNCT_TABLE = {
    "！": "!", "？": "?", "…": "…", "，": ",", "。": ".", "、": ",", "...": "…",
}


def zh_punct_replace(text: str) -> str:
    """Reference text/zh_frontend.py:16-22."""
    for src, tgt in _ZH_PUNCT_TABLE.items():
        text = text.replace(src, tgt)
    return text


def _try_import_zh_g2p():
    try:
        from pypinyin import lazy_pinyin, Style  # noqa: F401

        return True
    except ImportError:
        return False


_HAS_PYPINYIN = _try_import_zh_g2p()
# punctuation that survives the zh path as its own phone (the reference's
# frontend emits any non-hanzi char as an "initial"; the cleaner later maps
# '-' → 'sp' and drops anything not in the vocabulary)
_ZH_PUNCT_PASSTHROUGH = set("!?,.…#-")


def zh_to_phonemes(text: str) -> List[str]:
    """Mandarin text → phones.

    With pypinyin+jieba installed this runs the full normalize→segment→G2P→
    sandhi cascade (vispeech_tpu_torch.text.zh_g2p); without them, digits/punctuation
    are still handled and hanzi raise FrontendUnavailable.
    """
    text = zh_punct_replace(text)
    from vispeech_tpu_torch.text.normalization import TextNormalizer

    sentences = TextNormalizer().normalize(text)
    phones: List[str] = []
    for sent in sentences:
        phones += _zh_sentence_to_phonemes(sent)
    return phones


_ZH_LEXICON: dict = {}   # word → list of tone3 pinyin syllables
_ZH_LEX_MAXLEN = 1


def load_zh_lexicon(path: str) -> None:
    """Load a hanzi→pinyin lexicon (lines ``word pin1 yin1 ...``) used for
    Mandarin G2P when pypinyin is unavailable.  Longest-match segmentation +
    tone sandhi still apply, so multi-character entries give jieba-like
    behavior for the words they cover."""
    global _ZH_LEX_MAXLEN
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                _ZH_LEXICON[parts[0]] = parts[1:]
                _ZH_LEX_MAXLEN = max(_ZH_LEX_MAXLEN, len(parts[0]))


# Single-character polyphone overrides, mirroring the reference's pypinyin
# reading-order tweak (reference text/frontend/zh_frontend.py:86
# load_single_dict({'地': 'de,di4'}) — prefer the neutral particle reading).
# Applied only to characters that fall through to single-char lookup; words
# covered by multi-character lexicon entries keep their lexical reading.
_POLYPHONE_SINGLE = {"地": "de5"}


def _lexicon_zh_g2p(text: str) -> List[str]:
    """Greedy longest-match lexicon G2P with tone sandhi (pypinyin-free)."""
    from vispeech_tpu_torch.text.sandhi import ToneSandhi

    sandhi = ToneSandhi()
    words = []
    i = 0
    while i < len(text):
        for L in range(min(_ZH_LEX_MAXLEN, len(text) - i), 0, -1):
            w = text[i:i + L]
            if L == 1 and w in _POLYPHONE_SINGLE:
                words.append((w, [_POLYPHONE_SINGLE[w]]))
                i += 1
                break
            if w in _ZH_LEXICON:
                words.append((w, _ZH_LEXICON[w]))
                i += L
                break
        else:
            ch = text[i]
            if ch in _ZH_PUNCT_PASSTHROUGH:
                words.append((ch, None))
            elif re.match(r"[一-鿿]", ch):
                raise FrontendUnavailable(
                    f"hanzi {ch!r} not in the loaded zh lexicon"
                )
            i += 1
    phones: List[str] = []
    for w, sylls in words:
        if sylls is None:
            phones.append(w)
            continue
        initials, finals = [], []
        for s in sylls:
            ph = pinyin_syllable_to_phones(s)
            if len(ph) == 2:
                initials.append(ph[0])
                finals.append(ph[1])
            else:
                initials.append("")
                finals.append(ph[0])
        finals = sandhi.modified_tone(w, "n", finals)
        for c, v in zip(initials, finals):
            if c:
                phones.append(c)
            if v:
                phones.append(v)
    return phones


def _zh_sentence_to_phonemes(text: str) -> List[str]:
    if not text:
        return []
    if _HAS_PYPINYIN:
        from vispeech_tpu_torch.text.zh_g2p import hanzi_to_phonemes

        return hanzi_to_phonemes(text)
    if _ZH_LEXICON:
        return _lexicon_zh_g2p(text)
    # Degraded mode: punctuation passes through, hanzi are unpronounceable.
    out: List[str] = []
    if re.search(r"[一-鿿]", text):
        raise FrontendUnavailable(
            "Mandarin G2P requires pypinyin (not installed); use [P] pinyin "
            "blocks or load a lexicon via load_zh_lexicon()"
        )
    for ch in text:
        if ch in _ZH_PUNCT_PASSTHROUGH:
            out.append(ch)
    return out


# ---------------------------------------------------------------------------
# Japanese
# ---------------------------------------------------------------------------

_JA_CHARS = re.compile(
    r"[A-Za-z\d々぀-ヿ一-鿿１-９Ａ-Ｚ"
    r"ａ-ｚｦ-ﾝ]"
)
_JA_MARKS = re.compile(
    r"[^A-Za-z\d々぀-ヿ一-鿿１-９Ａ-Ｚ"
    r"ａ-ｚｦ-ﾝ]"
)


def _try_import_ja_g2p():
    try:
        import pyopenjtalk  # noqa: F401

        return True
    except ImportError:
        return False


_HAS_PYOPENJTALK = _try_import_ja_g2p()


def ja_to_phonemes(text: str) -> List[str]:
    """Japanese text → phones with ``.`` suffix (reference text/ja_frontend.py:77-100)."""
    if not _HAS_PYOPENJTALK:
        raise FrontendUnavailable("Japanese G2P requires pyopenjtalk (not installed)")
    import pyopenjtalk

    text = text.replace("％", "パーセント")
    sentences = _JA_MARKS.split(text)
    marks = _JA_MARKS.findall(text)
    raw: List[str] = []
    for i, sentence in enumerate(sentences):
        if _JA_CHARS.match(sentence):
            raw += pyopenjtalk.g2p(sentence).split(" ")
        if i < len(marks):
            raw.append(marks[i].replace(" ", ""))
    out = []
    for p in raw:
        if p == "":
            continue
        out.append(p if p in (*_pu, "pau", "-") else p + ".")
    return out


# ---------------------------------------------------------------------------
# English
# ---------------------------------------------------------------------------

def _try_import_en_g2p():
    try:
        from g2p_en import G2p  # noqa: F401

        return True
    except ImportError:
        return False


_HAS_G2PEN = _try_import_en_g2p()
_EN_LEXICON: dict = {}


def load_en_lexicon(path: str) -> None:
    """Load a CMUdict-style lexicon (word PHONES...) used before g2p_en fallback
    (reference text/en_frontend.py:20-33; the reference's en_dict.dict blob)."""
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = re.split(r"\s+", line.strip())
            if len(parts) >= 2 and parts[0].lower() not in _EN_LEXICON:
                _EN_LEXICON[parts[0].lower()] = parts[1:]


def en_to_phonemes(text: str) -> List[str]:
    """English text → ARPABET phones (reference text/en_frontend.py:7-17).

    Digits/currency/ordinals are verbalized first (reference ships this in
    text/frontend/normalizer/numbers.py; g2p_en does it internally, but the
    lexicon-only fallback path needs it done up front)."""
    from string import punctuation

    from vispeech_tpu_torch.text.en_normalization import normalize_numbers

    text = normalize_numbers(text)
    text = text.rstrip(punctuation)
    words = re.split(r"([,;.\-\?\!\s+])", text)
    phones: List[str] = []
    g2p = None
    for w in words:
        if not w or w.isspace():
            continue
        if w.lower() in _EN_LEXICON:
            phones += _EN_LEXICON[w.lower()]
        elif w in ",;.-?!":
            phones.append(w)
        else:
            if not _HAS_G2PEN:
                raise FrontendUnavailable(
                    "English G2P requires g2p_en (not installed) or a lexicon "
                    "loaded via load_en_lexicon()"
                )
            if g2p is None:
                from g2p_en import G2p

                g2p = G2p()
            phones += [p for p in g2p(w) if p != " "]
    return phones

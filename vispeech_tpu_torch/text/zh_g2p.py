"""Mandarin hanzi → phoneme G2P (requires pypinyin + jieba).

Pipeline per normalized sentence (reference text/frontend/zh_frontend.py:123-175,
257-287): strip latin, jieba POS segmentation → sandhi pre-merge → per-word
pypinyin (initials / FINALS_TONE3 with neutral-tone-as-5) → ii/iii apical-vowel
discrimination → tone sandhi → optional erhua merge → phone assembly.

The port's copy of ``vispeech_tpu/text/zh_g2p.py``: the same behaviour, kept
in step with it by ``tests/test_torch_text.py``.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from vispeech_tpu_torch.text.sandhi import ToneSandhi

_PUNC = ["!", "?", "…", ",", ".", "#", "-"]

MUST_ERHUA = {"小院儿", "胡同儿", "范儿", "老汉儿", "撒欢儿", "寻老礼儿", "妥妥儿"}
NOT_ERHUA = {
    "虐儿", "为儿", "护儿", "瞒儿", "救儿", "替儿", "有儿", "一儿", "我儿", "俺儿", "妻儿",
    "拐儿", "聋儿", "乞儿", "患儿", "幼儿", "孤儿", "婴儿", "婴幼儿", "连体儿", "脑瘫儿",
    "流浪儿", "体弱儿", "混血儿", "蜜雪儿", "舫儿", "祖儿", "美儿", "应采儿", "可儿", "侄儿",
    "孙儿", "侄孙儿", "女儿", "男儿", "红孩儿", "花儿", "虫儿", "马儿", "鸟儿", "猪儿", "猫儿",
    "狗儿",
}

_sandhi = ToneSandhi()
_initialized = False

# ---------------------------------------------------------------- backends
# Word-level G2P backend slot (reference zh_frontend.py:60-66,91-121: the
# frontend is constructed with g2p_model="pypinyin" OR "g2pM", a neural
# polyphone-disambiguation model).  Protocol: fn(word) -> list of tone3
# pinyin syllables, one per hanzi character.  "pypinyin" stays the default
# (as in the reference); "g2pM" is gated on the optional g2pM package; any
# callable can be injected for custom/neural backends (tests inject a fake).
_g2p_backend: str = "pypinyin"
_g2p_backend_fn = None  # word -> List[str] tone3 pinyins (non-pypinyin)


def set_g2p_backend(backend) -> None:
    """Select the Mandarin word→pinyin backend.

    ``backend``: ``"pypinyin"`` (default), ``"g2pM"`` (requires the g2pM
    package — ImportError with guidance if absent), or any callable
    ``word -> List[str]`` of tone3 pinyin syllables (one per character).
    """
    global _g2p_backend, _g2p_backend_fn
    if backend == "pypinyin":
        _g2p_backend, _g2p_backend_fn = "pypinyin", None
        ToneSandhi.finals_fn = None
        return
    if backend == "g2pM":
        try:
            from g2pM import G2pM  # type: ignore
        except ImportError as e:  # pragma: no cover - optional dep
            raise ImportError(
                "g2pM backend requires the g2pM package (pip install g2pM); "
                "the default pypinyin backend needs no extra install"
            ) from e
        model = G2pM()
        fn = lambda word: model(word, tone=True, char_split=False)  # noqa: E731
        _g2p_backend, _g2p_backend_fn = "g2pM", fn
    elif callable(backend):
        _g2p_backend = getattr(backend, "__name__", "custom")
        _g2p_backend_fn = backend
    else:
        raise ValueError(
            f"unknown zh G2P backend {backend!r}: expected 'pypinyin', "
            "'g2pM', or a callable word -> tone3-pinyin list")
    # sandhi's segment pre-merge consults word finals: point it at the same
    # backend so tone decisions match the emitted phones
    ToneSandhi.finals_fn = (
        lambda word: pinyins_to_initials_finals(_g2p_backend_fn(word))[1]
    )


def get_g2p_backend() -> str:
    return _g2p_backend


def pinyins_to_initials_finals(
    pinyins: List[str],
) -> Tuple[List[str], List[str]]:
    """Tone3 pinyin syllables → (initials, finals) with the ü→v and
    apical-vowel conventions (the reference's pinyin2phone lexicon lookup,
    zh_frontend.py:106-121, computed by rule via text/pinyin.py).
    Non-pinyin tokens (punctuation the model echoes back) pass through as
    their own 'final' with an empty initial, exactly as the reference does.
    """
    from vispeech_tpu_torch.text.pinyin import pinyin_syllable_to_phones

    initials: List[str] = []
    finals: List[str] = []
    for p in pinyins:
        p = p.replace("u:", "v")
        if p and p.isalpha():  # toneless neutral reading → explicit tone 5
            p = p + "5"
        try:
            phones = pinyin_syllable_to_phones(p)
        except (ValueError, KeyError):
            phones = None
        if phones and len(phones) == 2:
            initials.append(phones[0])
            finals.append(phones[1])
        elif phones and len(phones) == 1:
            initials.append("")
            finals.append(phones[0])
        else:  # not pinyin (e.g. punctuation): passthrough
            initials.append(p)
            finals.append(p)
    return initials, finals


def _init_pypinyin() -> None:
    """One-time pypinyin dictionary tweaks (reference zh_frontend.py:71-86)."""
    global _initialized
    if _initialized:
        return
    from pypinyin import load_single_dict

    try:
        from pypinyin_dict.phrase_pinyin_data import large_pinyin

        large_pinyin.load()
    except ImportError:
        pass
    # prefer the neutral reading of 地 (de) over dì
    load_single_dict({ord("地"): "de,di4"})
    _initialized = True


def word_to_initials_finals(word: str) -> Tuple[List[str], List[str]]:
    """pypinyin G2P for one word with apical-vowel discrimination
    (reference zh_frontend.py:88-103)."""
    from pypinyin import Style, lazy_pinyin

    initials = lazy_pinyin(word, neutral_tone_with_five=True, style=Style.INITIALS)
    finals = lazy_pinyin(word, neutral_tone_with_five=True, style=Style.FINALS_TONE3)
    out_i, out_f = [], []
    for c, v in zip(initials, finals):
        if re.match(r"i\d", v):
            if c in ("z", "c", "s"):
                v = "i" + v  # i → ii
            elif c in ("zh", "ch", "sh", "r"):
                v = "ii" + v  # i → iii
        out_i.append(c)
        out_f.append(v)
    return out_i, out_f


def _merge_erhua(
    initials: List[str], finals: List[str], word: str, pos: str
) -> Tuple[List[str], List[str]]:
    """Fold a trailing 儿 into the previous final's r-colored form
    (reference zh_frontend.py:177-201)."""
    if word not in MUST_ERHUA and (word in NOT_ERHUA or pos in ("a", "j", "nr")):
        return initials, finals
    if len(finals) != len(word):
        return initials, finals
    new_i: List[str] = []
    new_f: List[str] = []
    for i, phn in enumerate(finals):
        if (
            i == len(finals) - 1
            and word[i] == "儿"
            and phn in ("er2", "er5")
            and word[-2:] not in NOT_ERHUA
            and new_f
        ):
            new_f[-1] = new_f[-1][:-1] + "r" + new_f[-1][-1]
        else:
            new_f.append(phn)
            new_i.append(initials[i])
    return new_i, new_f


def sentence_to_phonemes(sentence: str, with_erhua: bool = False) -> List[str]:
    """One normalized sentence → phones."""
    import jieba.posseg as psg

    if _g2p_backend_fn is None:  # alternate backends don't need pypinyin
        _init_pypinyin()
    sentence = re.sub("[a-zA-Z]+", "", sentence)
    seg = [(w, p) for w, p in psg.lcut(sentence)]
    seg = _sandhi.pre_merge_for_modify(seg)
    phones: List[str] = []
    for word, pos in seg:
        if pos == "eng":
            continue
        if _g2p_backend_fn is not None:
            initials, finals = pinyins_to_initials_finals(_g2p_backend_fn(word))
        else:
            initials, finals = word_to_initials_finals(word)
        finals = _sandhi.modified_tone(word, pos, finals)
        if with_erhua:
            initials, finals = _merge_erhua(initials, finals, word, pos)
        for c, v in zip(initials, finals):
            if c:
                phones.append(c)
            if v and v not in _PUNC:
                phones.append(v)
    return phones


def hanzi_to_phonemes(text: str, with_erhua: bool = False) -> List[str]:
    """Normalized text (single sentence or fragment) → phones.

    The ``嗯→恩`` substitution and trailing-``sp`` trim mirror
    reference zh_frontend.py:263 and 167-174.
    """
    text = text.replace("嗯", "恩")
    phones = sentence_to_phonemes(text, with_erhua=with_erhua)
    if phones and phones[-1] == "sp":
        phones = phones[:-1]
    return phones

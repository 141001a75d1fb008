"""Text frontend: text → phoneme symbols → integer id sequences.

The same public surface as ``vispeech_tpu/text/__init__.py``:
  text_to_phones(text)          -> List[str]
  text_to_sequence(text)        -> List[int]
  cleaned_text_to_sequence(phs) -> List[int]

Text may hold ``[P]``, ``[ZH]``, ``[EN]`` and ``[JA]`` blocks and unfenced
mixed-language text (``cleaner.py``).  Hanzi need jieba and either pypinyin
or a lexicon loaded with ``frontends.load_zh_lexicon``; English words not in
a lexicon loaded with ``frontends.load_en_lexicon`` need g2p_en; Japanese
needs pyopenjtalk.
"""

from typing import List, Sequence

from vispeech_tpu_torch.text.symbols import ID_TO_SYMBOL, N_SYMBOLS, SYMBOL_TO_ID, symbols  # noqa: F401


def cleaned_text_to_sequence(cleaned_text: Sequence[str]) -> List[int]:
    """Phoneme symbol list → id list."""
    return [SYMBOL_TO_ID[symbol] for symbol in cleaned_text]


def sequence_to_symbols(sequence: Sequence[int]) -> List[str]:
    return [ID_TO_SYMBOL[i] for i in sequence]


def text_to_phones(text: str) -> List[str]:
    from vispeech_tpu_torch.text.cleaner import text_to_phones as _ttp

    return _ttp(text)


def text_to_sequence(text: str) -> List[int]:
    return cleaned_text_to_sequence(text_to_phones(text))

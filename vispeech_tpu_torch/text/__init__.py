"""Text frontend: ``[P]pinyin[P]`` text → phoneme symbols → id sequences."""

from typing import List, Sequence

from vispeech_tpu_torch.text.symbols import N_SYMBOLS, SYMBOL_TO_ID  # noqa: F401


def cleaned_text_to_sequence(cleaned_text: Sequence[str]) -> List[int]:
    """Phoneme symbol list → id list."""
    return [SYMBOL_TO_ID[symbol] for symbol in cleaned_text]


def text_to_phones(text: str) -> List[str]:
    from vispeech_tpu_torch.text.cleaner import text_to_phones as _ttp

    return _ttp(text)

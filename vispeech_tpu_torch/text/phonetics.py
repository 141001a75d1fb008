"""Phonology vocabularies: Vocab + ARPABET phonetics.

Capability match for the reference's misc frontend library
(text/frontend/vocab.py:20-120, text/frontend/arpabet.py:26-264):

  * ``Vocab`` — ordered symbol table with optional special tokens
    (<pad>/<unk>/<s>/</s>), stable insertion-order ids, lookup/reverse,
    incremental extension.
  * ``Arpabet`` / ``ArpabetWithStress`` — English phonologies over the
    39-phone ARPABET set (stressless) or the 69-phone stressed set, plus
    4 punctuation marks: phoneticize (text → phones), numericalize
    (phones → ids), reverse (ids → phones), callable end-to-end.

Design departure from the reference: the G2P engine is injected (any
``Callable[[str], List[str]]``) rather than hard-constructed from g2p_en at
import, so the module works with the built-in lexicon G2P
(frontends.en_to_phonemes) and stays importable without optional deps.

The port's copy of ``vispeech_tpu/text/phonetics.py``: the same behaviour, kept
in step with it by ``tests/test_torch_text.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

__all__ = ["Vocab", "Arpabet", "ArpabetWithStress"]


class Vocab:
    """Ordered symbol⇄id table with optional special tokens.

    Special tokens (pad/unk/start/end) occupy the first ids, in that order;
    pass ``None`` to omit one.  Duplicate symbols keep their first id.
    """

    def __init__(
        self,
        symbols: Iterable[str],
        padding_symbol: Optional[str] = "<pad>",
        unk_symbol: Optional[str] = "<unk>",
        start_symbol: Optional[str] = "<s>",
        end_symbol: Optional[str] = "</s>",
    ):
        self.padding_symbol = padding_symbol
        self.unk_symbol = unk_symbol
        self.start_symbol = start_symbol
        self.end_symbol = end_symbol

        self.stoi: Dict[str, int] = {}
        for s in (padding_symbol, unk_symbol, start_symbol, end_symbol):
            if s is not None and s not in self.stoi:
                self.stoi[s] = len(self.stoi)
        self._num_specials = len(self.stoi)
        for s in symbols:
            if s not in self.stoi:
                self.stoi[s] = len(self.stoi)
        self.itos: Dict[int, str] = {i: s for s, i in self.stoi.items()}

    def __len__(self) -> int:
        return len(self.stoi)

    def __contains__(self, symbol: str) -> bool:
        return symbol in self.stoi

    def __repr__(self) -> str:
        return f"Vocab(size={len(self)}, specials={self.num_specials})"

    @property
    def num_specials(self) -> int:
        return self._num_specials

    @property
    def padding_index(self) -> int:
        return self.stoi.get(self.padding_symbol, -1)

    @property
    def unk_index(self) -> int:
        return self.stoi.get(self.unk_symbol, -1)

    @property
    def start_index(self) -> int:
        return self.stoi.get(self.start_symbol, -1)

    @property
    def end_index(self) -> int:
        return self.stoi.get(self.end_symbol, -1)

    def lookup(self, symbol: str) -> int:
        """Symbol → id; falls back to <unk> if present, else KeyError."""
        if symbol in self.stoi:
            return self.stoi[symbol]
        if self.unk_symbol is not None:
            return self.stoi[self.unk_symbol]
        raise KeyError(symbol)

    def reverse(self, index: int) -> str:
        return self.itos[index]

    def add_symbol(self, symbol: str) -> None:
        if symbol not in self.stoi:
            idx = len(self.stoi)
            self.stoi[symbol] = idx
            self.itos[idx] = symbol

    def add_symbols(self, symbols: Iterable[str]) -> None:
        for s in symbols:
            self.add_symbol(s)


# 39 stressless ARPABET phones (CMUdict phone set)
ARPABET_PHONES: List[str] = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG", "OW",
    "OY", "P", "R", "S", "SH", "T", "TH", "UW", "UH", "V", "W", "Y", "Z",
    "ZH",
]
_VOWELS = [p for p in ARPABET_PHONES if p[0] in "AEIOU"]
# 69 = 15 vowels × 3 stress levels + 24 consonants
ARPABET_STRESS_PHONES: List[str] = sorted(
    [f"{v}{s}" for v in _VOWELS for s in "012"] +
    [p for p in ARPABET_PHONES if p not in _VOWELS]
)
PUNCTUATIONS: List[str] = [",", ".", "?", "!"]

G2PBackend = Callable[[str], List[str]]


def _default_backend() -> G2PBackend:
    """g2p_en if installed, else the built-in lexicon G2P."""
    try:
        from g2p_en import G2p

        g2p = G2p()
        return lambda s: [p for p in g2p(s) if p != " "]
    except ImportError:
        from vispeech_tpu_torch.text.frontends import en_to_phonemes

        return en_to_phonemes


class Arpabet:
    """English phonology over stressless ARPABET + punctuation.

    vocab_size = 39 phones + 4 punctuation + 4 specials = 47
    (reference arpabet.py:189-193).
    """

    phonemes = ARPABET_PHONES
    punctuations = PUNCTUATIONS
    _strip_stress = True

    def __init__(self, backend: Optional[G2PBackend] = None):
        self._backend = backend
        self.vocab = Vocab(self.phonemes + self.punctuations)

    @property
    def symbols(self) -> List[str]:
        return self.phonemes + self.punctuations

    @property
    def backend(self) -> G2PBackend:
        if self._backend is None:
            self._backend = _default_backend()
        return self._backend

    @staticmethod
    def _remove_stress(phone: str) -> str:
        if phone[:-1] in ARPABET_PHONES and phone[-1] in "012":
            return phone[:-1]
        return phone

    def phoneticize(self, sentence: str, add_start_end: bool = False) -> List[str]:
        phones = list(self.backend(sentence))
        if self._strip_stress:
            phones = [self._remove_stress(p) for p in phones]
        if add_start_end:
            phones = [self.vocab.start_symbol] + phones + [self.vocab.end_symbol]
        return [p for p in phones if p in self.vocab.stoi]

    def numericalize(self, phonemes: List[str]) -> List[int]:
        return [self.vocab.lookup(p) for p in phonemes]

    def reverse(self, ids: List[int]) -> List[str]:
        return [self.vocab.reverse(i) for i in ids]

    def __call__(self, sentence: str, add_start_end: bool = False) -> List[int]:
        return self.numericalize(self.phoneticize(sentence, add_start_end))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


class ArpabetWithStress(Arpabet):
    """Stressed variant: 69 phones + 4 punctuation + 4 specials = 77."""

    phonemes = ARPABET_STRESS_PHONES
    _strip_stress = False

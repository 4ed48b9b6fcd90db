"""Phonetics front ends: text -> symbol ids.

Equivalents of the reference's Phonetics ABC and its English
implementations (reference: parakeet/frontend/phonectic.py:30-213):

- :class:`EnglishCharacter` — character-level (the LJSpeech Tacotron2
  recipe's frontend),
- :class:`English` — ARPABET phones via the pluggable G2P backends in
  :mod:`.arpabet`.

Both expose ``phoneticize(text) -> symbols``, ``numericalize(symbols) ->
ids``, ``reverse(ids) -> symbols`` and ``__call__(text) -> ids``.

The port's copy of ``parakeet_tpu/frontend/phonectic.py`` (pure Python).
"""
from __future__ import annotations

import re
from abc import ABC, abstractmethod
from typing import List, Optional

from .arpabet import ARPABET_PHONES, get_g2p
from .normalizer import normalize
from .vocab import Vocab

__all__ = ["Phonetics", "English", "EnglishCharacter"]


class Phonetics(ABC):
    vocab: Vocab

    @abstractmethod
    def phoneticize(self, sentence: str) -> List[str]:
        ...

    def numericalize(self, phonemes: List[str]) -> List[int]:
        return [self.vocab.lookup(p) for p in phonemes
                if p in self.vocab.stoi or self.vocab.unk_symbol]

    def reverse(self, ids: List[int]) -> List[str]:
        return [self.vocab.reverse(i) for i in ids]

    def __call__(self, sentence: str) -> List[int]:
        return self.numericalize(self.phoneticize(sentence))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


class EnglishCharacter(Phonetics):
    """Character-level English (reference phonectic.py:131-212)."""

    def __init__(self):
        chars = list("abcdefghijklmnopqrstuvwxyz '.,?!-")
        self.vocab = Vocab(chars, start_symbol=None, end_symbol=None)

    def phoneticize(self, sentence: str) -> List[str]:
        return list(normalize(sentence))


class English(Phonetics):
    """Word-level ARPABET English (reference phonectic.py:44-130)."""

    _WORD = re.compile(r"[a-z']+|[.,?!\-]")

    def __init__(self, lexicon_path: Optional[str] = None,
                 keep_punctuation: bool = True):
        self.g2p = get_g2p(lexicon_path)
        self.keep_punctuation = keep_punctuation
        punct = [".", ",", "?", "!", "-"] if keep_punctuation else []
        self.vocab = Vocab(ARPABET_PHONES + punct + [" "])

    def phoneticize(self, sentence: str) -> List[str]:
        text = normalize(sentence)
        out: List[str] = []
        for token in self._WORD.findall(text):
            if re.match(r"[a-z']", token):
                if out and out[-1] != " ":
                    out.append(" ")
                out.extend(self.g2p(token.replace("'", "")))
            elif self.keep_punctuation:
                out.append(token)
        return out

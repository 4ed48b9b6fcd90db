"""Pinyin frontends implementing the Phonetics ABC.

Equivalent of the reference pinyin frontends (reference:
parakeet/frontend/pinyin.py:55-340 ParakeetPinyin /
ParakeetPinyinWithTone): Chinese text -> pinyin syllables (pypinyin when
available, the built-in table otherwise, as in zh_frontend) -> Parakeet
initial/final phones (ii/iii/v rewrites via generate_lexicon's
``syllable_to_phones``) -> ids over a Vocab with <s>/</s> wrapping.

The port's copy of ``parakeet_tpu/frontend/pinyin.py`` (pure Python).
"""
from __future__ import annotations

from typing import List, Optional

from .generate_lexicon import generate_lexicon
from .phonectic import Phonetics
from .punctuation import get_punctuations
from .vocab import Vocab
from .zh_frontend import _BuiltinG2P, _LexiconZhG2P
from .zh_normalization.text_normlization import TextNormalizer


def _make_g2p(pinyin_lexicon_path: Optional[str]):
    try:
        from .zh_frontend import _PypinyinG2P
        return _PypinyinG2P()
    except Exception:
        if pinyin_lexicon_path:
            return _LexiconZhG2P(pinyin_lexicon_path)
        return _BuiltinG2P(strict=False)


class ParakeetPinyin(Phonetics):
    """Toneless initial/final phones (reference pinyin.py:55-145)."""
    with_tone = False

    def __init__(self, pinyin_lexicon_path: Optional[str] = None):
        self.normalizer = TextNormalizer()
        self.g2p = _make_g2p(pinyin_lexicon_path)
        self.lexicon = generate_lexicon(with_tone=self.with_tone,
                                        with_erhua=False)
        self.punctuations = get_punctuations("zh")
        symbols = sorted({p for phones in self.lexicon.values()
                          for p in phones.split()})
        self.vocab = Vocab(symbols + sorted(self.punctuations))

    def _syllables(self, sentence: str) -> List[str]:
        sylls: List[str] = []
        for sent in self.normalizer.normalize(sentence):
            sylls.extend(self.g2p(sent))
        if not self.with_tone:
            sylls = [s[:-1] if s and s[-1].isdigit() else s for s in sylls]
        return sylls

    def phoneticize(self, sentence: str, add_start_end: bool = False
                    ) -> List[str]:
        phones: List[str] = []
        for syll in self._syllables(sentence):
            if syll in self.lexicon:
                phones.extend(self.lexicon[syll].split())
            elif syll in self.punctuations:
                phones.append(syll)
        if add_start_end:
            phones = ([self.vocab.start_symbol] + phones
                      + [self.vocab.end_symbol])
        return phones

    def numericalize(self, phonemes: List[str]) -> List[int]:
        return [self.vocab.lookup(p) for p in phonemes
                if p in self.vocab.stoi]

    def reverse(self, ids: List[int]) -> List[str]:
        return [self.vocab.itos[i] for i in ids]

    def __call__(self, sentence: str, add_start_end: bool = False
                 ) -> List[int]:
        return self.numericalize(
            self.phoneticize(sentence, add_start_end))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


class ParakeetPinyinWithTone(ParakeetPinyin):
    """Tone-carrying phones (finals keep their tone digit; reference
    pinyin.py:222-340)."""
    with_tone = True

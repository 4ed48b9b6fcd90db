"""Text front ends of the port: normalization + G2P -> symbol ids.

The framework-free ``parakeet_tpu.frontend`` copied module by module
(its data tables verbatim): English (character / ARPABET) and Chinese
(textnorm + tone sandhi + pinyin) pipelines, vocab, punctuation, the
rule-generated pinyin lexicon and the CLIs' ``build_text_to_ids``.  The
G2P backends are chosen as the JAX package chooses them (pypinyin or
g2p_en if importable, else a lexicon file, else the built-in tables), and
the Chinese segmentation as well (jieba if importable, else one word a
sentence), so both packages take the same path on one machine.
"""
from .arpabet import (ARPABET, ARPABET_PHONES, ARPABET_STRESS_PHONES,
                      ARPABETWithStress, LexiconG2P, RuleG2P, get_g2p)
from .cli import build_text_to_ids
from .generate_lexicon import (FINALS, INITIALS, generate_lexicon,
                               split_syllable, syllable_to_phones)
from .normalizer import normalize as normalize_en
from .phonectic import English, EnglishCharacter, Phonetics
from .pinyin import ParakeetPinyin, ParakeetPinyinWithTone
from .punctuation import get_punctuations
from .tone_sandhi import ToneSandhi
from .vocab import Vocab
from .zh_frontend import Frontend
from .zh_normalization import TextNormalizer

__all__ = [
    "Vocab", "Phonetics", "English", "EnglishCharacter",
    "ARPABET", "ARPABETWithStress",
    "ARPABET_PHONES", "ARPABET_STRESS_PHONES", "RuleG2P", "LexiconG2P",
    "get_g2p", "normalize_en", "get_punctuations",
    "Frontend", "TextNormalizer", "ToneSandhi",
    "ParakeetPinyin", "ParakeetPinyinWithTone",
    "generate_lexicon", "split_syllable", "syllable_to_phones",
    "INITIALS", "FINALS", "build_text_to_ids",
]

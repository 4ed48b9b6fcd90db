"""Text front end of the port: the framework-free parts of
``parakeet_tpu.frontend`` that the voice-cloning recipe needs, copied
(the rule-generated pinyin lexicon and the symbol table).  The Chinese
and English G2P pipelines are not ported (ROADMAP queue 1, item 19)."""
from .generate_lexicon import (FINALS, INITIALS, generate_lexicon,
                               split_syllable, syllable_to_phones)
from .vocab import Vocab

__all__ = ["Vocab", "generate_lexicon", "split_syllable",
           "syllable_to_phones", "INITIALS", "FINALS"]

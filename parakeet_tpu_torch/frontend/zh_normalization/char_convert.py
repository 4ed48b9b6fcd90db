"""Traditional -> simplified Chinese character conversion (reference:
parakeet/frontend/zh_normalization/char_convert.py).

The character tables (10,737 aligned pairs) live in
``_char_convert_data.py`` and are carried verbatim from the reference —
they are linguistic data.  A simplified character can correspond to
multiple traditional characters; the t2s direction keeps the first
pairing, matching the reference dict-comprehension behavior.  Unknown
characters pass through unchanged.

The port's copy of ``parakeet_tpu/frontend/zh_normalization/char_convert.py`` (pure Python).
"""
from __future__ import annotations

from ._char_convert_data import SIMPLIFIED_CHARACTERS, TRADITIONAL_CHARACTERS

__all__ = ["tranditional_to_simplified", "simplified_to_traditional"]

_S2T = dict(zip(SIMPLIFIED_CHARACTERS, TRADITIONAL_CHARACTERS))
_T2S = dict(zip(TRADITIONAL_CHARACTERS, SIMPLIFIED_CHARACTERS))


def tranditional_to_simplified(text: str) -> str:
    """Spelled as in the reference API."""
    return "".join(_T2S.get(ch, ch) for ch in text)


def simplified_to_traditional(text: str) -> str:
    return "".join(_S2T.get(ch, ch) for ch in text)

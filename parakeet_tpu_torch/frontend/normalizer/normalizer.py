"""English text normalization.

Equivalent of the reference pipeline (reference:
parakeet/frontend/normalizer/normalizer.py:21): unicode NFKD accent
stripping -> lowercase -> number & abbreviation expansion -> keep word
characters and basic punctuation.

The port's copy of ``parakeet_tpu/frontend/normalizer/normalizer.py`` (pure Python).
"""
from __future__ import annotations

import re
import unicodedata

from .abbreviations import expand_abbreviations
from .numbers import normalize_numbers

__all__ = ["normalize", "full_to_half_width", "half_to_full_width"]

_KEEP = re.compile(r"[^ a-z'.,?!\-]")
_SPACES = re.compile(r"\s+")


def full_to_half_width(text: str) -> str:
    """Full-width ASCII variants -> half-width (reference width.py)."""
    out = []
    for ch in text:
        code = ord(ch)
        if code == 0x3000:
            out.append(" ")
        elif 0xFF01 <= code <= 0xFF5E:
            out.append(chr(code - 0xFEE0))
        else:
            out.append(ch)
    return "".join(out)


def half_to_full_width(text: str) -> str:
    """Half-width ASCII -> full-width (reference width.py:29-40)."""
    out = []
    for ch in text:
        code = ord(ch)
        if code == 0x20:
            out.append(chr(0x3000))
        elif 0x21 <= code <= 0x7E:
            out.append(chr(code + 0xFEE0))
        else:
            out.append(ch)
    return "".join(out)


def _strip_accents(text: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFKD", text)
                   if not unicodedata.combining(c))


def normalize(text: str) -> str:
    text = full_to_half_width(text)
    text = _strip_accents(text)
    text = text.lower()
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    text = _KEEP.sub(" ", text)
    text = _SPACES.sub(" ", text).strip()
    return text

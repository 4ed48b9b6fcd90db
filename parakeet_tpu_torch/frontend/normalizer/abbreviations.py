"""English abbreviation expansion (reference:
parakeet/frontend/normalizer/abbrrviation.py).

The port's copy of ``parakeet_tpu/frontend/normalizer/abbreviations.py`` (pure Python).
"""
from __future__ import annotations

import re

__all__ = ["expand_abbreviations"]

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), full) for abbr, full in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"),
        ("st", "saint"), ("co", "company"), ("jr", "junior"),
        ("maj", "major"), ("gen", "general"), ("drs", "doctors"),
        ("rev", "reverend"), ("lt", "lieutenant"), ("hon", "honorable"),
        ("sgt", "sergeant"), ("capt", "captain"), ("esq", "esquire"),
        ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for pattern, full in _ABBREVIATIONS:
        text = pattern.sub(full, text)
    return text

"""Per-language punctuation sets (reference:
parakeet/frontend/punctuation.py:30).

The port's copy of ``parakeet_tpu/frontend/punctuation.py`` (pure Python).
"""
from __future__ import annotations

__all__ = ["get_punctuations"]

_EN = [",", ".", "?", "!", ";", ":", "-", "'", '"', "(", ")"]
_ZH = ["，", "。", "？", "！", "；", "：", "、", "…", "—",
       "“", "”", "‘", "’", "（", "）", "《", "》"]


def get_punctuations(language: str):
    if language.lower() in ("en", "english"):
        return list(_EN)
    if language.lower() in ("zh", "cn", "chinese"):
        return list(_ZH)
    raise ValueError(f"unknown language {language!r}")

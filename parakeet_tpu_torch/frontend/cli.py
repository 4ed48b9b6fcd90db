"""Shared text -> phone-id helper for the synthesis CLIs.

One place for the zh/en sentence-to-ids policy so every e2e/deploy CLI
behaves identically (unknown en phones are dropped; zh goes through the
full rule-based frontend with the recipe's phone vocabulary).

The port's copy of ``parakeet_tpu/frontend/cli.py`` (pure Python).
"""
from __future__ import annotations

__all__ = ["build_text_to_ids"]


def build_text_to_ids(lang: str, phones_dict):
    """Returns ``fn(sentence: str) -> list[int]`` for ``lang`` in
    {"zh", "en", "en-char"} using the recipe's ``phone_id_map.txt``
    ("en-char" = character tokens with word boundaries as <sp>, the
    tacotron2 --frontend char convention)."""
    if lang == "zh":
        from .zh_frontend import Frontend
        fe = Frontend(phone_vocab_path=str(phones_dict), strict=False)

        def get_ids(sentence):
            out = fe.get_input_ids(sentence)
            return out["phone_ids"][0] if out.get("phone_ids") else []
        return get_ids
    from ..data.preprocess import load_id_map
    phone_map = load_id_map(phones_dict)
    if lang == "en-char":
        from .phonectic import EnglishCharacter
        ch = EnglishCharacter()

        def get_ids(sentence):
            toks = ["<sp>" if t.isspace() else t
                    for t in ch.phoneticize(sentence)]
            return [phone_map[t] for t in toks if t in phone_map]
        return get_ids
    if lang != "en":
        raise ValueError(f"unsupported lang {lang!r}")
    from .phonectic import English
    en = English()

    def get_ids(sentence):
        return [phone_map[p] for p in en.phoneticize(sentence)
                if p in phone_map]
    return get_ids

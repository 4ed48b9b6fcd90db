"""Rule-generated pinyin -> phones lexicon of the port: a copy of
``parakeet_tpu/frontend/generate_lexicon.py`` (pure Python).

Equivalent of the reference generator (reference:
parakeet/frontend/generate_lexicon.py:39-157): every legal pinyin syllable
is decomposed into (initial, final) with the Parakeet conventions —
full-form finals (iu->iou, ui->uei, un->uen), apical vowels ``ii`` (zi/ci/
si) and ``iii`` (zhi/chi/shi/ri), ``v`` for the umlaut vowel after
j/q/x/y/n/l, y/w kept as onsets, optional erhua ``r`` suffix and tones
1-5 appended to the final.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

__all__ = ["split_syllable", "syllable_to_phones", "generate_lexicon",
           "INITIALS", "FINALS"]

INITIALS = ["b", "p", "m", "f", "d", "t", "n", "l", "g", "k", "h",
            "j", "q", "x", "zh", "ch", "sh", "r", "z", "c", "s", "y", "w"]

FINALS = ["a", "ai", "au", "an", "ang", "e", "ei", "en", "eng", "er",
          "o", "ou", "i", "ia", "iau", "ian", "iang", "ie", "in",
          "ing", "iou", "io", "u", "ua", "uai", "uan", "uang", "uei",
          "uen", "ueng", "ung", "uo", "v", "van", "ve", "vn", "vng",
          "ii", "iii"]

ERHUA_PHONE = "&r"   # untoned erhua token (AISHELL-3 lexicon convention)

# syllables whose vowel is apical
_APICAL_II = {"zi", "ci", "si"}
_APICAL_III = {"zhi", "chi", "shi", "ri"}

# y-/w- onset rewrites: full final forms
_Y_REWRITE = {
    "yi": "i", "ya": "ia", "yo": "io", "ye": "ie", "yao": "au",
    "yai": "ai",
    "you": "iou", "yan": "ian", "yin": "in", "yang": "iang",
    "ying": "ing", "yong": "vng", "yu": "v", "yue": "ve",
    "yuan": "van", "yun": "vn",
}
_W_REWRITE = {
    "wu": "u", "wa": "ua", "wo": "uo", "wai": "uai", "wei": "uei",
    "wan": "uan", "wen": "uen", "wang": "uang", "weng": "ung",
}

_TONED = re.compile(r"^([a-z]+?)(r?)([1-5])?$")


def split_syllable(syllable: str
                   ) -> Tuple[Optional[str], str, bool]:
    """Toned pinyin syllable -> (initial or None, final_with_tone, erhua).

    ``zhuang1`` -> ("zh", "uang1", False); ``yue4`` -> ("y", "ve4", False);
    ``er2`` -> (None, "er2", False); ``huar1`` -> ("h", "ua1", True).
    """
    m = _TONED.match(syllable.lower())
    if not m:
        raise ValueError(f"not a pinyin syllable: {syllable!r}")
    base, erhua, tone = m.group(1), m.group(2), m.group(3) or ""
    # 'er' ends with r but is not erhua
    if base == "e" and erhua == "r":
        base, erhua = "er", ""
    if not erhua and base.endswith("r") and base not in (
            "er",) and base[:-1] in _ALL_SYLLABLES:
        base, erhua = base[:-1], "r"

    initial, final = _decompose(base)
    return initial, final + tone, bool(erhua)


def syllable_to_phones(syllable: str) -> List[str]:
    """Toned pinyin -> phone list, erhua as a separate untoned token:
    ``bar1`` -> ["b", "a1", "&r"] (matching the reference recipes'
    rule-generated lexicons)."""
    initial, final, erhua = split_syllable(syllable)
    phones = [initial] if initial else []
    phones.append(final)
    if erhua:
        phones.append(ERHUA_PHONE)
    return phones


def _decompose(base: str) -> Tuple[Optional[str], str]:
    if base in _APICAL_III:
        return base[:-1], "iii"
    if base in _APICAL_II:
        return base[:-1], "ii"
    if base in _Y_REWRITE:
        return "y", _Y_REWRITE[base]
    if base in _W_REWRITE:
        return "w", _W_REWRITE[base]
    if base.startswith("y"):
        rest = base[1:]
        if rest and rest[0] in "aoeiu":
            return "y", _expand_final("i" + rest if rest[0] not in "iu"
                                      else rest, None)
    if base.startswith("w"):
        return "w", _expand_final("u" + base[1:], None)
    for init in ("zh", "ch", "sh"):
        if base.startswith(init):
            return init, _expand_final(base[len(init):], init)
    if base[0] in "bpmfdtnlgkhjqxrzcs":
        return base[0], _expand_final(base[1:], base[0])
    return None, _expand_final(base, None)


_LABIAL = ("b", "p", "m", "f")


def _expand_final(final: str, initial: Optional[str]) -> str:
    """Contracted written forms -> full forms; umlaut handling."""
    if initial in ("j", "q", "x", "y"):
        if final == "u":
            final = "v"
        elif final.startswith("u"):
            final = "v" + final[1:]
        if final == "vn":
            pass
    if final == "iu":
        final = "iou"
    elif final == "ui":
        final = "uei"
    elif final == "un":
        final = "vn" if initial in ("j", "q", "x", "y") else "uen"
    elif final == "ong":
        final = "ung"
    elif final == "iong":
        final = "vng"
    elif final == "ue":
        final = "ve"
    elif final == "ao":
        final = "au"
    elif final == "iao":
        final = "iau"
    elif final == "o" and initial in _LABIAL:
        final = "uo"      # bo/po/mo/fo read with the uo final
    return final


def _all_syllables() -> List[str]:
    """Enumerate legal toneless pinyin syllables (approximate full set)."""
    out = set()
    out.update(_APICAL_II | _APICAL_III)
    out.update(_Y_REWRITE)
    out.update(_W_REWRITE)
    standalone = ["a", "ai", "ao", "an", "ang", "e", "ei", "en", "eng",
                  "er", "o", "ou"]
    out.update(standalone)
    combos = {
        "b": "a ai ao an ang e ei en eng i iao ian ie in ing o u".split(),
        "p": "a ai ao an ang ei en eng i iao ian ie in ing o u".split(),
        "m": "a ai ao an ang e ei en eng i iao ian ie in ing iu o ou u"
             .split(),
        "f": "a an ang ei en eng o ou u".split(),
        "d": "a ai ao an ang e ei en eng i ia iao ian ie ing iu ong ou u "
             "uan ui un uo".split(),
        "t": "a ai ao an ang e ei eng i iao ian ie ing ong ou u uan ui "
             "un uo".split(),
        "n": "a ai ao an ang e ei en eng i iao ian iang ie in ing iu "
             "ong ou u uan uo v ve".split(),
        "l": "a ai ao an ang e ei eng i ia iao ian iang ie in ing iu "
             "ong ou u uan un uo v ve".split(),
        "g": "a ai ao an ang e ei en eng ong ou u ua uai uan uang ui "
             "un uo".split(),
        "k": "a ai ao an ang e ei en eng ong ou u ua uai uan uang ui "
             "un uo".split(),
        "h": "a ai ao an ang e ei en eng ong ou u ua uai uan uang ui "
             "un uo".split(),
        "j": "i ia iao ian iang ie in ing iong iu u uan ue un".split(),
        "q": "i ia iao ian iang ie in ing iong iu u uan ue un".split(),
        "x": "i ia iao ian iang ie in ing iong iu u uan ue un".split(),
        "zh": "a ai ao an ang e ei en eng i ong ou u ua uai uan uang ui "
              "un uo".split(),
        "ch": "a ai ao an ang e en eng i ong ou u ua uai uan uang ui un "
              "uo".split(),
        "sh": "a ai ao an ang e ei en eng i ou u ua uai uan uang ui un "
              "uo".split(),
        "r": "an ang ao e en eng i ong ou u ua uan ui un uo".split(),
        "z": "a ai ao an ang e ei en eng i ong ou u uan ui un uo".split(),
        "c": "a ai ao an ang e en eng i ong ou u uan ui un uo".split(),
        "s": "a ai ao an ang e en eng i ong ou u uan ui un uo".split(),
    }
    for init, finals in combos.items():
        for f in finals:
            out.add(init + f)
    return sorted(out)


_ALL_SYLLABLES = set(_all_syllables())


def generate_lexicon(with_tone: bool = True,
                     with_erhua: bool = False) -> Dict[str, str]:
    """pinyin syllable -> "INITIAL FINAL" phone string (reference
    generate_lexicon.py:39)."""
    lex: Dict[str, str] = {}
    tones = "12345" if with_tone else [""]
    for syl in _all_syllables():
        for tone in tones:
            key = syl + tone
            lex[key] = " ".join(syllable_to_phones(key))
            if with_erhua and not syl.endswith("r"):
                ekey = syl + "r" + tone
                lex[ekey] = " ".join(syllable_to_phones(ekey))
    return lex

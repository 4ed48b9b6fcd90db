"""ARPABET phone inventories + a self-contained English G2P.

Equivalent of the reference ARPABET frontends (reference:
parakeet/frontend/arpabet.py:26-302), which wrap ``g2p_en``.  This image
has no ``g2p_en`` / CMUdict data, so G2P is pluggable:

1. a user-supplied CMU-format pronouncing dictionary file,
2. ``g2p_en`` if importable (same behavior as the reference),
3. the built-in frequent-word lexicon (``_arpabet_data.py``, CMUdict
   conventions) with morphological suffix handling (-s/-es/-ies, -ed,
   -ing, -ly) — always available,
4. compact letter-to-sound rules for true OOVs.

Accuracy of the self-contained chain (3->4) is measured by
recipes/text_frontend/test_en_g2p.py and recorded in
docs/frontend_accuracy.md.

The port's copy of ``parakeet_tpu/frontend/arpabet.py`` (pure Python).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

__all__ = ["ARPABET_PHONES", "ARPABET_STRESS_PHONES", "G2PBackend",
           "RuleG2P", "LexiconG2P", "BuiltinLexiconG2P", "get_g2p",
           "ARPABET", "ARPABETWithStress"]

# The 39-phoneme ARPABET inventory (public standard; reference
# arpabet.py:26 lists the same set).
ARPABET_PHONES = [
    "AA", "AE", "AH", "AO", "AW", "AY", "B", "CH", "D", "DH", "EH", "ER",
    "EY", "F", "G", "HH", "IH", "IY", "JH", "K", "L", "M", "N", "NG",
    "OW", "OY", "P", "R", "S", "SH", "T", "TH", "UH", "UW", "V", "W",
    "Y", "Z", "ZH",
]

_VOWELS = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH",
           "IY", "OW", "OY", "UH", "UW"}

# vowels x 3 stress levels + consonants (reference ARPABETWithStress)
ARPABET_STRESS_PHONES = sorted(
    [p + s for p in _VOWELS for s in ("0", "1", "2")]
    + [p for p in ARPABET_PHONES if p not in _VOWELS])


class G2PBackend:
    """text word (lowercase, alphabetic) -> list of ARPABET phones."""

    def __call__(self, word: str) -> List[str]:
        raise NotImplementedError


class LexiconG2P(G2PBackend):
    """CMU-format dictionary file: ``WORD  PH1 PH2 ...`` per line."""

    def __init__(self, path: str, strip_stress: bool = True,
                 fallback: Optional[G2PBackend] = None):
        self.strip_stress = strip_stress
        self.fallback = fallback or RuleG2P()
        self.table: Dict[str, List[str]] = {}
        with open(path, encoding="utf-8", errors="ignore") as f:
            for line in f:
                if line.startswith(";;;") or not line.strip():
                    continue
                parts = line.split()
                word = parts[0].lower()
                word = re.sub(r"\(\d+\)$", "", word)
                if word in self.table:
                    continue
                phones = parts[1:]
                if strip_stress:
                    phones = [re.sub(r"\d", "", p) for p in phones]
                self.table[word] = phones

    def __call__(self, word: str) -> List[str]:
        w = word.lower()
        if w in self.table:
            return list(self.table[w])
        stripped = w.replace("'", "")
        if stripped in self.table:
            return list(self.table[stripped])
        return self.fallback(word)


# Compact letter-to-sound rules: ordered (pattern, phones) pairs matched
# greedily left-to-right.  Not CMUdict-accurate — a deterministic,
# dependency-free fallback.
_LTS_RULES = [
    # multi-letter graphemes first
    ("tion", ["SH", "AH", "N"]), ("sion", ["ZH", "AH", "N"]),
    ("ought", ["AO", "T"]), ("aught", ["AO", "T"]),
    ("igh", ["AY"]), ("eigh", ["EY"]),
    ("tch", ["CH"]), ("dge", ["JH"]),
    ("sch", ["S", "K"]), ("chr", ["K", "R"]),
    ("wh", ["W"]), ("wr", ["R"]), ("kn", ["N"]), ("gn", ["N"]),
    ("ph", ["F"]), ("gh", ["G"]), ("ck", ["K"]), ("sh", ["SH"]),
    ("ch", ["CH"]), ("th", ["TH"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("oo", ["UW"]), ("ee", ["IY"]), ("ea", ["IY"]), ("ai", ["EY"]),
    ("ay", ["EY"]), ("oa", ["OW"]), ("ow", ["OW"]), ("ou", ["AW"]),
    ("oi", ["OY"]), ("oy", ["OY"]), ("au", ["AO"]), ("aw", ["AO"]),
    ("ew", ["UW"]), ("ie", ["IY"]), ("ei", ["EY"]), ("ey", ["IY"]),
    ("ar", ["AA", "R"]), ("er", ["ER"]), ("ir", ["ER"]), ("ur", ["ER"]),
    ("or", ["AO", "R"]),
    ("a", ["AE"]), ("b", ["B"]), ("c", ["K"]), ("d", ["D"]),
    ("e", ["EH"]), ("f", ["F"]), ("g", ["G"]), ("h", ["HH"]),
    ("i", ["IH"]), ("j", ["JH"]), ("k", ["K"]), ("l", ["L"]),
    ("m", ["M"]), ("n", ["N"]), ("o", ["AA"]), ("p", ["P"]),
    ("q", ["K"]), ("r", ["R"]), ("s", ["S"]), ("t", ["T"]),
    ("u", ["AH"]), ("v", ["V"]), ("w", ["W"]), ("x", ["K", "S"]),
    ("y", ["Y"]), ("z", ["Z"]),
]


class RuleG2P(G2PBackend):
    """Greedy longest-match letter-to-sound rules."""

    def __call__(self, word: str) -> List[str]:
        w = word.lower().replace("'", "")
        # final silent 'e' (not the only vowel)
        if (len(w) > 2 and w.endswith("e") and not w.endswith("ee")
                and any(ch in "aeiou" for ch in w[:-1])):
            w = w[:-1]
        # doubled consonants sound once (ll, ss, tt, ...)
        w = re.sub(r"([bcdfghjklmnpqrstvz])\1", r"\1", w)
        phones: List[str] = []
        i = 0
        while i < len(w):
            for pat, ph in _LTS_RULES:
                if w.startswith(pat, i):
                    # 'c' before e/i/y -> S; 'g' before e/i/y -> JH
                    if pat == "c" and i + 1 < len(w) and w[i + 1] in "eiy":
                        phones.append("S")
                    elif pat == "g" and i + 1 < len(w) and w[i + 1] in "eiy":
                        phones.append("JH")
                    # word-final 's' after a voiced sound -> Z
                    elif (pat == "s" and i == len(w) - 1 and phones
                          and phones[-1] in _VOWELS | {"B", "D", "G", "V",
                                                       "Z", "M", "N", "NG",
                                                       "L", "R", "W", "Y"}):
                        phones.append("Z")
                    # word-final 'y' after a consonant -> IY (city, happy)
                    elif (pat == "y" and i == len(w) - 1 and i > 0
                          and w[i - 1] not in "aeiou"):
                        phones.append("IY")
                    else:
                        phones.extend(ph)
                    i += len(pat)
                    break
            else:
                i += 1  # skip unknown character
        return phones


class BuiltinLexiconG2P(G2PBackend):
    """Built-in frequent-word lexicon (``_arpabet_data.BUILTIN_LEXICON``,
    ~1,150 citation-form entries) with morphological suffix derivation;
    true OOVs fall to letter-to-sound rules.  Mirrors the zh fallback
    design (word table first, rules last, frontend/_pinyin_data.py)."""

    _VOICELESS = {"P", "T", "K", "F", "TH"}
    _SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}

    def __init__(self, strip_stress: bool = True,
                 fallback: Optional[G2PBackend] = None):
        from ._arpabet_data import BUILTIN_LEXICON
        self.strip_stress = strip_stress
        self.fallback = fallback or RuleG2P()
        self.table: Dict[str, List[str]] = {
            w: ph.split() for w, ph in BUILTIN_LEXICON.items()}

    def _lookup(self, w: str) -> Optional[List[str]]:
        phones = self.table.get(w)
        return list(phones) if phones is not None else None

    def _base(self, w: str) -> Optional[List[str]]:
        """Lookup restricted to plausible derivation bases: 1-2 letter
        entries are function words/abbreviations ("dr" -> doctor) whose
        derived spellings are almost never real inflections (measured:
        "dring" read as doctor+ing, cmudict eval round 4)."""
        return self._lookup(w) if len(w) >= 3 else None

    def _suffix_s(self, base: List[str]) -> List[str]:
        last = re.sub(r"\d", "", base[-1])
        if last in self._SIBILANT:
            return base + ["IH0", "Z"]
        if last in self._VOICELESS:
            return base + ["S"]
        return base + ["Z"]

    def _derive(self, w: str) -> Optional[List[str]]:
        """Regular morphology over lexicon base forms.  ``w`` arrives
        apostrophe-stripped, so possessives ("dog's", "dogs'") reduce to
        the plain -s / -es branches."""
        # plural / 3rd-person / possessive: -s, -es, -ies
        for suf, base_of in (("ies", lambda v: v[:-3] + "y"),
                             ("es", lambda v: v[:-2]),
                             ("s", lambda v: v[:-1])):
            if w.endswith(suf) and len(w) > len(suf) + 1:
                base = self._base(base_of(w))
                if base:
                    return self._suffix_s(base)
        # past tense: -ed (walk/walked, bake/baked, stop/stopped)
        if w.endswith("ed") and len(w) > 3:
            candidates = [w[:-2], w[:-1]]
            if len(w) > 4 and w[-3] == w[-4]:
                candidates.append(w[:-3])          # doubled consonant
            for cand in candidates:
                base = self._base(cand)
                if base:
                    last = re.sub(r"\d", "", base[-1])
                    if last in {"T", "D"}:
                        return base + ["IH0", "D"]
                    if last in self._VOICELESS | {"S", "SH", "CH", "K"}:
                        return base + ["T"]
                    return base + ["D"]
        # progressive: -ing (walk/walking, bake/baking, run/running)
        if w.endswith("ing") and len(w) > 4:
            candidates = [w[:-3], w[:-3] + "e"]
            if len(w) > 5 and w[-4] == w[-5]:
                candidates.append(w[:-4])          # doubled consonant
            for cand in candidates:
                base = self._base(cand)
                if base:
                    return base + ["IH0", "NG"]
        # adverbial: -ly (degeminate after a base-final L: full/fully)
        if w.endswith("ly") and len(w) > 3:
            base = self._base(w[:-2])
            if base:
                tail = ["IY0"] if re.sub(r"\d", "", base[-1]) == "L" \
                    else ["L", "IY0"]
                return base + tail
        # concatenative suffixes (no stem phonology change)
        for suf, tail in (("ness", ["N", "AH0", "S"]),
                          ("ment", ["M", "AH0", "N", "T"]),
                          ("ful", ["F", "AH0", "L"]),
                          ("less", ["L", "AH0", "S"]),
                          # happy/happier: the 'i' is the y-base's own
                          # final IY0, so only the ending is appended
                          ("ier", ["ER0"]),
                          ("iest", ["AH0", "S", "T"]),
                          ("er", ["ER0"]),               # bake/baker
                          ("est", ["AH0", "S", "T"]),
                          ("y", ["IY0"])):               # water/watery
            if w.endswith(suf) and len(w) > len(suf) + 2:
                stem = w[: -len(suf)]
                if suf in ("ier", "iest"):
                    stem += "y"
                candidates = [stem]
                if suf in ("er", "est", "y") and len(stem) > 2 \
                        and stem[-1] == stem[-2]:
                    candidates.append(stem[:-1])         # big/bigger
                if suf in ("er", "est", "y"):
                    candidates.append(stem + "e")        # bake/baker
                for cand in candidates:
                    base = self._base(cand)
                    if base:
                        # degeminate base-final N + -ness (givenness)
                        if (tail[0] == re.sub(r"\d", "", base[-1])
                                and tail[0] == "N"):
                            return base + tail[1:]
                        return base + tail
        return None

    def __call__(self, word: str) -> List[str]:
        w = word.lower()
        stripped = w.replace("'", "")
        phones = (self._lookup(w) or self._lookup(stripped)
                  or self._derive(stripped))
        if phones is None:
            phones = self.fallback(stripped)
        if self.strip_stress:
            phones = [re.sub(r"\d", "", p) for p in phones]
        return phones


class _G2pEnBackend(G2PBackend):
    def __init__(self):
        from g2p_en import G2p  # noqa: F401  (optional dependency)
        self._g2p = G2p()

    def __call__(self, word: str) -> List[str]:
        return [re.sub(r"\d", "", p) for p in self._g2p(word)
                if re.match(r"[A-Z]", p)]


def get_g2p(lexicon_path: Optional[str] = None) -> G2PBackend:
    """Pick the best available backend, chained per the module docstring:
    user lexicon -> (g2p_en | builtin lexicon) -> letter-to-sound rules."""
    try:
        oov_backend: G2PBackend = _G2pEnBackend()
    except Exception:
        oov_backend = BuiltinLexiconG2P()
    if lexicon_path and os.path.exists(lexicon_path):
        return LexiconG2P(lexicon_path, fallback=oov_backend)
    return oov_backend


class ARPABET:
    """Sentence-level ARPABET frontend over a fixed 39-phone vocabulary
    (reference arpabet.py:26-211): phoneticize / numericalize / reverse,
    punctuation kept, optional <s>/</s> wrapping.
    """

    punctuations = [",", ".", "?", "!"]

    def __init__(self, lexicon_path: Optional[str] = None):
        from .normalizer import normalize
        from .vocab import Vocab
        self._normalize = normalize
        self.backend = get_g2p(lexicon_path)
        self.vocab = Vocab(ARPABET_PHONES + self.punctuations)

    _WORD = re.compile(r"[a-z']+|[,.?!]")

    def _word_phones(self, word: str) -> List[str]:
        # pass the raw token: contraction entries ("don't") live in the
        # lexicons; backends ignore/strip apostrophes themselves
        return [re.sub(r"\d", "", p) for p in self.backend(word)]

    def phoneticize(self, sentence: str,
                    add_start_end: bool = False) -> List[str]:
        phones: List[str] = []
        for token in self._WORD.findall(self._normalize(sentence)):
            if re.match(r"[a-z']", token):
                phones.extend(self._word_phones(token))
            else:
                phones.append(token)
        if add_start_end:
            phones = ([self.vocab.start_symbol] + phones
                      + [self.vocab.end_symbol])
        return [p for p in phones if p in self.vocab.stoi]

    def numericalize(self, phonemes: List[str]) -> List[int]:
        return [self.vocab.lookup(p) for p in phonemes]

    def reverse(self, ids: List[int]) -> List[str]:
        return [self.vocab.reverse(i) for i in ids]

    def __call__(self, sentence: str,
                 add_start_end: bool = False) -> List[int]:
        return self.numericalize(
            self.phoneticize(sentence, add_start_end=add_start_end))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


class ARPABETWithStress(ARPABET):
    """Stressed variant: vowels carry 0/1/2 stress marks (reference
    arpabet.py:212-302).  Backends that emit no stress (the rule
    fallback, stripped lexicons) default vowels to stress 0."""

    def __init__(self, lexicon_path: Optional[str] = None):
        from .normalizer import normalize
        from .vocab import Vocab
        self._normalize = normalize
        if lexicon_path and os.path.exists(lexicon_path):
            self.backend = LexiconG2P(lexicon_path, strip_stress=False)
        else:
            try:
                from g2p_en import G2p

                class _Stressed(G2PBackend):
                    def __init__(self):
                        self._g2p = G2p()

                    def __call__(self, word):
                        return [p for p in self._g2p(word)
                                if re.match(r"[A-Z]", p)]
                self.backend = _Stressed()
            except Exception:
                self.backend = BuiltinLexiconG2P(strip_stress=False)
        self.vocab = Vocab(ARPABET_STRESS_PHONES + self.punctuations)

    def _word_phones(self, word: str) -> List[str]:
        out = []
        for p in self.backend(word):
            base = re.sub(r"\d", "", p)
            if base in _VOWELS and not re.search(r"\d", p):
                p = base + "0"
            out.append(p)
        return out
